"""Mesh-level parallelism of the port (mirrors ``repro.parallel``): the
activation-sharding context the models read and the int8 gradient
collectives, over ``torch.distributed``."""
