"""Checkpointing of the port's trainer."""
