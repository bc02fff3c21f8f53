"""Optimizers of the port's trainer."""
