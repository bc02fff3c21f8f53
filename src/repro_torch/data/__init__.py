"""Data pipelines of the port's trainer."""
