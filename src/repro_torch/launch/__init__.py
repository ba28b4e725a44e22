"""Entry points of the port: single-process training."""
