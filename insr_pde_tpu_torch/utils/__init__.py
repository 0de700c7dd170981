"""Checkpoints, metrics and visualization of the port."""
