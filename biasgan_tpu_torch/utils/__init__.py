"""Utilities of the port: network checkpoints."""
