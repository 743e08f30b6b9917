"""Checkpoints of the port (mirrors ``repro.checkpoint``)."""
