"""Optimizer and gradient compression of the port (mirrors
``repro.optim``)."""
