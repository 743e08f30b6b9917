"""Data pipeline of the port (mirrors ``repro.data``)."""
