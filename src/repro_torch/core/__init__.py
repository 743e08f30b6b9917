"""Core proof system of the port (mirrors repro.core)."""
