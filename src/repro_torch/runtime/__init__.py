"""Prover runtime of the port (mirrors repro.runtime, thread backend)."""
