"""Float model zoo of the port (mirrors ``repro.models``, the attention
decoders)."""
