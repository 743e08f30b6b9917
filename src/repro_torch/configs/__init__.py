"""Architecture configs of the port (mirrors ``repro.configs``)."""
from .base import ARCHS, SHAPES, ArchBundle, get_arch, input_specs  # noqa: F401
