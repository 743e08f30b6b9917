"""repro_torch — the PyTorch/CUDA port of the NANOZK prover and verifier.

The module layout mirrors ``repro`` one to one (``repro_torch.core.field``
is the counterpart of ``repro.core.field`` and so on).  Field elements are
``torch.int64`` tensors holding BabyBear Montgomery residues in ``[0, P)``;
they become numpy ``uint32`` only at the wire boundary, so attestations are
byte-identical to the JAX package's.

Entry points run on ``cuda`` by default and raise when no card is present;
pass ``device="cpu"`` to run the plain PyTorch versions of the kernels.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
