"""Poseidon2 permutation/sponge over BabyBear (width 16, x^7, RF=8, RP=13).

Counterpart of ``repro.core.poseidon2``: the round constants and the
internal diagonal are derived by the same SHA-256 counter mode, so digests
are bit-identical.  The permutation itself runs through the K1 kernel
(``repro_torch.kernels.poseidon2_kernel``) on a CUDA tensor and through its
plain PyTorch version on a CPU tensor.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from . import field as F

WIDTH = 16
RATE = 8
DIGEST = 8
RF = 8              # external (full) rounds, split 4 + 4
RP = 13             # internal (partial) rounds

_SEED = b"nanozk-poseidon2-babybear-v1"


def _derive_constants(n: int, tag: bytes) -> np.ndarray:
    out = []
    ctr = 0
    while len(out) < n:
        h = hashlib.sha256(_SEED + tag + ctr.to_bytes(4, "little")).digest()
        for i in range(0, 32, 4):
            v = int.from_bytes(h[i:i + 4], "little")
            if v < 2**31:                     # light rejection to trim bias
                out.append(v % F.P)
            if len(out) == n:
                break
        ctr += 1
    return np.array(out, dtype=np.int64)


# Round constants: full rounds get WIDTH constants each, partial rounds 1.
RC_FULL = _derive_constants(RF * WIDTH, b"rc-full").reshape(RF, WIDTH)
RC_PART = _derive_constants(RP, b"rc-part")
# Internal diagonal d_i (nonzero; J + diag(d) invertible).
DIAG = _derive_constants(WIDTH, b"diag")
DIAG[DIAG == 0] = 1
assert (1 + sum(pow(int(d), F.P - 2, F.P) for d in DIAG)) % F.P != 0

# Montgomery words of the round constants (what the kernels add).
RC_FULL_M = RC_FULL * F._R % F.P
RC_PART_M = RC_PART * F._R % F.P
DIAG_M = DIAG * F._R % F.P

# Poseidon2 external 4x4 block.
M4 = np.array([[5, 7, 1, 3],
               [4, 6, 1, 1],
               [1, 3, 5, 7],
               [1, 1, 4, 6]], dtype=np.int64)
# The whole external layer as one 16x16 integer matrix: M4 on each 4-lane
# block plus the per-position sum over blocks, i.e. (I4 + J4) (x) M4.
# A Montgomery word times a small public integer is an integer product.
M_EXT = np.kron(np.eye(4, dtype=np.int64) + 1, M4)


def permute(state: torch.Tensor) -> torch.Tensor:
    """Poseidon2 on (..., 16) Montgomery states."""
    from repro_torch.kernels import poseidon2_kernel as K1
    shape = state.shape
    return K1.permute_batch(state.reshape(-1, WIDTH).contiguous()
                            ).reshape(shape)


def hash_elems(elems: torch.Tensor) -> torch.Tensor:
    """Sponge-hash along the trailing axis -> (..., DIGEST) digests, with
    the unpadded length bound into the capacity lane."""
    from repro_torch.kernels import poseidon2_kernel as K1
    return K1.hash_rows(elems)


def compress(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """2-to-1 compression with Davies-Meyer feedforward."""
    from repro_torch.kernels import poseidon2_kernel as K1
    return K1.compress_pairs(left, right)
