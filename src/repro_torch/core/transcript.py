"""Fiat-Shamir transcript: a duplex Poseidon2 sponge (mirrors
``repro.core.transcript``).

The sponge state is a (16,) int64 tensor on the transcript's device; every
absorb and squeeze is one launch of the K1 kernel there (its plain version
on the CPU).  Challenges are sponge lanes (uniform in [0, P), so no
rejection sampling); query indices reduce the CANONICAL lane value mod n,
as the JAX package does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import poseidon2_kernel as K1

from . import field as F
from . import poseidon2 as P2

# Analysis hook site, kept as in the JAX package: a recorder observing
# every transcript event (repro_torch.analysis.replay).  None in production.
_RECORDER = None


def set_recorder(recorder) -> None:
    """Install (or with None remove) a transcript event recorder."""
    global _RECORDER
    _RECORDER = recorder


class Transcript:
    def __init__(self, domain: str, device=None):
        self.device = resolve_device(device)
        self._state = torch.zeros((P2.WIDTH,), dtype=F.I64, device=self.device)
        if _RECORDER is not None:
            _RECORDER.on_init(self, domain)
        raw = np.frombuffer(domain.encode()[:32].ljust(32, b"\0"), dtype=np.uint8)
        self.absorb(F.f_from_int(raw.astype(np.int64), self.device))

    # -- raw sponge state (used by the fused sum-check kernel) ----------------
    @property
    def state(self) -> torch.Tensor:
        """Current sponge state, shape (16,) int64 Montgomery."""
        return self._state

    def set_state(self, state: torch.Tensor) -> None:
        """Install a sponge state produced by an equivalent absorb/squeeze
        sequence run elsewhere (inside the fused sum-check kernel)."""
        old = self._state
        self._state = state.reshape(P2.WIDTH)
        if _RECORDER is not None:
            _RECORDER.on_set_state(self, F.to_np(old), F.to_np(self._state))

    # -- absorbing --------------------------------------------------------------
    def _as_tensor(self, elems) -> torch.Tensor:
        if isinstance(elems, torch.Tensor):
            return elems.to(self.device)
        return F.tensor(elems, self.device)

    def absorb(self, elems) -> None:
        """Absorb an array (any shape) of Montgomery field elements; its
        length is bound into the capacity (prefix-free)."""
        flat = self._as_tensor(elems).reshape(1, -1)
        if _RECORDER is not None:
            _RECORDER.on_absorb(self, F.to_np(flat))
        n = flat.shape[1]
        self._state = K1.sponge(self._state.reshape(1, P2.WIDTH),
                                flat.contiguous(), n)[0]

    def absorb_each(self, values: torch.Tensor) -> None:
        """Absorb each row of a (k, w) array in turn — k calls of
        ``absorb`` in one sponge launch."""
        k, w = values.shape
        if _RECORDER is not None:
            for row in F.to_np(values):
                _RECORDER.on_absorb(self, row)
        self._state = K1.sponge(self._state.reshape(1, P2.WIDTH),
                                values.reshape(1, k * w).contiguous(), w,
                                nseg=k)[0]

    def absorb_digest(self, digest) -> None:
        self.absorb(digest)

    def absorb_int(self, v: int) -> None:
        self.absorb(F.f_from_int(np.array([v % F.P], np.int64), self.device))

    # -- squeezing ----------------------------------------------------------------
    def _squeeze(self, k: int) -> torch.Tensor:
        old = self._state
        nblocks = -(-k // P2.RATE)
        st, lanes = K1.squeeze(self._state.reshape(1, P2.WIDTH), nblocks)
        self._state = st[0]
        out = lanes[0, :k]
        if _RECORDER is not None:
            _RECORDER.on_squeeze(self, F.to_np(old), F.to_np(self._state),
                                 F.to_np(out))
        return out

    def challenge_f(self) -> torch.Tensor:
        """One Fp challenge (Montgomery scalar)."""
        return self._squeeze(1)[0]

    def challenge_f4(self) -> torch.Tensor:
        """One Fp4 challenge, shape (4,)."""
        return self._squeeze(4)

    def challenge_f4_vec(self, n: int) -> torch.Tensor:
        """n Fp4 challenges, shape (n, 4)."""
        if n == 0:
            return torch.zeros((0, 4), dtype=F.I64, device=self.device)
        return self._squeeze(4 * n).reshape(n, 4)

    # Modulo-bias bound for challenge_indices, as in the JAX package: a
    # squeezed lane is uniform on [0, P), so reducing it mod n leaves each
    # index within total-variation distance n / (4P) of uniform; that term
    # is charged to the soundness budget (chain.soundness_bound,
    # "index_bias").  INDEX_BIAS_PER_CALL is the union bound k n / (4P) of
    # one call, a diagnostic that analysis.fs_lint sums over a prove.
    INDEX_BIAS_PER_CALL = staticmethod(lambda n, k: k * n / (4 * F.P))

    def challenge_indices(self, n: int, k: int) -> np.ndarray:
        """k query indices in [0, n): the canonical lane value mod n."""
        raw = F.f_to_int(self._squeeze(k))
        idx = (raw % n).astype(np.int64)
        if _RECORDER is not None:
            _RECORDER.on_indices(self, n, k, raw, idx)
        return idx
