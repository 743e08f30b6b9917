"""Sum-check prover/verifier over Fp4 (mirrors ``repro.core.sumcheck``).

Proves S = sum_{z in {0,1}^m} prod_t P_t(z) for d <= 3 multilinear factors
given as (2^m, 4) evaluation vectors.  Variables bind MSB first and the
point is reported MSB first.  ``prove`` always runs its rounds through the
K3 kernel (``repro_torch.kernels.sumcheck_round``; its plain version on
the CPU), with one host read of the results at the end.

A worker thread that registered with a ``SumcheckRoundBatcher``
(``runtime/engine.py``; the engine installs one for a fleet of more than
one thread) hands its claims to that batcher instead, which stacks the
same-shape claims of concurrent layer proofs into one multi-claim K3 call.
Several engines may prove at once (the gateway's resident service), so
the hook is a tuple of active batchers, replaced under a lock and read
without one; a thread is routed to the batcher it registered with, and a
thread that never registered makes the direct K = 1 call.

Lock order (ranked in repro_torch.analysis.locks): ``_BATCHER_LOCK``,
which guards the batcher registry, is rank 60.  It may be acquired while
engine or scheduler locks (ranks <= 50) are held, and only rank-70 leaves
may be taken while it is held.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import sumcheck_round as K3

from . import field as F
from .transcript import Transcript

_ROUND_BATCHERS: tuple = ()
# created at import: a lock made on first use could be made twice by two
# threads at once
_BATCHER_LOCK = threading.Lock()


def add_round_batcher(batcher) -> None:
    global _ROUND_BATCHERS
    with _BATCHER_LOCK:
        _ROUND_BATCHERS = _ROUND_BATCHERS + (batcher,)


def remove_round_batcher(batcher) -> None:
    global _ROUND_BATCHERS
    with _BATCHER_LOCK:
        _ROUND_BATCHERS = tuple(b for b in _ROUND_BATCHERS
                                if b is not batcher)


def set_round_batcher(batcher) -> None:
    """Replace the active set of batchers wholesale (None: none)."""
    global _ROUND_BATCHERS
    with _BATCHER_LOCK:
        _ROUND_BATCHERS = () if batcher is None else (batcher,)


@dataclasses.dataclass
class SumcheckProof:
    """round_polys stores g_t(1..d) only; g_t(0) = S - g_t(1) is implied."""
    round_polys: np.ndarray   # (m, d, 4) uint32 — g_t evaluated at X=1..d
    final_evals: np.ndarray   # (num_factors, 4) uint32 — P_t(rho)


def prove(factors: Sequence[torch.Tensor], transcript: Transcript
          ) -> Tuple[SumcheckProof, torch.Tensor]:
    """factors: (2^m, 4) Fp4 arrays.  Returns (proof, point (m, 4)).  The
    claimed sum must already have been absorbed by the caller."""
    n = factors[0].shape[0]
    assert all(tuple(f.shape) == (n, 4) for f in factors)
    m = n.bit_length() - 1
    assert 1 << m == n, "factor length must be a power of two"
    d = len(factors)
    if m == 0:
        final_evals = torch.stack([f[0] for f in factors])
        transcript.absorb(final_evals)
        return SumcheckProof(round_polys=np.zeros((0, d, 4), np.uint32),
                             final_evals=F.to_np(final_evals)), \
            torch.zeros((0, 4), dtype=F.I64, device=factors[0].device)
    for batcher in _ROUND_BATCHERS:
        if batcher.registered():
            return batcher.prove(tuple(factors), transcript)
    rp, pts, finals, states = K3.prove_rounds(
        [f.unsqueeze(0).contiguous() for f in factors],
        transcript.state.reshape(1, -1))
    transcript.set_state(states[0])
    return SumcheckProof(round_polys=F.to_np(rp[0, :, 1:]),
                         final_evals=F.to_np(finals[0])), pts[0]


def _lagrange_eval(g: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Evaluate the degree-d poly given by its values at X=0..d, at c."""
    dp1 = g.shape[0]
    acc = None
    for i in range(dp1):
        w = 1
        for j in range(dp1):
            if j != i:
                w = (w * (i - j)) % F.P
        w_inv = F.fconst(pow(w, F.P - 2, F.P), (), c.device)
        num = None
        for j in range(dp1):
            if j != i:
                cj = F.f4sub(c, F.f4_from_base(F.fconst(j, (), c.device)))
                num = cj if num is None else F.f4mul(num, cj)
        term = F.f4mul(F.f4mul(num, F.f4_from_base(w_inv)), g[i])
        acc = term if acc is None else F.f4add(acc, term)
    return acc


def verify(claimed_sum, proof: SumcheckProof, num_factors: int,
           transcript: Transcript):
    """Returns (ok, point (m, 4), final_evals (d, 4)); the caller validates
    each final factor evaluation separately."""
    if (not isinstance(proof.round_polys, np.ndarray)
            or proof.round_polys.ndim != 3
            or proof.round_polys.dtype != np.uint32):
        return False, None, None
    dev = transcript.device
    m = proof.round_polys.shape[0]
    d = num_factors
    running = F.tensor(claimed_sum, dev)
    challenges = []
    for t in range(m):
        g_tail = F.tensor(proof.round_polys[t], dev)
        if tuple(g_tail.shape) != (d, 4):
            return False, None, None
        g0 = F.f4sub(running, g_tail[0])
        g = torch.cat([g0[None, :], g_tail], dim=0)
        transcript.absorb(g)
        c = transcript.challenge_f4()
        challenges.append(c)
        running = _lagrange_eval(g, c)
    final_evals = F.tensor(proof.final_evals, dev)
    transcript.absorb(final_evals)
    prod = final_evals[0]
    for i in range(1, final_evals.shape[0]):
        prod = F.f4mul(prod, final_evals[i])
    if not np.array_equal(F.to_np(prod), F.to_np(running)):
        return False, None, None
    point = torch.stack(challenges) if m else \
        torch.zeros((0, 4), dtype=F.I64, device=dev)
    return True, point, final_evals
