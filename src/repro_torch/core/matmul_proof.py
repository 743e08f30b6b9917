"""Thaler-style sum-check for matrix-multiplication claims (mirrors
``repro.core.matmul_proof``).

Statement: C = A @ B over the integers embedded in Fp, with A: (n, k),
B: (k, m), C: (n, m).  The verifier draws r_i (log n) and r_j (log m);
C~(r_i, r_j) = sum_k A~(r_i, k) B~(k, r_j) is one degree-2 sum-check over
log k variables, which leaves three MLE evaluation claims for the caller
to discharge against its commitments.

A_r and B_c come from the K4 wrappers (``kernels.ops.partial_eval_rows_mm``
and ``partial_eval_cols_mm``) and the sum-check runs through K3
(``core.sumcheck.prove``): the kernels on the card, their plain versions
on the CPU.  The JAX package's ref/fused choice is an environment switch;
the port has one path.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as KOPS

from . import field as F
from . import sumcheck as SC
from .mle import mle_eval_base
from .transcript import Transcript


@dataclasses.dataclass
class EvalClaim:
    tensor: str              # tensor id the claim refers to
    point: np.ndarray        # (m, 4) uint32, flat-index MLE point
    value: np.ndarray        # (4,) uint32


@dataclasses.dataclass
class MatmulProof:
    c_claim: np.ndarray      # (4,) uint32
    sumcheck: SC.SumcheckProof


def _log2(n: int) -> int:
    l = n.bit_length() - 1
    assert 1 << l == n, f"dimension {n} must be a power of two"
    return l


def _c_point(r_i: torch.Tensor, r_j: torch.Tensor) -> torch.Tensor:
    return torch.cat([r_i, r_j]) if r_i.shape[0] + r_j.shape[0] else \
        torch.zeros((0, 4), dtype=F.I64, device=r_i.device)


def prove(a_name: str, A: torch.Tensor, b_name: str, B: torch.Tensor,
          c_name: str, C: torch.Tensor, transcript: Transcript
          ) -> Tuple[MatmulProof, List[EvalClaim]]:
    """A, B, C: Montgomery Fp tensors on the transcript's device."""
    n, k = A.shape
    k2, m = B.shape
    assert k2 == k and tuple(C.shape) == (n, m)
    ln, lk, lm = _log2(n), _log2(k), _log2(m)

    r_i = transcript.challenge_f4_vec(ln)        # row point
    r_j = transcript.challenge_f4_vec(lm)        # col point
    c_point = _c_point(r_i, r_j)
    c_claim = mle_eval_base(C.reshape(-1), c_point)
    transcript.absorb(c_claim)

    A_r = KOPS.partial_eval_rows_mm(A, r_i)      # (k, 4)
    B_c = KOPS.partial_eval_cols_mm(B, r_j)      # (k, 4)
    proof, rho = SC.prove([A_r, B_c], transcript)

    claims = [
        EvalClaim(c_name, F.to_np(c_point), F.to_np(c_claim)),
        EvalClaim(a_name, F.to_np(torch.cat([r_i, rho])),
                  proof.final_evals[0]),
        EvalClaim(b_name, F.to_np(torch.cat([rho, r_j])),
                  proof.final_evals[1]),
    ]
    return MatmulProof(c_claim=F.to_np(c_claim), sumcheck=proof), claims


def verify(proof: MatmulProof, shapes: Tuple[int, int, int],
           names: Tuple[str, str, str], transcript: Transcript
           ) -> Tuple[bool, List[EvalClaim]]:
    n, k, m = shapes
    ln, lk, lm = _log2(n), _log2(k), _log2(m)
    r_i = transcript.challenge_f4_vec(ln)
    r_j = transcript.challenge_f4_vec(lm)
    c_point = _c_point(r_i, r_j)
    c_claim = F.tensor(proof.c_claim, transcript.device)
    transcript.absorb(c_claim)
    ok, rho, finals = SC.verify(c_claim, proof.sumcheck, 2, transcript)
    if not ok or rho.shape[0] != lk:
        return False, []
    a_name, b_name, c_name = names
    claims = [
        EvalClaim(c_name, F.to_np(c_point), F.to_np(c_claim)),
        EvalClaim(a_name, F.to_np(torch.cat([r_i, rho])), F.to_np(finals[0])),
        EvalClaim(b_name, F.to_np(torch.cat([rho, r_j])), F.to_np(finals[1])),
    ]
    return True, claims
