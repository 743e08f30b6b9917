"""Multilinear-extension utilities over Fp / Fp4 (mirrors ``repro.core.mle``).

Same global convention: an evaluation point (m, 4) has point[0] on the MOST
significant index bit; a row-major (R, C) matrix flattens with the row bits
high.  Mod-p sums are exact in int64 (each term < P < 2^31), so a plain
``sum`` followed by one reduction gives the JAX halving tree's residue.
"""
from __future__ import annotations

import torch

from . import field as F


def fsum(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Mod-p sum along ``axis`` (Fp or Fp4 arrays; not the coefficient axis)."""
    return x.sum(dim=axis) % F.P


def eq_points(r: torch.Tensor) -> torch.Tensor:
    """eq(r, x) for all x in {0,1}^m -> (..., 2^m, 4); r: (..., m, 4).
    Leading axes batch independent points."""
    lead = r.shape[:-2]
    m = r.shape[-2]
    out = F.f4one(lead + (1,), r.device)
    one = F.f4one((), r.device)
    for j in range(m - 1, -1, -1):
        rj = r[..., j:j + 1, :]
        lo = F.f4mul(out, F.f4sub(one, rj))
        hi = F.f4mul(out, rj)
        out = torch.cat([lo, hi], dim=-2)
    return out


def mle_eval_base(v: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """MLE of base-field vector v (2^m,) at Fp4 point r (m, 4) -> (4,)."""
    return fsum(F.fmul(eq_points(r), v[:, None]), axis=0)


def mle_eval_f4(v: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """MLE of Fp4 vector v (2^m, 4) at point r (m, 4) -> (4,)."""
    return fsum(F.f4mul(eq_points(r), v), axis=0)


def partial_eval_rows(mat: torch.Tensor, r_rows: torch.Tensor) -> torch.Tensor:
    """Base matrix (R, C), bind the row variables to r_rows -> Fp4 (C, 4)."""
    eq = eq_points(r_rows)                               # (R, 4)
    return fsum(F.fmul(eq[:, None, :], mat[:, :, None]), axis=0)


def partial_eval_cols(mat: torch.Tensor, r_cols: torch.Tensor) -> torch.Tensor:
    """Bind the column variables of base matrix (R, C) -> Fp4 (R, 4)."""
    eq = eq_points(r_cols)                               # (C, 4)
    return fsum(F.fmul(eq[None, :, :], mat[:, :, None]), axis=1)


def eq_eval(r: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """eq~(r, rho) = prod_j (r_j rho_j + (1-r_j)(1-rho_j)) over Fp4.
    r may carry leading batch axes: (..., m, 4) -> (..., 4)."""
    one = F.f4one((), r.device)
    terms = F.f4add(F.f4mul(r, rho),
                    F.f4mul(F.f4sub(one, r), F.f4sub(one, rho)))
    return f4prod(terms)


def f4prod(terms: torch.Tensor) -> torch.Tensor:
    """Product over axis -2 of a (..., m, 4) Fp4 array (a halving tree;
    the field product is order-free)."""
    if terms.shape[-2] == 0:
        return F.f4one(terms.shape[:-2], terms.device)
    while terms.shape[-2] > 1:
        h = terms.shape[-2] // 2
        prod = F.f4mul(terms[..., :h, :], terms[..., h:2 * h, :])
        terms = torch.cat([prod, terms[..., 2 * h:, :]], dim=-2) \
            if terms.shape[-2] % 2 else prod
    return terms[..., 0, :]
