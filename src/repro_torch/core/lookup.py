"""LogUp lookup argument (mirrors ``repro.core.lookup``).

sum_i 1/(alpha - w_i) = sum_j m_j/(alpha - t_j), with the multiplicities m
shipped in the clear (dense for the 256-entry range table, sparse
(index, count) pairs for 2^16 LUTs) and the witness side committed by
``circuit.flush_lookups``.  Multiplicities are host-side numpy.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import field as F
from .mle import fsum


class BadMultiplicities(Exception):
    """Raised when a shipped multiplicity table is malformed."""


def combine_pair(idx_f: torch.Tensor, out_f: Optional[torch.Tensor],
                 beta: Optional[torch.Tensor]) -> torch.Tensor:
    """w = idx + beta*out as Fp4 vectors (idx/out are base-field)."""
    w = F.f4_from_base(idx_f)
    if out_f is not None:
        w = F.f4add(w, F.f4mul(beta, F.f4_from_base(out_f)))
    return w


def dense_counts(idx: np.ndarray, table_size: int) -> np.ndarray:
    """Multiplicity vector over a small dense table domain."""
    m = np.bincount(np.asarray(idx, dtype=np.int64), minlength=table_size)
    assert m.shape[0] == table_size, "witness index out of table range"
    return m.astype(np.int64)


def sparse_counts(idx: np.ndarray, table_size: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(support indices, counts) — at most n entries for any table size."""
    m = dense_counts(idx, table_size)
    nz = np.nonzero(m)[0]
    return nz.astype(np.int64), m[nz]


def check_dense_counts(obj, table_size: int, n_max: int) -> np.ndarray:
    """Validate an untrusted dense multiplicity vector."""
    m = np.asarray(obj)
    if (m.ndim != 1 or m.shape[0] != table_size
            or not np.issubdtype(m.dtype, np.integer)):
        raise BadMultiplicities("dense multiplicities: bad shape/dtype")
    m = m.astype(np.int64)
    if m.size and (m.min() < 0 or m.max() > n_max):
        raise BadMultiplicities("dense multiplicities: count out of range")
    return m


def check_sparse_counts(support, counts, table_size: int, n_max: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Validate untrusted sparse multiplicities (sorted, unique, bounded)."""
    s = np.asarray(support)
    c = np.asarray(counts)
    if (s.ndim != 1 or c.ndim != 1 or s.shape != c.shape
            or not np.issubdtype(s.dtype, np.integer)
            or not np.issubdtype(c.dtype, np.integer)):
        raise BadMultiplicities("sparse multiplicities: bad shape/dtype")
    s, c = s.astype(np.int64), c.astype(np.int64)
    if s.shape[0] > n_max:
        raise BadMultiplicities("sparse multiplicities: support too large")
    if s.shape[0]:
        if s.min() < 0 or s.max() >= table_size:
            raise BadMultiplicities("sparse multiplicities: index range")
        if np.any(np.diff(s) <= 0):
            raise BadMultiplicities("sparse multiplicities: not sorted-unique")
        if c.min() < 1 or c.max() > n_max:
            raise BadMultiplicities("sparse multiplicities: count range")
    return s, c


def table_inverse_sum(t_vals: torch.Tensor, counts: np.ndarray,
                      alpha: torch.Tensor) -> torch.Tensor:
    """sum_j m_j / (alpha - t_j) over the support, one batched inversion."""
    if t_vals.shape[0] == 0:
        return F.f4zero((), alpha.device)
    inv = F.f4inv(F.f4sub(alpha, t_vals))                   # (k, 4)
    m_f = F.f_from_int(np.asarray(counts, dtype=np.int64), alpha.device)
    return fsum(F.fmul(inv, m_f[:, None]), axis=0)
