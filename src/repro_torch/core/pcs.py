"""Ligero/Brakedown-style multilinear polynomial commitment (mirrors
``repro.core.pcs``).

A length-2^m vector becomes an R x C matrix whose rows are Reed-Solomon
encoded (K2 NTT kernel) and whose columns are Merkle-committed (K1).  An
opening at k >= 2 points folds the claims with a transcript challenge into
one sum-check (K3) and ships one row u = eq^T . mat (K4) at its point;
k <= 1 points use the classic row + proximity-row opening.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import modmatmul as K4
from repro_torch.kernels import ntt_kernel as K2

from . import field as F
from . import merkle as M
from . import ntt as N
from . import sumcheck as SC
from .mle import eq_eval, eq_points, fsum, mle_eval_base, partial_eval_rows
from .transcript import Transcript


@dataclasses.dataclass(frozen=True)
class PCSParams:
    blowup: int = 4
    queries: int = 64

    def security_bits(self) -> float:
        rho = 1.0 / self.blowup
        per_query = (1.0 + rho) / 2.0
        return -self.queries * math.log2(per_query)


@dataclasses.dataclass
class Commitment:
    mat: torch.Tensor       # (R, C) base-field message rows
    enc: Optional[torch.Tensor]   # (R, C*blowup) encoded rows; None: not
                                  # kept, encoded again when opened
    tree: M.MerkleTree      # over columns of enc
    log_r: int
    log_c: int

    @property
    def root(self) -> np.ndarray:
        r = self.__dict__.get("_root")
        if r is None:
            r = F.to_np(self.tree.root)
            self.__dict__["_root"] = r
        return r


@dataclasses.dataclass
class OpeningBundle:
    """PCS opening payload (see ``repro.core.pcs.OpeningBundle``)."""
    us: np.ndarray                       # (k or 1, C, 4)
    u_prox: Optional[np.ndarray]         # (C, 4) or None (batched)
    columns: Optional[np.ndarray]        # (t, R) or None (store mode)
    paths: Optional[List[M.MerklePath]]  # None in store mode
    batch_sc: Optional[SC.SumcheckProof] = None


class ColumnStore:
    """Per-root verified column cache for deduplicated (v2) openings."""

    def __init__(self):
        self._cols: Dict[bytes, Dict[int, np.ndarray]] = {}

    def add_root(self, root: np.ndarray, indices: Sequence[int],
                 columns: np.ndarray) -> None:
        d = self._cols.setdefault(np.asarray(root).tobytes(), {})
        for i, col in zip(indices, np.asarray(columns)):
            d[int(i)] = col

    def gather(self, root: np.ndarray, idx: Sequence[int], n_rows: int,
               device=None) -> Optional[torch.Tensor]:
        d = self._cols.get(np.asarray(root).tobytes())
        if d is None:
            return None
        rows = []
        for j in idx:
            col = d.get(int(j))
            if col is None or col.shape != (n_rows,):
                return None
            rows.append(col)
        if not rows:
            return None
        return F.tensor(np.stack(rows).astype(np.uint32),
                        resolve_device(device))


def shape_for(n_elems: int, aspect: int = 0) -> Tuple[int, int]:
    """Matrix shape for an n-element vector (aspect > 0 skews to rows)."""
    m = max((n_elems - 1).bit_length(), 0) if n_elems > 1 else 0
    log_c = max(0, (m + 1) // 2 - aspect)
    log_r = m - log_c
    return log_r, log_c


def _rs_encode(rows: torch.Tensor, blowup: int) -> torch.Tensor:
    """RS-encode rows through the K2 encode entry, which reads the
    unpadded rows (the JAX package pads them, then runs the NTT)."""
    c = rows.shape[-1]
    n = c * blowup
    if n == 1:
        return rows
    out = K2.rs_encode_rows(rows.reshape(-1, c).contiguous(), blowup)
    return out.reshape(*rows.shape[:-1], n)


def _pad_vec(vec: torch.Tensor, total: int) -> torch.Tensor:
    n = vec.shape[0]
    return vec if total == n else torch.nn.functional.pad(vec, (0, total - n))


def commit(vec: torch.Tensor, params: PCSParams, aspect: int = 0,
           keep_codewords: bool = True) -> Commitment:
    """vec: flat base-field Montgomery tensor; zero-padded to 2^m.  With
    ``keep_codewords=False`` the encoded rows are dropped once the tree is
    built (blowup times the message's memory) and encoded again when the
    commitment is opened."""
    log_r, log_c = shape_for(vec.shape[0], aspect)
    mat = _pad_vec(vec, 1 << (log_r + log_c)).reshape(1 << log_r, 1 << log_c)
    enc = _rs_encode(mat, params.blowup)
    tree = M.commit(enc.T.contiguous())            # leaves are columns
    return Commitment(mat=mat, enc=enc if keep_codewords else None, tree=tree,
                      log_r=log_r, log_c=log_c)


def commit_batch(vecs: Sequence[torch.Tensor], params: PCSParams
                 ) -> List[Commitment]:
    """Commit equal-length vectors in one batched NTT + Merkle pass; each
    Commitment is bit-identical to ``commit(vecs[i], params)``."""
    if not vecs:
        return []
    n = vecs[0].shape[0]
    assert all(v.shape[0] == n for v in vecs), "commit_batch needs equal lengths"
    log_r, log_c = shape_for(n)
    total = 1 << (log_r + log_c)
    mats = torch.stack([_pad_vec(v, total).reshape(1 << log_r, 1 << log_c)
                        for v in vecs])                    # (B, R, C)
    enc = _rs_encode(mats, params.blowup)                  # (B, R, C*blowup)
    trees = M.commit_batch(enc.transpose(1, 2).contiguous())
    return [Commitment(mat=mats[i], enc=enc[i], tree=trees[i],
                       log_r=log_r, log_c=log_c) for i in range(len(vecs))]


def eval_at(com: Commitment, point: torch.Tensor) -> torch.Tensor:
    """Prover-side MLE evaluation (4,) at point (log_r + log_c, 4)."""
    u = partial_eval_rows(com.mat, point[:com.log_r])
    return fsum(F.f4mul(u, eq_points(point[com.log_r:])), axis=0)


def _const_prefix_split(point_np: np.ndarray) -> Tuple[int, int]:
    """Longest leading run of exact 0/1 rows: (s, idx), the first s rows
    being the bits of idx (MSB first)."""
    s, idx = 0, 0
    for row in np.asarray(point_np):
        if row[1] or row[2] or row[3]:
            break
        if row[0] == 0:
            bit = 0
        elif row[0] == F.R_MOD_P:
            bit = 1
        else:
            break
        idx = (idx << 1) | bit
        s += 1
    return s, idx


def eval_at_sliced(com: Commitment, point_np: np.ndarray) -> torch.Tensor:
    """``eval_at`` paying only for the slice a const-prefixed point
    addresses (the out-of-slice eq factors are exact zeros)."""
    point_np = np.asarray(point_np)
    dev = com.mat.device
    s, idx = _const_prefix_split(point_np)
    m = com.log_r + com.log_c
    if s == 0 or s > m:
        return eval_at(com, F.tensor(point_np, dev))
    t = m - s
    flat = com.mat.reshape(-1)
    return mle_eval_base(flat[idx << t:(idx << t) + (1 << t)],
                         F.tensor(point_np[s:], dev))


def _gamma_powers(gamma: torch.Tensor, k: int) -> torch.Tensor:
    """(k, 4): gamma^0 .. gamma^(k-1), by repeated squaring of the block."""
    ws = F.f4one((1,), gamma.device)
    step = gamma
    while ws.shape[0] < k:
        ws = torch.cat([ws, F.f4mul(ws, step)])
        step = F.f4mul(step, step)
    return ws[:k]


E_VEC_BATCH = 1 << 22     # eq-table elements _build_e_vec makes at once


def _build_e_vec(n_tot: int, pts_np: Sequence[np.ndarray],
                 gamma: torch.Tensor) -> torch.Tensor:
    """e_vec = sum_i gamma^i eq(pts[i], .), built slice-wise: claims are
    grouped by the slice their const-bit prefix addresses and groups are
    bucketed by suffix length t (one batched eq + scatter per bucket)."""
    dev = gamma.device
    m = n_tot.bit_length() - 1
    k = len(pts_np)
    e_vec = torch.zeros((n_tot, 4), dtype=F.I64, device=dev)
    if k == 0:
        return e_vec
    ws_ext = torch.cat([_gamma_powers(gamma, k),
                        torch.zeros((1, 4), dtype=F.I64, device=dev)])
    groups: Dict[Tuple[int, int], List[int]] = {}
    for i, p in enumerate(pts_np):
        s, idx = _const_prefix_split(p)
        if s > m:                       # fully-constant point: keep 0 vars
            idx >>= s - m
            s = m
        groups.setdefault((m - s, idx), []).append(i)
    buckets: Dict[int, List[Tuple[int, List[int]]]] = {}
    for (t, idx), members in groups.items():
        buckets.setdefault(t, []).append((idx, members))
    for t in sorted(buckets):
        glist = sorted(buckets[t])
        G = len(glist)
        mx = max(len(mem) for _, mem in glist)
        if G * mx << t > E_VEC_BATCH:
            # long slices: one eq table at a time, added in place
            for idx, members in glist:
                seg = e_vec[idx << t:(idx + 1) << t]
                for i in members:
                    tab = eq_points(F.tensor(pts_np[i][m - t:], dev))
                    seg.add_(F.f4mul(ws_ext[i], tab)).remainder_(F.P)
                    del tab
            continue
        sufs = np.zeros((G, mx, t, 4), np.uint32)
        widx = np.full((G, mx), k, np.int64)   # padding -> zero weight row
        los = np.empty((G,), np.int64)
        for g, (idx, members) in enumerate(glist):
            los[g] = idx << t
            for j, i in enumerate(members):
                sufs[g, j] = pts_np[i][m - t:]
                widx[g, j] = i
        tabs = eq_points(F.tensor(sufs, dev))                 # (G, Mx, 2^t, 4)
        ws = ws_ext[torch.as_tensor(widx, device=dev)]        # (G, Mx, 4)
        seg = fsum(F.f4mul(ws[:, :, None, :], tabs), axis=1)  # (G, 2^t, 4)
        rows = (torch.as_tensor(los, device=dev)[:, None]
                + torch.arange(1 << t, device=dev)[None, :]).reshape(-1)
        e_vec[rows] = (e_vec[rows] + seg.reshape(-1, 4)) % F.P
    return e_vec


def _encode_f4_row(u: torch.Tensor, blowup: int) -> torch.Tensor:
    """RS-encode an Fp4 row (C, 4) coefficient-wise -> (C*blowup, 4)."""
    return N.rs_encode(u.T, blowup).T


def _gamma_fold(values: Sequence[torch.Tensor], gamma: torch.Tensor
                ) -> torch.Tensor:
    """sum_i gamma^i * values[i], values (4,) each."""
    vals = torch.stack(list(values))
    return fsum(F.f4mul(_gamma_powers(gamma, vals.shape[0]), vals), axis=0)


def _open_columns(com: Commitment, idx: np.ndarray, blowup: int):
    enc = com.enc if com.enc is not None else _rs_encode(com.mat, blowup)
    cols = enc.T[torch.as_tensor(idx, device=enc.device)]
    return F.to_np(cols), M.batch_open(com.tree, idx)


def prove_openings(com: Commitment, points: Sequence[torch.Tensor],
                   transcript: Transcript, params: PCSParams,
                   values: Optional[Sequence[np.ndarray]] = None
                   ) -> OpeningBundle:
    """Open the commitment at each point (batched when >= 2 points)."""
    if len(points) >= 2:
        return _prove_openings_batched(com, points, transcript, params,
                                       values)
    us = []
    for point in points:
        u = partial_eval_rows(com.mat, F.tensor(point, com.mat.device)[:com.log_r])
        transcript.absorb(u)
        us.append(F.to_np(u))
    rho = transcript.challenge_f4_vec(com.mat.shape[0])      # (R, 4)
    u_prox = fsum(F.fmul(rho[:, None, :], com.mat[:, :, None]), axis=0)
    transcript.absorb(u_prox)
    idx = transcript.challenge_indices(com.mat.shape[1] * params.blowup,
                                       params.queries)
    columns, paths = _open_columns(com, idx, params.blowup)
    return OpeningBundle(
        us=np.stack(us) if us else np.zeros((0, com.mat.shape[1], 4), np.uint32),
        u_prox=F.to_np(u_prox), columns=columns, paths=paths)


def _prove_openings_batched(com: Commitment, points: Sequence[torch.Tensor],
                            transcript: Transcript, params: PCSParams,
                            values: Optional[Sequence[np.ndarray]] = None
                            ) -> OpeningBundle:
    """gamma-fold all claims into one sum-check, open once at its point."""
    dev = com.mat.device
    pts_np = [F.to_np(p) for p in points]
    if values is None:
        vals = torch.stack([eval_at(com, F.tensor(p, dev)) for p in pts_np])
    else:
        assert len(values) == len(points)
        vals = F.tensor(np.stack([np.asarray(v) for v in values]), dev)
    transcript.absorb_each(vals)
    gamma = transcript.challenge_f4()
    # the eq vector first: its eq tables are made while the lifted copy
    # does not exist yet
    e_vec = _build_e_vec(com.mat.numel(), pts_np, gamma)
    m_lift = F.f4_from_base(com.mat.reshape(-1))             # (N, 4)
    sc, pt = SC.prove([m_lift, e_vec], transcript)
    del m_lift, e_vec
    u = K4.partial_eval_rows_mm(com.mat, pt[:com.log_r])     # (C, 4)
    transcript.absorb(u)
    idx = transcript.challenge_indices(com.mat.shape[1] * params.blowup,
                                       params.queries)
    columns, paths = _open_columns(com, idx, params.blowup)
    return OpeningBundle(us=F.to_np(u)[None], u_prox=None,
                         columns=columns, paths=paths, batch_sc=sc)


def _gather_columns(root: np.ndarray, idx: np.ndarray, bundle: OpeningBundle,
                    store: Optional[ColumnStore], n_rows: int,
                    device) -> Optional[torch.Tensor]:
    """Resolve the queried columns from inline paths or a store; in store
    mode the bundle must carry no inline columns or paths."""
    if store is not None:
        if bundle.columns is not None or bundle.paths:
            return None
        return store.gather(root, idx, n_rows, device)
    if (not isinstance(bundle.columns, np.ndarray)
            or bundle.columns.shape != (len(idx), n_rows)
            or bundle.columns.dtype != np.uint32):
        return None
    if bundle.paths is None or len(bundle.paths) != len(idx):
        return None
    for j, path in zip(idx, bundle.paths):
        if path.index != int(j):
            return None
    cols = F.tensor(bundle.columns, device)                  # (t, R)
    if not M.verify_paths_batch(root, cols, bundle.paths):
        return None
    return cols


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(np.array_equal(F.to_np(a), F.to_np(b)))


def verify_openings(root: np.ndarray, log_r: int, log_c: int,
                    points: Sequence[torch.Tensor],
                    claimed_values: Sequence[torch.Tensor],
                    bundle: OpeningBundle, transcript: Transcript,
                    params: PCSParams,
                    store: Optional[ColumnStore] = None) -> bool:
    if not isinstance(bundle, OpeningBundle):
        return False
    if len(points) >= 2:
        return _verify_openings_batched(root, log_r, log_c, points,
                                        claimed_values, bundle, transcript,
                                        params, store)
    dev = transcript.device
    R, C = 1 << log_r, 1 << log_c
    n_cols = C * params.blowup
    if bundle.batch_sc is not None:
        return False
    if (not isinstance(bundle.us, np.ndarray) or bundle.us.ndim != 3
            or bundle.us.shape != (len(points), C, 4)
            or bundle.us.dtype != np.uint32):
        return False
    if (not isinstance(bundle.u_prox, np.ndarray)
            or bundle.u_prox.shape != (C, 4)
            or bundle.u_prox.dtype != np.uint32):
        return False
    enc_us, bs = [], []
    for u_np, point, value in zip(bundle.us, points, claimed_values):
        u = F.tensor(u_np, dev)
        point = F.tensor(point, dev)
        transcript.absorb(u)
        got = fsum(F.f4mul(u, eq_points(point[log_r:])), axis=0)
        if not _same(got, value):
            return False
        bs.append(eq_points(point[:log_r]))                  # (R, 4)
        enc_us.append(_encode_f4_row(u, params.blowup))      # (n_cols, 4)
    rho = transcript.challenge_f4_vec(R)
    u_prox = F.tensor(bundle.u_prox, dev)
    transcript.absorb(u_prox)
    enc_prox = _encode_f4_row(u_prox, params.blowup)
    idx = transcript.challenge_indices(n_cols, params.queries)
    cols = _gather_columns(root, idx, bundle, store, R, dev)
    if cols is None:
        return False
    cols4 = cols[:, :, None]                                 # (t, R, 1)
    sel = torch.as_tensor(idx, device=dev)
    for b, enc_u in zip(bs, enc_us):
        if not _same(fsum(F.fmul(b[None], cols4), axis=1), enc_u[sel]):
            return False
    return _same(fsum(F.fmul(rho[None], cols4), axis=1), enc_prox[sel])


def _verify_openings_batched(root: np.ndarray, log_r: int, log_c: int,
                             points: Sequence[torch.Tensor],
                             claimed_values: Sequence[torch.Tensor],
                             bundle: OpeningBundle, transcript: Transcript,
                             params: PCSParams,
                             store: Optional[ColumnStore]) -> bool:
    dev = transcript.device
    R, C = 1 << log_r, 1 << log_c
    n_cols = C * params.blowup
    if not isinstance(bundle.batch_sc, SC.SumcheckProof):
        return False
    if bundle.u_prox is not None:
        return False
    if (not isinstance(bundle.us, np.ndarray)
            or bundle.us.shape != (1, C, 4)
            or bundle.us.dtype != np.uint32):
        return False
    vals = torch.stack([F.tensor(v, dev) for v in claimed_values])
    transcript.absorb_each(vals)
    gamma = transcript.challenge_f4()
    s = _gamma_fold(list(vals), gamma)
    if bundle.batch_sc.round_polys.shape[:1] != (log_r + log_c,):
        return False
    ok, pt, finals = SC.verify(s, bundle.batch_sc, 2, transcript)
    if not ok:
        return False
    pts = F.tensor(np.stack([F.to_np(p) for p in points]), dev)  # (k, m, 4)
    e_pt = _gamma_fold(list(eq_eval(pts, pt)), gamma)
    if not _same(finals[1], e_pt):
        return False
    u = F.tensor(bundle.us[0], dev)
    transcript.absorb(u)
    if not _same(fsum(F.f4mul(u, eq_points(pt[log_r:])), axis=0), finals[0]):
        return False
    idx = transcript.challenge_indices(n_cols, params.queries)
    cols = _gather_columns(root, idx, bundle, store, R, dev)
    if cols is None:
        return False
    b = eq_points(pt[:log_r])                                # (R, 4)
    enc_u = _encode_f4_row(u, params.blowup)                 # (n_cols, 4)
    lhs = fsum(F.fmul(b[None], cols[:, :, None]), axis=1)    # (t, 4)
    return _same(lhs, enc_u[torch.as_tensor(idx, device=dev)])


def combine_f4_values(values: Sequence[torch.Tensor]) -> torch.Tensor:
    """sum_k x^k * values[k] — recombine per-coefficient claims into Fp4."""
    acc = None
    for k, vk in enumerate(values):
        basis = F.f4zero((), vk.device)
        basis[k] = F.R_MOD_P
        term = F.f4mul(vk, basis)
        acc = term if acc is None else F.f4add(acc, term)
    return acc
