"""Commitments to vectors of signed 16-bit words, in plain PyTorch.

A vector is split into 8-bit limbs (hi = (x >> 8) + 128, lo = x & 255),
each limb array padded to a power of two, the arrays packed in descending
size, the whole padded to a power of two and mapped into BabyBear in
Montgomery form (R = 2^32).  The packed vector becomes an R x C matrix;
each row is Reed-Solomon encoded at rate 1/blowup (zero-pad to C * blowup,
radix-2 NTT), each column of the codewords is sponge-hashed with
Poseidon2 (width 16, rate 8, x^7, 8 full and 13 partial rounds, the
column length bound into lane 8), and the column digests form a Merkle
tree of 2-to-1 compressions with feed-forward.  The root is the
commitment.
"""
from __future__ import annotations

import functools
import hashlib
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

P = 15 * 2**27 + 1
MONT_R = 2**32
R_MOD_P = MONT_R % P
R_INV = pow(MONT_R, -1, P)
GENERATOR = 31
WIDTH, RATE, DIGEST = 16, 8, 8
RF, RP = 8, 13
_SEED = b"nanozk-poseidon2-babybear-v1"
I64 = torch.int64


def pow2(n: int) -> int:
    return 1 << max((n - 1).bit_length(), 0) if n > 1 else 1


# ---------------------------------------------------------------------------
# Field (Montgomery form).
# ---------------------------------------------------------------------------
def to_field(x: np.ndarray, device) -> torch.Tensor:
    """Signed integers -> Montgomery residues on ``device``."""
    a = torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)
    return a % P * R_MOD_P % P


def fmul(a, b):
    return (a * b) % P * R_INV % P


def to_words(a: torch.Tensor) -> np.ndarray:
    """Residues as the wire's uint32 words."""
    return a.cpu().numpy().astype(np.uint32)


# ---------------------------------------------------------------------------
# Poseidon2.
# ---------------------------------------------------------------------------
def _derive(n: int, tag: bytes) -> np.ndarray:
    out, ctr = [], 0
    while len(out) < n:
        h = hashlib.sha256(_SEED + tag + ctr.to_bytes(4, "little")).digest()
        for i in range(0, 32, 4):
            v = int.from_bytes(h[i:i + 4], "little")
            if v < 2**31:
                out.append(v % P)
            if len(out) == n:
                break
        ctr += 1
    return np.array(out, dtype=np.int64)


@functools.lru_cache(maxsize=None)
def _constants_np():
    rc_full = _derive(RF * WIDTH, b"rc-full").reshape(RF, WIDTH)
    rc_part = _derive(RP, b"rc-part")
    diag = _derive(WIDTH, b"diag")
    diag[diag == 0] = 1
    m4 = np.array([[5, 7, 1, 3], [4, 6, 1, 1], [1, 3, 5, 7], [1, 1, 4, 6]],
                  dtype=np.int64)
    m_ext = np.kron(np.eye(4, dtype=np.int64) + 1, m4)
    return (rc_full * MONT_R % P, rc_part * MONT_R % P, diag, m_ext)


_CONSTS: Dict[str, tuple] = {}


def _constants(device):
    key = str(device)
    if key not in _CONSTS:
        rcf, rcp, diag, mext = _constants_np()
        _CONSTS[key] = (torch.as_tensor(rcf, device=device),
                        [int(v) for v in rcp],
                        torch.as_tensor(diag, device=device),
                        torch.as_tensor(mext, device=device))
    return _CONSTS[key]


_R_INV6 = pow(R_INV, 6, P)


def _sbox(x):
    x2 = x * x % P
    x4 = x2 * x2 % P
    return x4 * (x2 * x % P) % P * _R_INV6 % P


def _external(s, mext):
    return (s.unsqueeze(-2) * mext).sum(-1) % P


def permute(s: torch.Tensor) -> torch.Tensor:
    """Poseidon2 on (n, 16) Montgomery states."""
    rcf, rcp, diag, mext = _constants(s.device)
    s = _external(s, mext)
    for r in range(RF // 2):
        s = _external(_sbox((s + rcf[r]) % P), mext)
    for r in range(RP):
        s0 = _sbox((s[:, :1] + rcp[r]) % P)
        s = torch.cat([s0, s[:, 1:]], dim=1)
        s = (s * diag + s.sum(1, keepdim=True)) % P
    for r in range(RF // 2, RF):
        s = _external(_sbox((s + rcf[r]) % P), mext)
    return s


def hash_rows(rows: torch.Tensor) -> torch.Tensor:
    """Sponge digest (n, 8) of each row of (n, L): the length tag L goes
    into lane RATE, then RATE-word chunks (zero-padded) are added into the
    rate lanes, one permutation each."""
    n, L = rows.shape
    s = torch.zeros((n, WIDTH), dtype=I64, device=rows.device)
    s[:, RATE] = L % P * MONT_R % P
    pad = (-L) % RATE
    if pad:
        rows = torch.nn.functional.pad(rows, (0, pad))
    for k in range(0, L + pad, RATE):
        s = torch.cat([(s[:, :RATE] + rows[:, k:k + RATE]) % P, s[:, RATE:]],
                      dim=1)
        s = permute(s)
    return s[:, :DIGEST]


def compress(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    out = permute(torch.cat([left, right], dim=1))[:, :DIGEST]
    return (out + left) % P


def merkle_root(leaves: torch.Tensor) -> torch.Tensor:
    """Root (8,) of the tree over the rows of ``leaves``."""
    level = hash_rows(leaves)
    n = level.shape[0]
    if pow2(n) != n:
        level = torch.nn.functional.pad(level, (0, 0, 0, pow2(n) - n))
    while level.shape[0] > 1:
        pairs = level.reshape(-1, 2, DIGEST)
        level = compress(pairs[:, 0].contiguous(), pairs[:, 1].contiguous())
    return level[0]


# ---------------------------------------------------------------------------
# Reed-Solomon encoding.
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _twiddles_np(n: int) -> np.ndarray:
    w = pow(GENERATOR, (P - 1) // n, P)
    tw = np.empty(max(n // 2, 1), dtype=np.int64)
    acc = 1
    for i in range(len(tw)):
        tw[i] = acc * MONT_R % P
        acc = acc * w % P
    return tw


@functools.lru_cache(maxsize=None)
def _bitrev_np(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def ntt_rows(x: torch.Tensor) -> torch.Tensor:
    """Radix-2 decimation-in-time NTT along rows (bit-reversed input)."""
    rows, n = x.shape
    if n == 1:
        return x
    tw = torch.as_tensor(_twiddles_np(n), device=x.device)
    x = x[:, torch.as_tensor(_bitrev_np(n), device=x.device)]
    for s in range(n.bit_length() - 1):
        half = 1 << s
        xe = x.reshape(rows, n // (2 * half), 2, half)
        lo, hi = xe[:, :, 0, :], xe[:, :, 1, :]
        thi = fmul(hi, tw[::n // (2 * half)][:half])
        x = torch.stack([(lo + thi) % P, (lo - thi) % P], dim=2).reshape(rows, n)
    return x


def shape_for(n_elems: int) -> Tuple[int, int]:
    m = max((n_elems - 1).bit_length(), 0) if n_elems > 1 else 0
    log_c = (m + 1) // 2
    return m - log_c, log_c


ROW_CHUNK = 1 << 25        # codeword words encoded per piece


def commit_words(vec: torch.Tensor, blowup: int
                 ) -> Tuple[np.ndarray, torch.Tensor]:
    """(root as uint32 words, codewords (R, C * blowup)) of a Montgomery
    vector whose length is a power of two."""
    log_r, log_c = shape_for(vec.shape[0])
    mat = vec.reshape(1 << log_r, 1 << log_c)
    c = mat.shape[1]
    n = c * blowup
    step = max(1, ROW_CHUNK // n)
    enc = torch.cat([ntt_rows(torch.nn.functional.pad(mat[i:i + step],
                                                      (0, n - c)))
                     for i in range(0, mat.shape[0], step)])
    root = merkle_root(enc.T.contiguous())
    return to_words(root), enc


# ---------------------------------------------------------------------------
# Limb packing: the layouts of a boundary activation and a layer's weights.
# ---------------------------------------------------------------------------
def pack_limbs(arrays: Sequence[Tuple[str, np.ndarray]]) -> np.ndarray:
    """Signed 16-bit arrays, in declaration order, as packed 8-bit limbs:
    every ``name.hi`` and ``name.lo`` slice padded to a power of two,
    slices ordered by descending size (declaration order within a size),
    the total padded to a power of two."""
    slices: List[Tuple[int, np.ndarray]] = []
    for _, x in arrays:
        x = np.asarray(x, dtype=np.int64).reshape(-1)
        for limb in ((x >> 8) + 128, x & 255):
            slices.append((pow2(len(x)), limb))
    order = sorted(range(len(slices)), key=lambda i: -slices[i][0])
    total = pow2(sum(s for s, _ in slices))
    packed = np.zeros(total, dtype=np.int64)
    off = 0
    for i in order:
        size, vals = slices[i]
        packed[off:off + len(vals)] = vals
        off += size
    return packed


def weight_arrays(cfg: Dict, w: Dict[str, np.ndarray]
                  ) -> List[Tuple[str, np.ndarray]]:
    return [(name, w[name]) for name in weight_names(cfg)]


def weight_names(cfg: Dict) -> List[str]:
    names = ["wqT", "wkT", "wvT", "woT", "w1T", "w2T", "g1", "g2"]
    if cfg["family"] == "gpt2":
        return names + ["bq", "bk", "bv", "bo", "b1f", "b2f", "be1", "be2"]
    return names + ["w3T"]


def commit_weights(cfg: Dict, w: Dict[str, np.ndarray], blowup: int, device
                   ) -> Tuple[np.ndarray, torch.Tensor]:
    return commit_words(to_field(pack_limbs(weight_arrays(cfg, w)), device),
                        blowup)


def commit_boundary(h: np.ndarray, blowup: int, device
                    ) -> Tuple[np.ndarray, torch.Tensor]:
    return commit_words(to_field(pack_limbs([("act", h)]), device), blowup)
