"""BabyBear prime field arithmetic on int64 tensors (Montgomery form).

Counterpart of ``repro.core.field``.  Elements are ``torch.int64`` tensors
holding Montgomery residues ``a = x * R mod P`` in ``[0, P)`` with
``R = 2**32``, exactly the words the JAX package keeps in uint32 and the wire
packs.  PyTorch has no uint32 ``+``/``>>``/``>=``, and int64 holds every
product of two residues (< 2^62), so the Montgomery product is computed
directly as ``(a * b mod P) * R^-1 mod P`` — the same residue the JAX limb
reduction produces.  Residues become numpy uint32 only at the wire boundary
(``to_np``).

Fp4 = Fp[x]/(x^4 - W4) arrays carry a trailing axis of 4.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

P = 15 * 2**27 + 1  # 2013265921, "BabyBear"
TWO_ADICITY = 27
_R = 2**32
R_MOD_P = _R % P
R_INV = pow(_R, -1, P)
GENERATOR = 31
W4 = 11
assert pow(W4, (P - 1) // 2, P) != 1, "W4 must be a quadratic non-residue"

I64 = torch.int64


# ---------------------------------------------------------------------------
# Host <-> tensor boundary.
# ---------------------------------------------------------------------------
def tensor(x, device) -> torch.Tensor:
    """Montgomery words (numpy uint32 / ints / tensor) -> int64 tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=I64)
    return torch.as_tensor(np.asarray(x).astype(np.int64), device=device)


def to_np(a) -> np.ndarray:
    """int64 residue tensor (or array) -> numpy uint32 (the wire form), in
    C order as a JAX array's host copy is (a transposed view would give a
    Fortran-ordered array, which pickles apart from the JAX package's)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a).astype(np.uint32, order="C")


# ---------------------------------------------------------------------------
# Fp.
# ---------------------------------------------------------------------------
def fmul(a, b):
    """Montgomery product a*b*R^-1 mod P (both operands Montgomery)."""
    return (a * b) % P * R_INV % P


def fadd(a, b):
    return (a + b) % P


def fsub(a, b):
    return (a - b) % P


def fneg(a):
    return (-a) % P


def fpow(a: torch.Tensor, e: int) -> torch.Tensor:
    """a**e for a Python int exponent (square-and-multiply)."""
    result = torch.full_like(a, R_MOD_P)
    base = a
    while e > 0:
        if e & 1:
            result = fmul(result, base)
        base = fmul(base, base)
        e >>= 1
    return result


def finv(a: torch.Tensor) -> torch.Tensor:
    """Fermat inverse a^(P-2); the inverse of 0 is 0."""
    return fpow(a, P - 2)


def to_mont(x: torch.Tensor) -> torch.Tensor:
    """Standard-form values (< P) -> Montgomery form."""
    return x.to(I64) * R_MOD_P % P


def from_mont(a: torch.Tensor) -> torch.Tensor:
    """Montgomery form -> standard form in [0, P)."""
    return a * R_INV % P


def f_from_int(x, device) -> torch.Tensor:
    """Signed integers (numpy / ints) -> Montgomery Fp tensor on ``device``.
    The encoding runs on the host, so one copy moves the result."""
    arr = np.asarray(x, dtype=np.int64) % P
    return torch.as_tensor(arr * R_MOD_P % P, device=device)


def f_to_int(a: torch.Tensor) -> np.ndarray:
    """Montgomery tensor -> numpy int64 canonical values."""
    return from_mont(a).cpu().numpy().astype(np.int64)


def mont_int(v: int) -> int:
    """Montgomery word of the Python int v."""
    return (v % P) * _R % P


def fconst(v: int, shape, device) -> torch.Tensor:
    if isinstance(shape, int):
        shape = (shape,)
    return torch.full(tuple(shape), mont_int(v), dtype=I64, device=device)


# ---------------------------------------------------------------------------
# Fp4.
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _f4_fold_np() -> np.ndarray:
    """(16, 4) map from the outer product a_i b_j (flat i*4+j) to the
    coefficients of x^k: x^(i+j) = x^k, or W4 x^k when i+j = k+4."""
    m = np.zeros((16, 4), np.int64)
    for i in range(4):
        for j in range(4):
            k = i + j
            if k < 4:
                m[i * 4 + j, k] = 1
            else:
                m[i * 4 + j, k - 4] = W4
    return m


_FOLD_CACHE: dict = {}


def _f4_fold(device) -> torch.Tensor:
    key = str(device)
    t = _FOLD_CACHE.get(key)
    if t is None:
        t = torch.as_tensor(_f4_fold_np(), device=device)
        _FOLD_CACHE[key] = t
    return t


F4_CHUNK = 1 << 19     # Fp4 elements per piece of a product


def f4mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fp4 product.  Every Montgomery product is (a_i b_j mod P) R^-1, so the
    sum over the outer product is reduced once and scaled by R^-1 once:
    sums stay < 16 * 11 * P < 2^39.  The outer product takes 80 words an
    element, so a product of more than F4_CHUNK elements goes in pieces,
    each read from the broadcast operands' views (never copied whole)."""
    a, b = torch.broadcast_tensors(a, b)
    if a.numel() <= 4 * F4_CHUNK:
        return _f4mul(a, b)
    out = torch.empty(a.shape, dtype=I64, device=a.device)
    _f4mul_pieces(out, a, b)
    return out


def _f4mul_pieces(out: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> None:
    """out = a b in pieces along axis 0, taking each index of it apart when
    one index alone holds more than F4_CHUNK elements."""
    row = out[0].numel()
    if row > 4 * F4_CHUNK:
        for o, x, y in zip(out, a, b):
            _f4mul_pieces(o, x, y)
        return
    step = 4 * F4_CHUNK // row
    for i in range(0, out.shape[0], step):
        out[i:i + step] = _f4mul(a[i:i + step], b[i:i + step])


def _f4mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    t = a.unsqueeze(-1) * b.unsqueeze(-2) % P            # (..., 4, 4)
    t = t.reshape(*t.shape[:-2], 16, 1)
    c = (t * _f4_fold(a.device)).sum(-2)                 # (..., 4)
    return c % P * R_INV % P


def f4_from_base(a: torch.Tensor) -> torch.Tensor:
    """Embed Fp -> Fp4 (constant coefficient)."""
    return torch.nn.functional.pad(a.unsqueeze(-1), (0, 3))


def f4add(a, b):
    return fadd(a, b)


def f4sub(a, b):
    return fsub(a, b)


def f4mul_base(a4: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fp4 array times base-field array (broadcast over the coefficients)."""
    return fmul(a4, b.unsqueeze(-1))


def f4one(shape, device) -> torch.Tensor:
    out = torch.zeros(tuple(shape) + (4,), dtype=I64, device=device)
    out[..., 0] = R_MOD_P
    return out


def f4zero(shape, device) -> torch.Tensor:
    return torch.zeros(tuple(shape) + (4,), dtype=I64, device=device)


@functools.lru_cache(maxsize=None)
def _frobenius_twists() -> tuple:
    """Montgomery words gamma_j[i] = W4^{i (p^j - 1)/4} for j = 1, 2, 3."""
    out = []
    for j in (1, 2, 3):
        tw = [pow(W4, (i * (P**j - 1) // 4) % (P - 1), P) for i in range(4)]
        out.append(tuple(t * _R % P for t in tw))
    return tuple(out)


def f4inv(a: torch.Tensor) -> torch.Tensor:
    """Inverse in Fp4 via the norm map: a^-1 = conj / N(a), N(a) in Fp."""
    conj = f4one(a.shape[:-1], a.device)
    for twm in _frobenius_twists():
        aj = fmul(a, torch.tensor(twm, dtype=I64, device=a.device))
        conj = f4mul(conj, aj)
    n = f4mul(a, conj)
    return f4mul_base(conj, finv(n[..., 0]))


# ---------------------------------------------------------------------------
# Static-analysis metadata, consumed by ``repro_torch.analysis.ranges``.
# ---------------------------------------------------------------------------
# Declared input bounds per primitive: name -> dict(fn, args, out), the
# JAX package's table less its uint32 limb multiply, which the port does
# not have.  args: (kind, shape) pairs, kind "fp" = Montgomery residue in
# [0, P); out "fp": every output must provably stay in [0, P).  ranges.py
# traces each fn to an aten graph and proves that no int64 intermediate can
# overflow — the "< 2^62" and "< 2^39" comments above as checked facts.
ANALYSIS_BOUNDS = {
    "fmul": dict(fn=lambda a, b: fmul(a, b),
                 args=(("fp", (8,)), ("fp", (8,))), out="fp"),
    "fadd": dict(fn=lambda a, b: fadd(a, b),
                 args=(("fp", (8,)), ("fp", (8,))), out="fp"),
    "fsub": dict(fn=lambda a, b: fsub(a, b),
                 args=(("fp", (8,)), ("fp", (8,))), out="fp"),
    "fneg": dict(fn=lambda a: fneg(a), args=(("fp", (8,)),), out="fp"),
    "finv": dict(fn=lambda a: finv(a), args=(("fp", (8,)),), out="fp"),
    "to_mont": dict(fn=lambda x: to_mont(x), args=(("fp", (8,)),), out="fp"),
    "from_mont": dict(fn=lambda a: from_mont(a),
                      args=(("fp", (8,)),), out="fp"),
    "f4_from_base": dict(fn=lambda a: f4_from_base(a),
                         args=(("fp", (8,)),), out="fp"),
    "f4mul": dict(fn=lambda a, b: f4mul(a, b),
                  args=(("fp", (8, 4)), ("fp", (8, 4))), out="fp"),
    "f4inv": dict(fn=lambda a: f4inv(a), args=(("fp", (8, 4)),), out="fp"),
}
