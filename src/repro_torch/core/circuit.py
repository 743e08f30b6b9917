"""Circuit framework: view algebra + proof context + gadgets (mirrors
``repro.core.circuit``).

A layer proof is a deterministic sequence of gadget calls run identically
by prover and verifier over one Fiat-Shamir transcript; the prover writes
values and sub-proofs to a tape the verifier consumes in order.  Every
private witness value lives as 8-bit slices in a few PCS commitments; wider
quantities are Affine views over slices.  Gadgets reduce every statement to
MLE evaluation claims on committed vectors, discharged by one batched PCS
opening per commitment at ``finalize``.

Field values are int64 tensors on the transcript's device; claim points and
values are kept host-side as numpy uint32, the form the tape carries.
"""
from __future__ import annotations

import dataclasses
import functools
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import field as F
from . import lookup as LK
from . import luts as LUTS
from . import pcs as PCS
from . import sumcheck as SC
from .mle import (eq_eval, eq_points, fsum, mle_eval_base,
                  partial_eval_cols, partial_eval_rows)
from .transcript import Transcript

INV2 = (F.P + 1) // 2    # field inverse of 2 as a canonical int

# Analysis hook sites, kept as in the JAX package: an observer watching
# commitment, claim, witness-layout and opening events.  None in production.
_OBSERVER = None


def set_observer(observer) -> None:
    """Install (or with None remove) a circuit event observer."""
    global _OBSERVER
    _OBSERVER = observer


def _notify(event: str, **kw) -> None:
    if _OBSERVER is not None:
        getattr(_OBSERVER, event)(**kw)


@functools.lru_cache(maxsize=None)
def _const_bits_point(idx: int, npfx: int) -> np.ndarray:
    """(npfx, 4) Fp4 point whose rows are the bits of idx, MSB first."""
    out = np.zeros((npfx, 4), np.uint32)
    for j in range(npfx):
        if (idx >> (npfx - 1 - j)) & 1:
            out[j, 0] = F.R_MOD_P
    out.setflags(write=False)
    return out


class ProofError(Exception):
    """Raised by the verifier on any failed check."""


# ---------------------------------------------------------------------------
# View algebra (integer-valued vectors of length 2^log_n, embedded mod p).
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Slice:
    com: str                  # commitment name
    offset: int               # element offset, multiple of 2^log_n
    log_n: int

    def __post_init__(self):
        assert self.offset % (1 << self.log_n) == 0, "unaligned slice"


@dataclasses.dataclass(frozen=True)
class Affine:
    terms: Tuple[Tuple[int, "View"], ...]   # (field-const coef, view)
    const: int = 0                          # field constant added entrywise
    log_n: Optional[int] = None             # required if terms empty


@dataclasses.dataclass(frozen=True)
class BcastCols:
    """Each element of base repeated 2^extra times (base indexes high bits)."""
    base: "View"
    extra: int


@dataclasses.dataclass(frozen=True)
class BcastRows:
    """Base vector tiled 2^extra times (base indexes low bits)."""
    base: "View"
    extra: int


@dataclasses.dataclass(frozen=True)
class Public:
    """A public integer vector known to both sides (masks, positions)."""
    values: tuple
    name: str = ""


@dataclasses.dataclass(frozen=True)
class Concat:
    """Concatenation of equal-sized views (e.g. batched LUT witnesses)."""
    parts: Tuple["View", ...]

    def __post_init__(self):
        n = len(self.parts)
        assert n & (n - 1) == 0, "Concat needs a power-of-two part count"
        sizes = {view_log_n(p) for p in self.parts}
        assert len(sizes) == 1, "Concat parts must be equal-sized"


View = Union[Slice, Affine, BcastCols, BcastRows, Public, Concat]


def view_log_n(v: View) -> int:
    if isinstance(v, Slice):
        return v.log_n
    if isinstance(v, Affine):
        if v.terms:
            return view_log_n(v.terms[0][1])
        return v.log_n
    if isinstance(v, (BcastCols, BcastRows)):
        return view_log_n(v.base) + v.extra
    if isinstance(v, Concat):
        return view_log_n(v.parts[0]) + (len(v.parts).bit_length() - 1)
    if isinstance(v, Public):
        n = len(v.values)
        ln = n.bit_length() - 1
        assert 1 << ln == n
        return ln
    raise TypeError(v)


def scaled(v: View, c: int) -> Affine:
    """c * v, c reduced mod P."""
    return Affine(terms=((c % F.P, v),))


def subslice(sl: Slice, offset_elems: int, log_n: int) -> Slice:
    """A contiguous sub-range of an existing slice (offsets compose)."""
    return Slice(sl.com, sl.offset + offset_elems, log_n)


def vadd(*vs: View) -> Affine:
    """The sum of the views, each with coefficient 1."""
    return Affine(terms=tuple((1, v) for v in vs))


def vaff(terms, const=0) -> Affine:
    return Affine(terms=tuple((c % F.P, v) for c, v in terms), const=const % F.P)


# ---------------------------------------------------------------------------
# Small Fp4 helpers.  A Montgomery constant c times a value x is c*x mod P.
# ---------------------------------------------------------------------------
def _scale(x: torch.Tensor, c: int) -> torch.Tensor:
    """Fp4 (or Fp) value times the integer constant c."""
    return x * (c % F.P) % F.P


_FC_CACHE: Dict[Tuple[int, str], torch.Tensor] = {}


def _fc(c: int, device) -> torch.Tensor:
    """Fp4 constant for the integer c (Montgomery, cached per device)."""
    key = (c % F.P, str(device))
    t = _FC_CACHE.get(key)
    if t is None:
        t = F.f4zero((), device)
        t[0] = F.mont_int(c)
        _FC_CACHE[key] = t
    return t


_HALF_CACHE: Dict[Tuple[int, str], torch.Tensor] = {}


@functools.lru_cache(maxsize=None)
def _half_point_np(m: int) -> np.ndarray:
    """The point (1/2, ..., 1/2) in Fp4 — see g_sum."""
    out = np.zeros((m, 4), np.uint32)
    out[:, 0] = INV2 * F._R % F.P
    out.setflags(write=False)
    return out


def _half_point(m: int, device) -> torch.Tensor:
    key = (m, str(device))
    t = _HALF_CACHE.get(key)
    if t is None:
        t = F.tensor(_half_point_np(m), device)
        _HALF_CACHE[key] = t
    return t


def f4_lincomb(pairs, const: int, device) -> torch.Tensor:
    """sum_i c_i * val_i + const over Fp4 (c_i python ints)."""
    acc = _fc(const, device)
    for c, val in pairs:
        acc = F.f4add(acc, _scale(val, c))
    return acc


# ---------------------------------------------------------------------------
# Shared context machinery.
# ---------------------------------------------------------------------------
class _Ctx:
    """State shared by prover/verifier contexts."""

    def __init__(self, transcript: Transcript, params: PCS.PCSParams):
        self.tr = transcript
        self.device = transcript.device
        self.params = params
        self.claims: "OrderedDict[str, List[Tuple[np.ndarray, np.ndarray]]]" = OrderedDict()
        self.roots: Dict[str, np.ndarray] = {}
        self.shapes: Dict[str, Tuple[int, int]] = {}   # name -> (log_r, log_c)
        self._claim_cache: Dict[Tuple, torch.Tensor] = {}
        self.lookups: List["LookupReq"] = []           # deferred LogUp work

    # -- leaf claims ------------------------------------------------------------
    def _leaf_claim(self, com: str, point_np: np.ndarray) -> torch.Tensor:
        key = (com, point_np.tobytes())
        cached = self._claim_cache.get(key)
        if cached is not None:
            return cached
        value = self._leaf_claim_impl(com, point_np)
        value_np = F.to_np(value)
        _notify("on_leaf_claim", ctx=self, com=com, point=point_np,
                value=value_np)
        self.tr.absorb(value)
        self.claims.setdefault(com, []).append((point_np, value_np))
        self._claim_cache[key] = value
        return value

    def _prefix_point(self, sl: Slice, point_np: np.ndarray) -> np.ndarray:
        """Full-commitment point for a slice claim: const prefix ++ point."""
        npfx = sum(self.shapes[sl.com]) - sl.log_n
        if not npfx:
            return point_np
        pfx = _const_bits_point(sl.offset >> sl.log_n, npfx)
        return np.concatenate([pfx, point_np])

    # -- view claims ------------------------------------------------------------
    def claim(self, v: View, point) -> torch.Tensor:
        """MLE evaluation claim of a view at ``point``, decomposed to leaves."""
        return self._claim(v, F.to_np(point))

    def _claim(self, v: View, point_np: np.ndarray) -> torch.Tensor:
        if isinstance(v, Slice):
            _notify("on_slice_claim", ctx=self, com=v.com,
                    offset=v.offset, log_n=v.log_n)
            return self._leaf_claim(v.com, self._prefix_point(v, point_np))
        if isinstance(v, Affine):
            acc = _fc(v.const, self.device)
            for c, sub in v.terms:
                acc = F.f4add(acc, _scale(self._claim(sub, point_np), c))
            return acc
        if isinstance(v, BcastCols):
            return self._claim(v.base, point_np[:view_log_n(v.base)])
        if isinstance(v, BcastRows):
            return self._claim(v.base, point_np[v.extra:])
        if isinstance(v, Concat):
            b = len(v.parts).bit_length() - 1
            eq = eq_points(F.tensor(point_np[:b], self.device))   # (2^b, 4)
            subs = torch.stack([self._claim(part, point_np[b:])
                                for part in v.parts])
            return fsum(F.f4mul(eq, subs), axis=0)
        if isinstance(v, Public):
            vec = F.f_from_int(np.array(v.values, dtype=np.int64), self.device)
            return mle_eval_base(vec, F.tensor(point_np, self.device))
        raise TypeError(v)

    def check_eq(self, a, b, what: str):
        if not np.array_equal(F.to_np(a), F.to_np(b)):
            raise ProofError(f"relation failed: {what}")

    def challenge_point(self, n: int) -> torch.Tensor:
        return self.tr.challenge_f4_vec(n)


class ProverCtx(_Ctx):
    is_prover = True

    def __init__(self, transcript, params, keep_codewords: bool = True):
        super().__init__(transcript, params)
        self.keep_codewords = keep_codewords   # see PCS.commit
        self.tape: List = []
        self.coms: Dict[str, PCS.Commitment] = {}
        self.ints: Dict[str, np.ndarray] = {}     # committed int values

    # -- commitments ------------------------------------------------------------
    def commit(self, name: str, values: np.ndarray):
        """Commit an integer vector (padded to 2^m) under ``name``."""
        n = len(values)
        total = 1 << max((n - 1).bit_length(), 0) if n > 1 else 1
        vals = np.zeros(total, dtype=np.int64)
        vals[:n] = values
        com = PCS.commit(F.f_from_int(vals, self.device), self.params,
                         keep_codewords=self.keep_codewords)
        self.coms[name] = com
        self.ints[name] = vals
        self._register(name, com, "int")
        self.tape.append(("root", name, com.root))
        self.tr.absorb(com.root)

    def commit_field(self, name: str, fvec: torch.Tensor, aspect: int = 0):
        """Commit a field-valued vector (already Montgomery)."""
        com = PCS.commit(fvec, self.params, aspect, self.keep_codewords)
        self.coms[name] = com
        self._register(name, com, "field")
        self.tape.append(("root", name, com.root))
        self.tr.absorb(com.root)

    def attach(self, name: str, com: PCS.Commitment, ints: np.ndarray):
        """Attach an externally-created commitment (boundary/weights)."""
        self.coms[name] = com
        self.ints[name] = ints
        self._register(name, com, "attach")
        self.tr.absorb(com.root)

    def _register(self, name: str, com: PCS.Commitment, kind: str):
        self.roots[name] = com.root
        self.shapes[name] = (com.log_r, com.log_c)
        _notify("on_commit", ctx=self, name=name, root=com.root,
                log_total=com.log_r + com.log_c, kind=kind)

    def _leaf_claim_impl(self, com: str, point_np: np.ndarray) -> torch.Tensor:
        val = PCS.eval_at_sliced(self.coms[com], point_np)
        self.tape.append(("val", F.to_np(val)))
        return val

    # -- materialization (field vectors for sum-check factors) -----------------
    def materialize(self, v: View) -> torch.Tensor:
        if isinstance(v, Slice):
            # the committed vector IS f_from_int(ints): slice it on the device
            flat = self.coms[v.com].mat.reshape(-1)
            return flat[v.offset:v.offset + (1 << v.log_n)]
        if isinstance(v, Affine):
            n = 1 << view_log_n(v)
            acc = F.fconst(v.const, (n,), self.device)
            for c, sub in v.terms:
                acc = F.fadd(acc, _scale(self.materialize(sub), c))
            return acc
        if isinstance(v, BcastCols):
            return self.materialize(v.base).repeat_interleave(1 << v.extra)
        if isinstance(v, BcastRows):
            return self.materialize(v.base).repeat(1 << v.extra)
        if isinstance(v, Concat):
            return torch.cat([self.materialize(p) for p in v.parts])
        if isinstance(v, Public):
            return F.f_from_int(np.array(v.values, dtype=np.int64), self.device)
        raise TypeError(v)

    def put(self, obj):
        self.tape.append(("obj", obj))
        _notify("on_tape", ctx=self, kind="obj", payload=obj)

    def put_value(self, val: torch.Tensor) -> torch.Tensor:
        val_np = F.to_np(val)
        self.tape.append(("val", val_np))
        _notify("on_tape", ctx=self, kind="val", payload=val_np)
        self.tr.absorb(val)
        return val

    def finalize(self) -> List:
        """Batch-open every commitment at its accumulated claim points."""
        assert not self.lookups, "finalize with pending lookups — call flush_lookups first"
        for name in self.claims:
            points = [p for p, _ in self.claims[name]]
            values = [v for _, v in self.claims[name]]
            bundle = PCS.prove_openings(self.coms[name], points, self.tr,
                                        self.params, values=values)
            self.tape.append(("open", name, bundle))
            _notify("on_open", ctx=self, name=name, n_points=len(points))
        _notify("on_finalize", ctx=self)
        return self.tape


class VerifierCtx(_Ctx):
    is_prover = False

    def __init__(self, transcript, params, tape: List,
                 store: Optional[PCS.ColumnStore] = None):
        super().__init__(transcript, params)
        self.tape = tape
        self.cursor = 0
        self.store = store

    def _next(self, kind: str):
        if self.cursor >= len(self.tape):
            raise ProofError("proof tape exhausted")
        item = self.tape[self.cursor]
        self.cursor += 1
        if item[0] != kind:
            raise ProofError(f"tape mismatch: want {kind}, got {item[0]}")
        return item

    def _expect_root(self, name: str, n_elems: int, aspect: int = 0):
        _, got_name, root = self._next("root")
        if got_name != name:
            raise ProofError(f"commitment order mismatch: {got_name}!={name}")
        self.attach(name, root, n_elems, aspect)

    def commit(self, name: str, n_elems: int):
        self._expect_root(name, n_elems)

    def commit_field(self, name: str, n_elems: int, aspect: int = 0):
        self._expect_root(name, n_elems, aspect)

    def attach(self, name: str, root: np.ndarray, n_elems: int,
               aspect: int = 0):
        total = 1 << max((n_elems - 1).bit_length(), 0) if n_elems > 1 else 1
        self.roots[name] = root
        self.shapes[name] = PCS.shape_for(total, aspect)
        self.tr.absorb(root)

    def _leaf_claim_impl(self, com: str, point_np: np.ndarray) -> torch.Tensor:
        _, val = self._next("val")
        return F.tensor(val, self.device)

    def get(self):
        _, obj = self._next("obj")
        return obj

    def get_value(self) -> torch.Tensor:
        _, val = self._next("val")
        v = F.tensor(val, self.device)
        self.tr.absorb(v)
        return v

    def finalize(self):
        if self.lookups:
            raise ProofError("finalize with pending lookups")
        for name in self.claims:
            _, got_name, bundle = self._next("open")
            if got_name != name:
                raise ProofError(f"opening order mismatch: {got_name}")
            points = [p for p, _ in self.claims[name]]
            values = [v for _, v in self.claims[name]]
            ok = PCS.verify_openings(self.roots[name], *self.shapes[name],
                                     points, values, bundle, self.tr,
                                     self.params, store=self.store)
            if not ok:
                raise ProofError(f"PCS opening failed for {name}")
        if self.cursor != len(self.tape):
            raise ProofError("unconsumed proof material")


Ctx = Union[ProverCtx, VerifierCtx]


# ---------------------------------------------------------------------------
# Gadgets.  Each runs identically on both sides; the prover writes tape values.
# ---------------------------------------------------------------------------
def g_sum(ctx: Ctx, v: View) -> torch.Tensor:
    """S = sum_z v(z) = 2^m v~(1/2, ..., 1/2) — one claim, no sum-check."""
    m = view_log_n(v)
    return _scale(ctx.claim(v, _half_point_np(m)), 1 << m)


def g_dot_eq(ctx: Ctx, views: Sequence[View], r: torch.Tensor,
             total_bits: Optional[int] = None, eq_pos: str = "lead"
             ) -> torch.Tensor:
    """T with proof that T = sum_z EQ(z) * prod_i v_i(z); EQ covers the
    leading ('lead') or trailing ('trail') len(r) index bits."""
    nr = r.shape[0]
    total_bits = nr if total_bits is None else total_bits
    extra = total_bits - nr
    if ctx.is_prover:
        eq = eq_points(r)
        if extra:
            if eq_pos == "lead":
                eq = eq.repeat_interleave(1 << extra, dim=0)
            else:
                eq = eq.repeat(1 << extra, 1)
        mats = [F.f4_from_base(ctx.materialize(v)) for v in views]
        prod = eq
        for m in mats:
            prod = F.f4mul(prod, m)
        t = ctx.put_value(fsum(prod, axis=0))
        proof, rho = SC.prove([eq] + mats, ctx.tr)
        ctx.put(proof)
        finals = F.tensor(proof.final_evals, ctx.device)
    else:
        t = ctx.get_value()
        proof = ctx.get()
        ok, rho, finals = SC.verify(t, proof, 1 + len(views), ctx.tr)
        if not ok:
            raise ProofError("g_dot_eq sumcheck failed")
    rho_eq = rho[:nr] if eq_pos == "lead" else rho[extra:]
    ctx.check_eq(eq_eval(r, rho_eq), finals[0], "g_dot_eq eq factor")
    for i, v in enumerate(views):
        ctx.check_eq(ctx.claim(v, rho), finals[i + 1],
                     f"g_dot_eq factor {i}")
    return t


def g_matmul_term(ctx: Ctx, A: View, B: View, shape: Tuple[int, int, int],
                  r_i: torch.Tensor, r_j: torch.Tensor,
                  a_t: bool = False, b_t: bool = False) -> torch.Tensor:
    """(op(A)@op(B))~(r_i, r_j) with a Thaler sum-check over k; a_t/b_t:
    the view stores the transpose of the operand."""
    n, k, m = shape
    ln, lk, lm = (x.bit_length() - 1 for x in (n, k, m))
    assert (1 << ln, 1 << lk, 1 << lm) == (n, k, m)
    if ctx.is_prover:
        Am = ctx.materialize(A).reshape((k, n) if a_t else (n, k))
        Bm = ctx.materialize(B).reshape((m, k) if b_t else (k, m))
        A_r = partial_eval_cols(Am, r_i) if a_t else partial_eval_rows(Am, r_i)
        B_c = partial_eval_rows(Bm, r_j) if b_t else partial_eval_cols(Bm, r_j)
        t = ctx.put_value(fsum(F.f4mul(A_r, B_c), axis=0))
        proof, rho = SC.prove([A_r, B_c], ctx.tr)
        ctx.put(proof)
        finals = F.tensor(proof.final_evals, ctx.device)
    else:
        t = ctx.get_value()
        proof = ctx.get()
        ok, rho, finals = SC.verify(t, proof, 2, ctx.tr)
        if not ok:
            raise ProofError("g_matmul_term sumcheck failed")
        if rho.shape[0] != lk:
            raise ProofError("g_matmul_term wrong k vars")
    a_pt = torch.cat([rho, r_i]) if a_t else torch.cat([r_i, rho])
    b_pt = torch.cat([r_j, rho]) if b_t else torch.cat([rho, r_j])
    ctx.check_eq(ctx.claim(A, a_pt), finals[0], "matmul A eval")
    ctx.check_eq(ctx.claim(B, b_pt), finals[1], "matmul B eval")
    return t


def g_rowsum(ctx: Ctx, X: View, shape: Tuple[int, int],
             r_i: torch.Tensor) -> torch.Tensor:
    """sum_k X~(r_i, k) — half-point identity over the column vars."""
    n, k = shape
    pt = torch.cat([r_i, _half_point(k.bit_length() - 1, ctx.device)])
    return _scale(ctx.claim(X, pt), k)


def g_colsum(ctx: Ctx, X: View, shape: Tuple[int, int],
             r_j: torch.Tensor) -> torch.Tensor:
    """sum_i X~(i, r_j) — half-point identity over the row vars."""
    n, k = shape
    pt = torch.cat([_half_point(n.bit_length() - 1, ctx.device), r_j])
    return _scale(ctx.claim(X, pt), n)


def g_lin_relation(ctx: Ctx, views_coefs, const: int, what: str,
                   r: Optional[torch.Tensor] = None,
                   log_n: Optional[int] = None):
    """Check sum_i c_i * v_i + const == 0 entrywise, via a random point."""
    if r is None:
        r = ctx.challenge_point(log_n)
    acc = f4_lincomb([(c, ctx.claim(v, r)) for c, v in views_coefs], const,
                     ctx.device)
    ctx.check_eq(acc, F.f4zero((), ctx.device), what)
    return r


def g_hadamard(ctx: Ctx, a: View, b: View, c: View, what: str = "hadamard"):
    """Check c = a * b entrywise (no rounding)."""
    r = ctx.challenge_point(view_log_n(a))
    t = g_dot_eq(ctx, [a, b], r)
    ctx.check_eq(ctx.claim(c, r), t, what)


def g_abs(ctx: Ctx, z: View, a: View, what: str = "abs"):
    """Check a = |z| given a is separately range-bounded >= 0: a^2 == z^2."""
    r = ctx.challenge_point(view_log_n(z))
    t_a = g_dot_eq(ctx, [a, a], r)
    t_z = g_dot_eq(ctx, [z, z], r)
    ctx.check_eq(t_a, t_z, what)


def g_int_matmul(ctx: Ctx, A_hi: View, A_lo: View, B_hi: View, B_lo: View,
                 shape: Tuple[int, int, int],
                 a_t: bool = False, b_t: bool = False):
    """Accumulator MLE for C = A @ B with A = 256*(A_hi-128)+(A_lo-128)+128
    over raw [0, 256) limb slices; one two-factor sum-check over the
    centered affine operands.  Returns (acc~(r_i, r_j), r_i, r_j)."""
    n, k, m = shape
    assert 16384 * k < F.P // 2, "k exceeds limb-accumulator bound"
    ln, lm = n.bit_length() - 1, m.bit_length() - 1
    r_i = ctx.challenge_point(ln)
    r_j = ctx.challenge_point(lm)
    Ac = vaff([(256, A_hi), (1, A_lo)], const=-(128 * 256 + 128))
    Bc = vaff([(256, B_hi), (1, B_lo)], const=-(128 * 256 + 128))
    t_cc = g_matmul_term(ctx, Ac, Bc, shape, r_i, r_j, a_t, b_t)
    if a_t:
        rs = g_colsum(ctx, Ac, (k, n), r_i)
    else:
        rs = g_rowsum(ctx, Ac, (n, k), r_i)
    if b_t:
        cs = g_rowsum(ctx, Bc, (m, k), r_j)
    else:
        cs = g_colsum(ctx, Bc, (k, m), r_j)
    acc = f4_lincomb([(1, t_cc), (128, rs), (128, cs)],
                     (128 * 128 * k) % F.P, ctx.device)
    return acc, r_i, r_j


def g_rescale(ctx: Ctx, acc_val: torch.Tensor, r: torch.Tensor,
              out: View, err: View, shift: int, out_bits: int,
              what: str = "rescale"):
    """Check acc + 2^(shift-1) = 2^shift * out + err at the point r."""
    assert (1 << (shift + out_bits)) + (1 << shift) < F.P // 2, \
        f"rescale bound {shift}+{out_bits}"
    lhs = F.f4add(acc_val, _fc(1 << (shift - 1), ctx.device))
    rhs = f4_lincomb([(1 << shift, ctx.claim(out, r)),
                      (1, ctx.claim(err, r))], 0, ctx.device)
    ctx.check_eq(lhs, rhs, what)


@dataclasses.dataclass(frozen=True)
class LookupReq:
    """A deferred LogUp instance, proved jointly by flush_lookups."""
    kind: str                           # "range8" | "lut"
    table: Optional[str]                # LUT name (pair mode)
    idx: View
    out: Optional[View]
    log_n: int
    what: str
    idx_ints: Optional[np.ndarray] = None    # prover only
    out_ints: Optional[np.ndarray] = None


def g_range8(ctx: Ctx, com_name: str, n_elems: int):
    """Value-mode LogUp: every entry of commitment ``com_name`` in [0, 256)."""
    log_total = sum(ctx.shapes[com_name])
    full = Slice(com_name, 0, log_total)
    ints = None
    if ctx.is_prover:
        ints = ctx.ints[com_name]
        assert ints.min() >= 0 and ints.max() < 256, \
            f"{com_name} has out-of-range entries"
    ctx.lookups.append(LookupReq(
        kind="range8", table=None, idx=full, out=None, log_n=log_total,
        what=f"range8 {com_name}", idx_ints=ints))


# ---------------------------------------------------------------------------
# Witness builder: packs named 8-bit arrays into one commitment's slices.
# ---------------------------------------------------------------------------
class WitnessBuilder:
    """Allocates 8-bit witness slices for one commitment (host-side numpy);
    the layout is a public function of the layer config."""

    def __init__(self, com_name: str):
        self.com_name = com_name
        self.items: "OrderedDict[str, Tuple[int, Optional[np.ndarray]]]" = OrderedDict()
        self.ties: List[Tuple[str, str, int, int]] = []

    def alloc(self, name: str, n: int, values: Optional[np.ndarray] = None
              ) -> str:
        target = 1 << max((n - 1).bit_length(), 0) if n > 1 else 1
        if values is not None:
            values = np.asarray(values, dtype=np.int64).reshape(-1)
            assert len(values) == n, f"slice {name}: {len(values)} != {n}"
            if target != n:
                values = np.concatenate(
                    [values, np.zeros(target - n, np.int64)])
            assert values.min() >= 0 and values.max() < 256, \
                f"slice {name} not 8-bit: [{values.min()}, {values.max()}]"
        assert name not in self.items, f"duplicate slice {name}"
        self.items[name] = (target, values)
        return name

    def alloc_limbs(self, name: str, n: int,
                    x: Optional[np.ndarray] = None) -> "LimbPair":
        """Signed 16-bit array -> (hi, lo) slices; view = 256*hi+lo-32768."""
        hi = lo = None
        if x is not None:
            x = np.asarray(x, dtype=np.int64).reshape(-1)
            assert x.min() >= -(1 << 15) and x.max() < (1 << 15), \
                f"{name} exceeds 16-bit: [{x.min()}, {x.max()}]"
            hi = (x >> 8) + 128
            lo = x & 255
        self.alloc(name + ".hi", n, hi)
        self.alloc(name + ".lo", n, lo)
        return LimbPair(self.com_name, name)

    def alloc_ranged(self, name: str, n: int, bits: int,
                     values: Optional[np.ndarray] = None) -> "RangedValue":
        """Unsigned values in [0, 2^bits) -> exact digit decomposition."""
        if values is not None:
            values = np.asarray(values, dtype=np.int64).reshape(-1)
            assert values.min() >= 0 and values.max() < (1 << bits), \
                f"{name} exceeds {bits} bits: max {values.max()}"
        ndig = (bits + 7) // 8
        rem = bits % 8
        digit_names = []
        for i in range(ndig):
            d = (values >> (8 * i)) & 255 if values is not None else None
            digit_names.append(self.alloc(f"{name}.d{i}", n, d))
        if rem:
            scale = 1 << (8 - rem)
            w = None
            if values is not None:
                w = ((values >> (8 * (ndig - 1))) & 255) * scale
            wname = self.alloc(f"{name}.w", n, w)
            log_n = (n - 1).bit_length() if n > 1 else 0
            self.ties.append((wname, digit_names[-1], scale, log_n))
        return RangedValue(self.com_name, name, ndig)

    def pack(self) -> Tuple[Dict[str, Slice], Optional[np.ndarray], int]:
        """Pack slices (descending size). Returns (slices, values|None, n)."""
        order = sorted(self.items, key=lambda nm: -self.items[nm][0])
        offset = 0
        slices: Dict[str, Slice] = {}
        for nm in order:
            n, _ = self.items[nm]
            log_n = (n - 1).bit_length() if n > 1 else 0
            slices[nm] = Slice(self.com_name, offset, log_n)
            offset += n
        total = 1 << max((offset - 1).bit_length(), 0) if offset > 1 else 1
        packed = None
        if all(v is not None for _, v in self.items.values()):
            packed = np.zeros(total, dtype=np.int64)
            for nm in order:
                n, vals = self.items[nm]
                packed[slices[nm].offset:slices[nm].offset + n] = vals
        self.slices = slices
        return slices, packed, total

    def build(self, ctx) -> Dict[str, Slice]:
        """Pack, commit under this ctx, return the public slice map."""
        slices, packed, total = self.pack()
        if ctx.is_prover:
            assert packed is not None, "prover missing witness values"
            ctx.commit(self.com_name, packed)
        else:
            ctx.commit(self.com_name, total)
        _notify("on_witness_slices", ctx=ctx, com=self.com_name,
                slices=dict(slices))
        return slices

    def run_checks(self, ctx, slices: Dict[str, Slice]):
        """Range-check the whole commitment + digit-tie relations."""
        n_elems = 1 << sum(ctx.shapes[self.com_name])
        g_range8(ctx, self.com_name, n_elems)
        for wname, topname, scale, _ in self.ties:
            w_sl, top_sl = slices[wname], slices[topname]
            g_lin_relation(ctx, [(1, w_sl), (-scale, top_sl)], 0,
                           f"digit tie {wname}", log_n=w_sl.log_n)


@dataclasses.dataclass(frozen=True)
class LimbPair:
    com: str
    name: str

    def view(self, slices: Dict[str, Slice]) -> Affine:
        return vaff([(256, slices[self.name + ".hi"]),
                     (1, slices[self.name + ".lo"])], const=-32768)


@dataclasses.dataclass(frozen=True)
class RangedValue:
    com: str
    name: str
    ndig: int

    def view(self, slices: Dict[str, Slice]) -> Affine:
        return vaff([(1 << (8 * i), slices[f"{self.name}.d{i}"])
                     for i in range(self.ndig)])


def g_lut(ctx: Ctx, table_name: str, idx: View, out: View,
          idx_ints: Optional[np.ndarray], out_ints: Optional[np.ndarray],
          n_elems: int, what: str = "lut"):
    """Pair-mode LogUp: (idx_i, out_i) in {(j, T[j])}; proved in
    flush_lookups."""
    log_n = view_log_n(idx)
    assert view_log_n(out) == log_n, "lut idx/out view size mismatch"
    if ctx.is_prover:
        idx_ints = np.asarray(idx_ints, dtype=np.int64).reshape(-1)
        out_ints = np.asarray(out_ints, dtype=np.int64).reshape(-1)
        assert len(idx_ints) == (1 << log_n) == len(out_ints), \
            f"lut {what}: ints not padded to view size"
    ctx.lookups.append(LookupReq(
        kind="lut", table=table_name, idx=idx, out=out, log_n=log_n,
        what=what, idx_ints=idx_ints, out_ints=out_ints))


def _lookup_w_f4(ctx: ProverCtx, req: LookupReq,
                 beta: Optional[torch.Tensor]) -> torch.Tensor:
    """Prover-side witness fingerprint vector w for one instance."""
    if req.kind == "range8":
        return F.f4_from_base(F.f_from_int(req.idx_ints, ctx.device))
    return LK.combine_pair(F.f_from_int(req.idx_ints, ctx.device),
                           F.f_from_int(req.out_ints, ctx.device), beta)


def _lookup_table_sum(ctx: Ctx, req: LookupReq, counts_info, beta, alpha
                      ) -> torch.Tensor:
    """Verifier-computable S_b = sum_j m_j/(alpha - t_j)."""
    if req.kind == "range8":
        t_vals = F.f4_from_base(F.f_from_int(np.arange(256), ctx.device))
        return LK.table_inverse_sum(t_vals, counts_info, alpha)
    support, counts = counts_info
    table = LUTS.table_q(req.table).astype(np.int64)
    t_vals = LK.combine_pair(F.f_from_int(support, ctx.device),
                             F.f_from_int(table[support], ctx.device), beta)
    return LK.table_inverse_sum(t_vals, counts, alpha)


def flush_lookups(ctx: Ctx, helper_name: str = "lkh", aspect: int = 0):
    """Prove/verify every registered LogUp instance for this context: one
    shared helper commitment holds the inverse columns 1/(alpha - w) of all
    instances (4 Fp4 coefficient planes each) as aligned slices."""
    reqs, ctx.lookups = ctx.lookups, []
    if not reqs:
        return
    dev = ctx.device
    # 1. per-instance beta + multiplicities (absorbed before alpha)
    betas: List[Optional[torch.Tensor]] = []
    infos: List = []
    for req in reqs:
        beta = ctx.tr.challenge_f4() if req.kind == "lut" else None
        betas.append(beta)
        n_i = 1 << req.log_n
        if req.kind == "range8":
            if ctx.is_prover:
                counts = LK.dense_counts(req.idx_ints, 256)
                ctx.put(("m", counts.astype(np.uint32)))
            else:
                obj = ctx.get()
                if not (isinstance(obj, tuple) and len(obj) == 2
                        and obj[0] == "m"):
                    raise ProofError(f"{req.what}: bad multiplicity object")
                try:
                    counts = LK.check_dense_counts(obj[1], 256, n_i)
                except LK.BadMultiplicities as e:
                    raise ProofError(f"{req.what}: {e}") from e
            ctx.tr.absorb(F.f_from_int(counts, dev))
            infos.append(counts)
        else:
            if ctx.is_prover:
                support, counts = LK.sparse_counts(req.idx_ints,
                                                   LUTS.LUT_SIZE)
                ctx.put(("msp", support.astype(np.uint32),
                         counts.astype(np.uint32)))
            else:
                obj = ctx.get()
                if not (isinstance(obj, tuple) and len(obj) == 3
                        and obj[0] == "msp"):
                    raise ProofError(f"{req.what}: bad multiplicity object")
                try:
                    support, counts = LK.check_sparse_counts(
                        obj[1], obj[2], LUTS.LUT_SIZE, n_i)
                except LK.BadMultiplicities as e:
                    raise ProofError(f"{req.what}: {e}") from e
            ctx.tr.absorb(F.f_from_int(support, dev))
            ctx.tr.absorb(F.f_from_int(counts, dev))
            infos.append((support, counts))
    # 2. shared alpha, drawn after every witness root and multiplicity
    alpha = ctx.tr.challenge_f4()
    # 3. helper commitment layout: 4 coefficient planes per instance,
    #    packed descending by size (public function of the layer config)
    items = [(i, k, 1 << reqs[i].log_n)
             for i in range(len(reqs)) for k in range(4)]
    order = sorted(range(len(items)), key=lambda t: -items[t][2])
    offsets: Dict[Tuple[int, int], int] = {}
    off = 0
    for t in order:
        i, k, sz = items[t]
        offsets[(i, k)] = off
        off += sz
    total = 1 << max((off - 1).bit_length(), 0) if off > 1 else 1
    a_vecs: List[Optional[torch.Tensor]] = [None] * len(reqs)
    if ctx.is_prover:
        helper = torch.zeros(total, dtype=F.I64, device=dev)
        for i, req in enumerate(reqs):
            w = _lookup_w_f4(ctx, req, betas[i])
            a = F.f4inv(F.f4sub(alpha, w))                   # (n_i, 4)
            a_vecs[i] = a
            n_i = 1 << req.log_n
            for k in range(4):
                helper[offsets[(i, k)]:offsets[(i, k)] + n_i] = a[:, k]
        ctx.commit_field(helper_name, helper, aspect)
    else:
        ctx.commit_field(helper_name, total, aspect)
    # 4. per-instance sum tie + zerocheck
    for i, req in enumerate(reqs):
        coeffs = [Slice(helper_name, offsets[(i, k)], req.log_n)
                  for k in range(4)]
        hp = _half_point_np(req.log_n)
        a_half = PCS.combine_f4_values([ctx.claim(s, hp) for s in coeffs])
        s_a = _scale(a_half, 1 << req.log_n)
        s_b = _lookup_table_sum(ctx, req, infos[i], betas[i], alpha)
        ctx.check_eq(s_a, s_b, f"{req.what} logup sum")
        r = ctx.challenge_point(req.log_n)
        if ctx.is_prover:
            w = _lookup_w_f4(ctx, req, betas[i])
            proof, rho = SC.prove([eq_points(r), a_vecs[i],
                                   F.f4sub(alpha, w)], ctx.tr)
            ctx.put(proof)
            finals = F.tensor(proof.final_evals, dev)
        else:
            proof = ctx.get()
            ok, rho, finals = SC.verify(_fc(1, dev), proof, 3, ctx.tr)
            if not ok:
                raise ProofError(f"{req.what} zerocheck failed")
            if rho.shape[0] != req.log_n:
                raise ProofError(f"{req.what} zerocheck wrong arity")
        ctx.check_eq(eq_eval(r, rho), finals[0], f"{req.what} eq factor")
        a_rho = PCS.combine_f4_values([ctx.claim(s, rho) for s in coeffs])
        ctx.check_eq(a_rho, finals[1], f"{req.what} inverse column")
        if req.kind == "range8":
            _notify("on_range_tie", ctx=ctx, com=req.idx.com)
        w_rho = ctx.claim(req.idx, rho)
        if req.kind == "lut":
            w_rho = F.f4add(w_rho, F.f4mul(betas[i], ctx.claim(req.out, rho)))
        ctx.check_eq(F.f4sub(alpha, w_rho), finals[2],
                     f"{req.what} witness tie")
