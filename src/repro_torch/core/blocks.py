"""Per-layer transformer block circuits (mirrors ``repro.core.blocks``).

Two families cover the evaluation models:
* 'gpt2'  — LayerNorm, learned positions (no RoPE), GELU MLP, QKV biases.
* 'llama' — RMSNorm, RoPE, GQA, SiLU gate MLP, no biases (TinyLLaMA et al).

``block_forward`` is the quantized forward on int64 tensors (qops) that
records the full witness trace; ``block_argument`` is the deterministic
gadget sequence run by prover and verifier.  Layouts are public functions
of the config.  Activations are feature-major (d_pad, seq).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import circuit as C
from . import field as Fld
from . import qops as Q


def _pad2(n: int) -> int:
    return 1 << max((n - 1).bit_length(), 0) if n > 1 else 1


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    family: str                  # 'gpt2' | 'llama'
    d: int
    dff: int
    heads: int
    kv_heads: int
    dh: int
    seq: int

    def __post_init__(self):
        assert self.family in ("gpt2", "llama")
        assert self.seq & (self.seq - 1) == 0, "seq must be a power of two"
        assert self.dh & (self.dh - 1) == 0, "dh must be a power of two"
        assert self.heads % self.kv_heads == 0

    @classmethod
    def from_fields(cls, **fields) -> "BlockCfg":
        """Build from ``dataclasses.asdict`` of a JAX-package config."""
        return cls(**fields)

    @property
    def d_pad(self) -> int:
        return _pad2(self.d)

    @property
    def qd_pad(self) -> int:
        return _pad2(self.heads * self.dh)

    @property
    def kvd_pad(self) -> int:
        return _pad2(self.kv_heads * self.dh)

    @property
    def dff_pad(self) -> int:
        return _pad2(self.dff)

    @property
    def ln_kind(self) -> str:
        return "layernorm" if self.family == "gpt2" else "rmsnorm"

    @property
    def act(self) -> str:
        return "gelu" if self.family == "gpt2" else "silu"

    @property
    def has_bias(self) -> bool:
        return self.family == "gpt2"

    @property
    def causal_mask(self) -> np.ndarray:
        return np.tril(np.ones((self.seq, self.seq), dtype=np.int64))


# ---------------------------------------------------------------------------
# Weights: quantized int16 f8, stored transposed (d_out, d_in), padded.
# ---------------------------------------------------------------------------
WEIGHT_NAMES_LLAMA = ["wqT", "wkT", "wvT", "woT", "w1T", "w3T", "w2T",
                      "g1", "g2"]


def weight_shapes(cfg: BlockCfg) -> Dict[str, Tuple[int, ...]]:
    d, kv, ff = cfg.d_pad, cfg.kvd_pad, cfg.dff_pad
    qd = cfg.qd_pad
    shapes = {
        "wqT": (qd, d), "wkT": (kv, d), "wvT": (kv, d), "woT": (d, qd),
        "w1T": (ff, d), "w2T": (d, ff), "g1": (d,), "g2": (d,),
    }
    if cfg.family == "gpt2":
        shapes.update({"bq": (qd,), "bk": (kv,), "bv": (kv,), "bo": (d,),
                       "b1f": (ff,), "b2f": (d,), "be1": (d,), "be2": (d,)})
    else:
        shapes["w3T"] = (ff, d)
    return shapes


def init_weights(cfg: BlockCfg, rng: np.random.Generator,
                 scale: float = 0.6) -> Dict[str, np.ndarray]:
    """Random quantized weights with norms that keep every activation in
    the circuit's provable ranges (numpy; the same draws as the JAX
    package's ``init_weights`` from the same generator)."""
    w = {}
    for name, shp in weight_shapes(cfg).items():
        if name.startswith("w"):
            fan_in = cfg.d if name != "w2T" else cfg.dff
            arr = rng.normal(0.0, scale / math.sqrt(fan_in), shp)
        elif name.startswith("g"):
            arr = np.ones(shp) + rng.normal(0, 0.02, shp)
        else:
            arr = rng.normal(0, 0.02, shp)
        q = np.clip(np.round(arr * (1 << Q.F8)), -(1 << 15), (1 << 15) - 1)
        q = q.astype(np.int64)
        # zero the padded tails so padded lanes stay inert
        if name == "wqT":
            q[cfg.heads * cfg.dh:, :] = 0
            q[:, cfg.d:] = 0
        if name == "woT":
            q[cfg.d:, :] = 0
            q[:, cfg.heads * cfg.dh:] = 0
        if name in ("wkT", "wvT"):
            q[cfg.kv_heads * cfg.dh:, :] = 0
            q[:, cfg.d:] = 0
        if name in ("w1T", "w3T"):
            q[cfg.dff:, :] = 0
            q[:, cfg.d:] = 0
        if name == "w2T":
            q[cfg.d:, :] = 0
            q[:, cfg.dff:] = 0
        if q.ndim == 1:
            real = {"bq": cfg.heads * cfg.dh, "bo": cfg.d, "b2f": cfg.d,
                    "be1": cfg.d, "be2": cfg.d, "g1": cfg.d, "g2": cfg.d,
                    "bk": cfg.kv_heads * cfg.dh, "bv": cfg.kv_heads * cfg.dh,
                    "b1f": cfg.dff}.get(name, len(q))
            q[real:] = 0
        w[name] = q
    return w


def weights_from_numpy(cfg: BlockCfg, w: Dict[str, np.ndarray], device
                       ) -> Dict[str, torch.Tensor]:
    """Move a numpy weight dict (``init_weights`` of either package) onto
    ``device`` as int64 tensors, checking every shape."""
    shapes = weight_shapes(cfg)
    if set(w) != set(shapes):
        raise ValueError(f"weight names {sorted(w)} != {sorted(shapes)}")
    out = {}
    for name, shp in shapes.items():
        a = np.asarray(w[name], dtype=np.int64)
        if a.shape != shp:
            raise ValueError(f"{name}: shape {a.shape} != {shp}")
        out[name] = torch.as_tensor(a, device=device)
    return out


# ---------------------------------------------------------------------------
# Quantized forward pass: returns output + full witness trace.
# ---------------------------------------------------------------------------
def _ln_mean(cfg: BlockCfg, x: torch.Tensor, tag: str,
             tr: Dict[str, torch.Tensor]) -> None:
    """LayerNorm's mean part: mu and the masked xc (padded rows zeroed)."""
    d_real = cfg.d
    s1 = x.sum(dim=0)
    mu = (s1 + d_real // 2) // d_real
    tr[f"{tag}.mu"] = Q.assert16(mu, f"{tag} mu")
    tr[f"{tag}.e1"] = s1 + d_real // 2 - d_real * mu
    xc = x - mu[None, :]
    xc[d_real:, :] = 0
    tr[f"{tag}.xc"] = xc


def _norm(cfg: BlockCfg, x: torch.Tensor, g: torch.Tensor,
          b: Optional[torch.Tensor], tag: str, tr: Dict[str, torch.Tensor]
          ) -> torch.Tensor:
    """LayerNorm (gpt2) or RMSNorm (llama: xc = x, no bias)."""
    if cfg.ln_kind == "layernorm":
        _ln_mean(cfg, x, tag, tr)
    else:
        tr[f"{tag}.xc"] = x
    return _ln_recompute(cfg, g, b, tag, tr)


def _ln_recompute(cfg: BlockCfg, g: torch.Tensor, b: Optional[torch.Tensor],
                  tag: str, tr: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean square, rsqrt LUT and scale of tr[tag.xc] (both norms)."""
    d_real = cfg.d
    xc = tr[f"{tag}.xc"]
    sq = (xc * xc).sum(dim=0)
    D = d_real << 4
    ms = (sq + D // 2) // D
    tr[f"{tag}.e2"] = sq + D // 2 - D * ms
    lo, hi = int(ms.min().item()), int(ms.max().item())
    assert lo >= 0 and hi < (1 << 16), "ln ms out of domain"
    tr[f"{tag}.ms"] = ms
    rst, _ = Q.lut_apply("rsqrt", ms)
    tr[f"{tag}.rst"] = rst
    xn_acc = xc * rst[None, :]
    xn = Q.assert16(Q.rshift_round(xn_acc, 11), "ln xn")
    tr[f"{tag}.xn"] = xn
    tr[f"{tag}.err_xn"] = xn_acc + (1 << 10) - Q.shl(xn, 11)
    y_acc = xn * g[:, None]
    if b is not None:
        y_acc = y_acc + Q.shl(b[:, None], Q.F8)
    y = Q.assert16(Q.rshift_round(y_acc, Q.F8), "ln y")
    tr[f"{tag}.y"] = y
    tr[f"{tag}.err_y"] = y_acc + (1 << 7) - Q.shl(y, Q.F8)
    return y


def block_forward(cfg: BlockCfg, w: Dict[str, torch.Tensor], x: torch.Tensor
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (d_pad, seq) int16-f8 int64 tensor (padded rows zero).
    Returns (y, trace) on x's device."""
    d, seq = cfg.d_pad, cfg.seq
    qd = cfg.qd_pad
    H, KV, dh = cfg.heads, cfg.kv_heads, cfg.dh
    dev = x.device
    tr: Dict[str, torch.Tensor] = {}
    x = x.to(torch.int64)
    assert tuple(x.shape) == (d, seq)

    y1 = _norm(cfg, x, w["g1"], w.get("be1"), "ln1", tr)

    mm = Q.q_matmul_rescale(w["wqT"], y1, w.get("bq"), Q.F8)
    q, tr["q"], tr["err_q"] = mm["y"], mm["y"], mm["err"]
    mm = Q.q_matmul_rescale(w["wkT"], y1, w.get("bk"), Q.F8)
    k, tr["k"], tr["err_k"] = mm["y"], mm["y"], mm["err"]
    mm = Q.q_matmul_rescale(w["wvT"], y1, w.get("bv"), Q.F8)
    v, tr["v"], tr["err_v"] = mm["y"], mm["y"], mm["err"]

    if cfg.family == "llama":
        Ct, Sn = (torch.as_tensor(t, device=dev) for t in Q.rope_tables(dh, seq))
        qr, kr = torch.zeros_like(q), torch.zeros_like(k)
        err_rq, err_rk = torch.zeros_like(q), torch.zeros_like(k)
        for src, dst, err, count in ((q, qr, err_rq, H), (k, kr, err_rk, KV)):
            for h in range(count):
                rr = Q.q_rope(src[h * dh:(h + 1) * dh], Ct, Sn)
                dst[h * dh:(h + 1) * dh] = rr["y"]
                err[h * dh:(h + 1) * dh] = rr["err"]
        tr["qr"], tr["kr"] = qr, kr
        tr["err_rq"], tr["err_rk"] = err_rq, err_rk
        q_att, k_att = qr, kr
    else:
        q_att, k_att = q, k

    mask = torch.as_tensor(cfg.causal_mask, device=dev)
    group = H // KV
    heads = []
    for h in range(H):
        kvh = h // group
        heads.append(Q.q_attention_head(q_att[h * dh:(h + 1) * dh],
                                        k_att[kvh * dh:(kvh + 1) * dh],
                                        v[kvh * dh:(kvh + 1) * dh], mask))
    for key in ("sidx", "err_s", "e", "P", "w1", "w2", "S"):
        tr[key] = torch.stack([th[key] for th in heads])
    O = torch.zeros((qd, seq), dtype=torch.int64, device=dev)
    err_o = torch.zeros_like(O)
    O[:H * dh] = torch.cat([th["o"] for th in heads])
    err_o[:H * dh] = torch.cat([th["err_o"] for th in heads])
    tr["O"], tr["err_o"] = O, err_o

    mm = Q.q_matmul_rescale(w["woT"], O, w.get("bo"), Q.F8)
    proj, tr["proj"], tr["err_proj"] = mm["y"], mm["y"], mm["err"]
    hmid = Q.assert16(x + proj, "hmid")
    tr["hmid"] = hmid

    y2 = _norm(cfg, hmid, w["g2"], w.get("be2"), "ln2", tr)

    acc1 = Q.imatmul(w["w1T"], y2)
    if cfg.has_bias:
        acc1 = acc1 + Q.shl(w["b1f"][:, None], Q.F8)
    a = Q.q_act(cfg.act, acc1, 4)          # f16 -> f12 LUT input
    tr["gidx"], tr["gout"], tr["err_gidx"] = a["idx"], a["out"], a["err"]
    mlp_in = a["out"]
    if cfg.family == "llama":
        accu = Q.imatmul(w["w3T"], y2)
        u = Q.assert16(Q.rshift_round(accu, Q.F8), "mlp up")
        tr["up"] = u
        tr["err_up"] = accu + (1 << 7) - Q.shl(u, Q.F8)
        gg = Q.q_silu_gate(a["out"], u)
        tr["gate"], tr["err_gate"] = gg["y"], gg["err"]
        mlp_in = gg["y"]
    acc2 = Q.imatmul(w["w2T"], mlp_in)
    if cfg.has_bias:
        acc2 = acc2 + Q.shl(w["b2f"][:, None], Q.F8)
    f2 = Q.assert16(Q.rshift_round(acc2, Q.F8), "mlp out")
    tr["f2"] = f2
    tr["err_f2"] = acc2 + (1 << 7) - Q.shl(f2, Q.F8)

    y = Q.assert16(hmid + f2, "block out")
    tr["y_out"] = y
    return y, tr


# ---------------------------------------------------------------------------
# Layout: a public function of the config.  The prover passes the trace
# (host numpy) to fill it.
# ---------------------------------------------------------------------------
def _log2(n: int) -> int:
    l = (n - 1).bit_length() if n > 1 else 0
    assert 1 << l == n
    return l


def _log2_ceil(n: int) -> int:
    return (n - 1).bit_length()


def declare_weights(cfg: BlockCfg, wb: C.WitnessBuilder,
                    w: Optional[Dict[str, np.ndarray]] = None
                    ) -> Dict[str, Tuple[str, int, int]]:
    layout = {}
    for name, shp in weight_shapes(cfg).items():
        n = int(np.prod(shp))
        vals = np.asarray(w[name]).reshape(-1) if w is not None else None
        wb.alloc_limbs(name, n, vals)
        layout[name] = ("limb", n, 16)
    return layout


def declare_boundary(cfg: BlockCfg, wb: C.WitnessBuilder,
                     x: Optional[np.ndarray] = None
                     ) -> Dict[str, Tuple[str, int, int]]:
    n = cfg.d_pad * cfg.seq
    wb.alloc_limbs("act", n, np.asarray(x).reshape(-1) if x is not None else None)
    return {"act": ("limb", n, 16)}


def declare_aux(cfg: BlockCfg, wb: C.WitnessBuilder,
                tr: Optional[Dict[str, np.ndarray]] = None
                ) -> Dict[str, Tuple[str, int, int]]:
    """Declare every aux witness slice. Returns layout name->(kind,n,bits)."""
    d, qd, kv, ff, seq = (cfg.d_pad, cfg.qd_pad, cfg.kvd_pad, cfg.dff_pad,
                          cfg.seq)
    H = cfg.heads
    assert seq <= 256, "softmax relation validated for seq <= 256"
    bS = 12 + _log2(seq)
    layout: Dict[str, Tuple[str, int, int]] = {}

    def get(key):
        return tr[key].reshape(-1) if tr is not None else None

    def limb(name, n, key=None):
        wb.alloc_limbs(name, n, get(key or name))
        layout[name] = ("limb", n, 16)

    def ranged(name, n, bits, key=None):
        wb.alloc_ranged(name, n, bits, get(key or name))
        layout[name] = ("ranged", n, bits)

    for tag in ("ln1", "ln2"):
        if cfg.ln_kind == "layernorm":
            limb(f"{tag}.mu", seq)
            ranged(f"{tag}.e1", seq, max(_log2_ceil(cfg.d), 1))
            if cfg.d & (cfg.d - 1):
                ranged(f"{tag}.e1c", seq, _log2_ceil(cfg.d),
                       key=None if tr is None else "__e1c_" + tag)
            limb(f"{tag}.xc", d * seq)
        ranged(f"{tag}.e2", seq, 4 + _log2_ceil(cfg.d))
        if cfg.d & (cfg.d - 1):
            ranged(f"{tag}.e2c", seq, 4 + _log2_ceil(cfg.d),
                   key=None if tr is None else "__e2c_" + tag)
        ranged(f"{tag}.ms", seq, 16)
        ranged(f"{tag}.rst", seq, 16)
        limb(f"{tag}.xn", d * seq)
        ranged(f"{tag}.err_xn", d * seq, 11)
        limb(f"{tag}.y", d * seq)
        ranged(f"{tag}.err_y", d * seq, 8)
    limb("q", qd * seq)
    ranged("err_q", qd * seq, 8)
    limb("k", kv * seq)
    ranged("err_k", kv * seq, 8)
    limb("v", kv * seq)
    ranged("err_v", kv * seq, 8)
    if cfg.family == "llama":
        limb("qr", qd * seq)
        ranged("err_rq", qd * seq, Q.ROPE_F)
        limb("kr", kv * seq)
        ranged("err_rk", kv * seq, Q.ROPE_F)
    limb("sidx", H * seq * seq)
    ranged("err_s", H * seq * seq, 12)
    ranged("e", H * seq * seq, 12)
    ranged("S", H * seq, bS)
    ranged("P", H * seq * seq, 9)
    ranged("w1", H * seq * seq, bS + 1)
    ranged("w2", H * seq * seq, bS + 1)
    limb("O", qd * seq)
    ranged("err_o", qd * seq, 8)
    limb("proj", d * seq)
    ranged("err_proj", d * seq, 8)
    limb("hmid", d * seq)
    limb("gidx", ff * seq)
    ranged("err_gidx", ff * seq, 4)
    limb("gout", ff * seq)
    if cfg.family == "llama":
        limb("up", ff * seq)
        ranged("err_up", ff * seq, 8)
        limb("gate", ff * seq)
        ranged("err_gate", ff * seq, 8)
    ranged("err_f2", d * seq, 8)
    limb("f2", d * seq)
    return layout


def prepare_trace(cfg: BlockCfg, tr: Dict[str, np.ndarray]
                  ) -> Dict[str, np.ndarray]:
    """Add derived counterpart witnesses for non-pow2 bounds."""
    out = dict(tr)
    if cfg.d & (cfg.d - 1):
        for tag in ("ln1", "ln2"):
            if cfg.ln_kind == "layernorm":
                out["__e1c_" + tag] = cfg.d - 1 - tr[f"{tag}.e1"]
            out["__e2c_" + tag] = (cfg.d << 4) - 1 - tr[f"{tag}.e2"]
    return out


# ---------------------------------------------------------------------------
# View helpers over a built slice map.
# ---------------------------------------------------------------------------
class Views:
    def __init__(self, layout, slices):
        self.layout = layout
        self.sl = slices

    def hi(self, name) -> C.Slice:
        return self.sl[name + ".hi"]

    def lo(self, name) -> C.Slice:
        return self.sl[name + ".lo"]

    def hi_sub(self, name, off, log_n) -> C.Slice:
        return C.subslice(self.sl[name + ".hi"], off, log_n)

    def lo_sub(self, name, off, log_n) -> C.Slice:
        return C.subslice(self.sl[name + ".lo"], off, log_n)

    def limb(self, name) -> C.Affine:
        return C.vaff([(256, self.hi(name)), (1, self.lo(name))],
                      const=-32768)

    def limb_sub(self, name, off, log_n) -> C.Affine:
        return C.vaff([(256, self.hi_sub(name, off, log_n)),
                       (1, self.lo_sub(name, off, log_n))], const=-32768)

    def _ndig(self, name) -> int:
        kind, n, bits = self.layout[name]
        assert kind == "ranged"
        return (bits + 7) // 8

    def ranged(self, name) -> C.Affine:
        return C.vaff([(1 << (8 * i), self.sl[f"{name}.d{i}"])
                       for i in range(self._ndig(name))])

    def ranged_sub(self, name, off, log_n) -> C.Affine:
        return C.vaff([(1 << (8 * i),
                        C.subslice(self.sl[f"{name}.d{i}"], off, log_n))
                       for i in range(self._ndig(name))])

    def digit_sub(self, name, i, off, log_n) -> C.Slice:
        return C.subslice(self.sl[f"{name}.d{i}"], off, log_n)


# ---------------------------------------------------------------------------
# The argument: a deterministic gadget sequence over the commitments.
# ---------------------------------------------------------------------------
def _mm_rescale(ctx, cfg, A_hi, A_lo, B_hi, B_lo, shape, out_view, err_view,
                shift, bias_view=None, a_t=False, b_t=False, what="mm",
                scale: int = 1, out_bits: int = 16):
    acc, r_i, r_j = C.g_int_matmul(ctx, A_hi, A_lo, B_hi, B_lo, shape,
                                   a_t=a_t, b_t=b_t)
    r = torch.cat([r_i, r_j])
    if scale != 1:
        acc = C._scale(acc, scale)
    if bias_view is not None:
        bias = C.BcastCols(bias_view, _log2(shape[2]))
        acc = Fld.f4add(acc, C._scale(ctx.claim(bias, r), 256))
    C.g_rescale(ctx, acc, r, out_view, err_view, shift, out_bits, what)
    return r


def _ln_argument(ctx, cfg, V: Views, Vw: Views, tag: str, x_view,
                 g_name: str, b_name: Optional[str]):
    d_real, d, seq = cfg.d, cfg.d_pad, cfg.seq
    log_d, log_seq = _log2(d), _log2(seq)
    log_ds = log_d + log_seq
    dev = ctx.device
    if cfg.ln_kind == "layernorm":
        xc_v = _ln_mean_argument(ctx, cfg, V, tag, x_view)
    else:
        xc_v = x_view
    # mean square -> rsqrt LUT input
    D = d_real << 4
    ms_v = V.ranged(f"{tag}.ms")
    e2_v = V.ranged(f"{tag}.e2")
    r_t2 = ctx.challenge_point(log_seq)
    sq = C.g_dot_eq(ctx, [xc_v, xc_v], r_t2, total_bits=log_ds,
                    eq_pos="trail")
    rhs = C.f4_lincomb([(D, ctx.claim(ms_v, r_t2)),
                        (1, ctx.claim(e2_v, r_t2))], 0, dev)
    ctx.check_eq(Fld.f4add(sq, C._fc(D // 2, dev)), rhs, f"{tag} ms relation")
    if cfg.d & (cfg.d - 1):
        C.g_lin_relation(ctx, [(1, e2_v), (1, V.ranged(f"{tag}.e2c"))],
                         -(D - 1), f"{tag} e2 bound", log_n=log_seq)
    # xn = rescale(xc * rst, 11)
    rst_v = V.ranged(f"{tag}.rst")
    r_x2 = ctx.challenge_point(log_ds)
    acc = C.g_dot_eq(ctx, [xc_v, C.BcastRows(rst_v, log_d)], r_x2)
    C.g_rescale(ctx, acc, r_x2, V.limb(f"{tag}.xn"),
                V.ranged(f"{tag}.err_xn"), 11, 16, f"{tag} xn rescale")
    # y = rescale(xn * g + 2^8 b, 8)
    r_y = ctx.challenge_point(log_ds)
    acc2 = C.g_dot_eq(ctx, [V.limb(f"{tag}.xn"),
                            C.BcastCols(Vw.limb(g_name), log_seq)], r_y)
    if b_name is not None:
        bias = C.BcastCols(Vw.limb(b_name), log_seq)
        acc2 = Fld.f4add(acc2, C._scale(ctx.claim(bias, r_y), 256))
    C.g_rescale(ctx, acc2, r_y, V.limb(f"{tag}.y"),
                V.ranged(f"{tag}.err_y"), 8, 16, f"{tag} y rescale")
    return V.limb(f"{tag}.y")


def _ln_mean_argument(ctx, cfg, V: Views, tag: str, x_view) -> C.Affine:
    """LayerNorm's mean relation and the xc = rowmask * (x - mu) tie;
    returns the xc view."""
    d_real, d, seq = cfg.d, cfg.d_pad, cfg.seq
    log_d, log_seq = _log2(d), _log2(seq)
    log_ds = log_d + log_seq
    dev = ctx.device
    mu_v = V.limb(f"{tag}.mu")
    e1_v = V.ranged(f"{tag}.e1")
    r_t = ctx.challenge_point(log_seq)
    s1 = C.g_dot_eq(ctx, [x_view], r_t, total_bits=log_ds, eq_pos="trail")
    rhs = C.f4_lincomb([(d_real, ctx.claim(mu_v, r_t)),
                        (1, ctx.claim(e1_v, r_t))], 0, dev)
    ctx.check_eq(Fld.f4add(s1, C._fc(d_real // 2, dev)), rhs,
                 f"{tag} mean relation")
    if cfg.d & (cfg.d - 1):
        C.g_lin_relation(ctx, [(1, e1_v), (1, V.ranged(f"{tag}.e1c"))],
                         -(d_real - 1), f"{tag} e1 bound", log_n=log_seq)
    xc_v = V.limb(f"{tag}.xc")
    r_x = ctx.challenge_point(log_ds)
    x_minus_mu = C.Affine(terms=((1, x_view),
                                 (Fld.P - 1, C.BcastRows(mu_v, log_d))))
    if d_real != d:
        rowmask = C.Public(tuple([1] * d_real + [0] * (d - d_real)),
                           f"{tag}.rowmask")
        t = C.g_dot_eq(ctx, [C.BcastCols(rowmask, log_seq), x_minus_mu], r_x)
    else:
        t = C.g_dot_eq(ctx, [x_minus_mu], r_x)
    ctx.check_eq(ctx.claim(xc_v, r_x), t, f"{tag} xc tie")
    return xc_v


def _rope_argument(ctx, cfg, V: Views) -> None:
    """RoPE on every query and KV head: each half of a head's rotated
    rows is a rescale of two public-table dot products."""
    dh, seq = cfg.dh, cfg.seq
    Ct, Sn = Q.rope_tables(dh, seq)
    Cp = C.Public(tuple(Ct.reshape(-1).tolist()), "rope.cos")
    Sp = C.Public(tuple(Sn.reshape(-1).tolist()), "rope.sin")
    half = dh // 2
    lh = _log2(half * seq)
    for src, dst, err, count in (("q", "qr", "err_rq", cfg.heads),
                                 ("k", "kr", "err_rk", cfg.kv_heads)):
        for h in range(count):
            base = h * dh * seq
            topv = V.limb_sub(src, base, lh)
            botv = V.limb_sub(src, base + half * seq, lh)
            for is_bot in (False, True):
                r = ctx.challenge_point(lh)
                if not is_bot:   # top' = top*C - bot*S
                    acc = Fld.f4sub(C.g_dot_eq(ctx, [Cp, topv], r),
                                    C.g_dot_eq(ctx, [Sp, botv], r))
                    off = base
                else:            # bot' = bot*C + top*S
                    acc = Fld.f4add(C.g_dot_eq(ctx, [Cp, botv], r),
                                    C.g_dot_eq(ctx, [Sp, topv], r))
                    off = base + half * seq
                C.g_rescale(ctx, acc, r, V.limb_sub(dst, off, lh),
                            V.ranged_sub(err, off, lh), Q.ROPE_F, 16,
                            f"rope {dst} h{h}")


def block_argument(ctx, cfg: BlockCfg, V: Views, Vw: Views,
                   x_view: C.Affine, y_view: C.Affine,
                   lut_ints: Optional[Dict[str, np.ndarray]] = None):
    """Run the complete per-layer argument (both sides)."""
    d, qd, kv, ff, seq = (cfg.d_pad, cfg.qd_pad, cfg.kvd_pad, cfg.dff_pad,
                          cfg.seq)
    H, KV, dh = cfg.heads, cfg.kv_heads, cfg.dh
    group = H // KV
    log_seq, log_d = _log2(seq), _log2(d)
    log_H = _log2(_pad2(H))
    ls2 = 2 * log_seq

    bias = cfg.has_bias

    def bv(name):
        return Vw.limb(name) if bias else None

    _ln_argument(ctx, cfg, V, Vw, "ln1", x_view, "g1",
                 "be1" if bias else None)

    _mm_rescale(ctx, cfg, Vw.hi("wqT"), Vw.lo("wqT"), V.hi("ln1.y"),
                V.lo("ln1.y"), (qd, d, seq), V.limb("q"), V.ranged("err_q"),
                8, bv("bq"), what="q proj")
    _mm_rescale(ctx, cfg, Vw.hi("wkT"), Vw.lo("wkT"), V.hi("ln1.y"),
                V.lo("ln1.y"), (kv, d, seq), V.limb("k"), V.ranged("err_k"),
                8, bv("bk"), what="k proj")
    _mm_rescale(ctx, cfg, Vw.hi("wvT"), Vw.lo("wvT"), V.hi("ln1.y"),
                V.lo("ln1.y"), (kv, d, seq), V.limb("v"), V.ranged("err_v"),
                8, bv("bv"), what="v proj")

    # ---- RoPE (llama) ----
    q_name, k_name = ("qr", "kr") if cfg.family == "llama" else ("q", "k")
    if cfg.family == "llama":
        _rope_argument(ctx, cfg, V)

    # ---- attention scores ----
    m_mult = Q.score_mult(dh)
    for h in range(H):
        _score_mm(ctx, cfg, V, q_name, k_name, h, h // group, m_mult)

    # ---- softmax relations (batched over heads) ----
    mask_pub = C.Public(tuple(cfg.causal_mask.reshape(-1).tolist()), "mask")
    mask_all = C.BcastRows(mask_pub, log_H) if log_H else mask_pub
    e_v = V.ranged("e")
    r_hq = ctx.challenge_point(log_H + log_seq)
    sv = C.g_dot_eq(ctx, [mask_all, e_v], r_hq,
                    total_bits=log_H + ls2, eq_pos="lead")
    ctx.check_eq(ctx.claim(V.ranged("S"), r_hq), sv, "softmax row sums")
    S_b = C.BcastCols(V.ranged("S"), log_seq)
    r5 = ctx.challenge_point(log_H + ls2)
    lhs = C._scale(C.g_dot_eq(ctx, [mask_all, e_v], r5), 256)
    rhs1 = C.g_dot_eq(ctx, [V.ranged("P"), S_b], r5)
    v_aff = C.vaff([(C.INV2, V.ranged("w1")), (-C.INV2, S_b)], const=C.INV2)
    rhs = Fld.f4add(rhs1, ctx.claim(v_aff, r5))
    ctx.check_eq(lhs, rhs, "softmax division relation")
    C.g_lin_relation(ctx, [(1, V.ranged("w1")), (1, V.ranged("w2")),
                           (-2, S_b)], 1, "softmax residue bound",
                     log_n=log_H + ls2)

    # ---- P @ V per head ----
    for h in range(H):
        kvh = h // group
        base_p = h * seq * seq
        p_hi = C.vaff([(1, V.digit_sub("P", 1, base_p, ls2))], const=128)
        p_lo = C.vaff([(1, V.digit_sub("P", 0, base_p, ls2))])
        lvs = _log2(dh * seq)
        acc, r_i, r_j = C.g_int_matmul(
            ctx, V.hi_sub("v", kvh * dh * seq, lvs),
            V.lo_sub("v", kvh * dh * seq, lvs), p_hi, p_lo,
            (dh, seq, seq), b_t=True)
        r = torch.cat([r_i, r_j])
        C.g_rescale(ctx, acc, r, V.limb_sub("O", h * dh * seq, lvs),
                    V.ranged_sub("err_o", h * dh * seq, lvs), 8, 16,
                    f"attn out h{h}")

    # ---- output projection + residual ----
    _mm_rescale(ctx, cfg, Vw.hi("woT"), Vw.lo("woT"), V.hi("O"), V.lo("O"),
                (d, qd, seq), V.limb("proj"), V.ranged("err_proj"), 8,
                bv("bo"), what="o proj")
    C.g_lin_relation(ctx, [(1, V.limb("hmid")), (-1, x_view),
                           (-1, V.limb("proj"))], 0, "residual 1",
                     log_n=log_d + log_seq)

    _ln_argument(ctx, cfg, V, Vw, "ln2", V.limb("hmid"), "g2",
                 "be2" if bias else None)

    # ---- MLP ----
    _mm_rescale(ctx, cfg, Vw.hi("w1T"), Vw.lo("w1T"), V.hi("ln2.y"),
                V.lo("ln2.y"), (ff, d, seq), V.limb("gidx"),
                V.ranged("err_gidx"), 4, bv("b1f"), what="fc1")
    mlp_mid = "gout"
    if cfg.family == "llama":
        _mm_rescale(ctx, cfg, Vw.hi("w3T"), Vw.lo("w3T"), V.hi("ln2.y"),
                    V.lo("ln2.y"), (ff, d, seq), V.limb("up"),
                    V.ranged("err_up"), 8, None, what="fc3 up")
        r_g = ctx.challenge_point(_log2(ff * seq))
        acc = C.g_dot_eq(ctx, [V.limb("gout"), V.limb("up")], r_g)
        C.g_rescale(ctx, acc, r_g, V.limb("gate"), V.ranged("err_gate"),
                    8, 16, "silu gate")
        mlp_mid = "gate"
    _mm_rescale(ctx, cfg, Vw.hi("w2T"), Vw.lo("w2T"), V.hi(mlp_mid),
                V.lo(mlp_mid), (d, ff, seq), V.limb("f2"),
                V.ranged("err_f2"), 8, bv("b2f"), what="fc2")
    C.g_lin_relation(ctx, [(1, y_view), (-1, V.limb("hmid")),
                           (-1, V.limb("f2"))], 0, "residual 2",
                     log_n=log_d + log_seq)

    # ---- LUT instances (batched per table) ----
    ti = lut_ints
    exp_idx = C.vaff([(1, V.limb("sidx"))], const=32768)
    C.g_lut(ctx, "exp", exp_idx, V.ranged("e"),
            ti["exp_idx"] if ti else None, ti["exp_out"] if ti else None,
            H * seq * seq, "exp lut")
    act = cfg.act
    act_idx = C.vaff([(1, V.limb("gidx"))], const=32768)
    C.g_lut(ctx, act, act_idx, V.limb("gout"),
            ti[f"{act}_idx"] if ti else None,
            ti[f"{act}_out"] if ti else None, ff * seq, f"{act} lut")
    rs_idx = C.Concat((V.ranged("ln1.ms"), V.ranged("ln2.ms")))
    rs_out = C.Concat((V.ranged("ln1.rst"), V.ranged("ln2.rst")))
    C.g_lut(ctx, "rsqrt", rs_idx, rs_out,
            ti["rsqrt_idx"] if ti else None,
            ti["rsqrt_out"] if ti else None, 2 * seq, "rsqrt lut")


def _score_mm(ctx, cfg, V: Views, q_name, k_name, h, kvh, m_mult):
    seq, dh = cfg.seq, cfg.dh
    ls2 = 2 * _log2(seq)
    lqs = _log2(dh * seq)
    acc, r_i, r_j = C.g_int_matmul(
        ctx, V.hi_sub(q_name, h * dh * seq, lqs),
        V.lo_sub(q_name, h * dh * seq, lqs),
        V.hi_sub(k_name, kvh * dh * seq, lqs),
        V.lo_sub(k_name, kvh * dh * seq, lqs),
        (seq, dh, seq), a_t=True)
    r = torch.cat([r_i, r_j])
    C.g_rescale(ctx, C._scale(acc, m_mult), r,
                V.limb_sub("sidx", h * seq * seq, ls2),
                V.ranged_sub("err_s", h * seq * seq, ls2), 12, 16,
                f"scores h{h}")
    return r


def lut_int_arrays(cfg: BlockCfg, tr: Dict[str, np.ndarray]
                   ) -> Dict[str, np.ndarray]:
    """Prover-side integer arrays for the batched LUT instances."""
    return {
        "exp_idx": (tr["sidx"].reshape(-1) + 32768),
        "exp_out": tr["e"].reshape(-1),
        f"{cfg.act}_idx": (tr["gidx"].reshape(-1) + 32768),
        f"{cfg.act}_out": tr["gout"].reshape(-1),
        "rsqrt_idx": np.concatenate([tr["ln1.ms"], tr["ln2.ms"]]),
        "rsqrt_out": np.concatenate([tr["ln1.rst"], tr["ln2.rst"]]),
    }


def trace_to_numpy(tr: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Witness trace on the host (the witness builder packs numpy)."""
    return {k: v.cpu().numpy() for k, v in tr.items()}
