"""The benchmark's inputs, made from the run's seed: each layer's quantized
weights and each query.  Both the program and the reference are handed
these same arrays.

Weights follow the block's published shapes, padded to powers of two with
zero tails, drawn on the run's device by one ``torch.Generator`` in one
call a tensor: projections N(0, 0.6 / sqrt(fan_in)), norm gains
1 + N(0, 0.02), biases N(0, 0.02), each rounded to 16-bit fixed point with
8 fractional bits.  These norms keep every activation inside the
circuit's provable 16-bit ranges.  Query ``i`` of a run is N(0, 0.5) at 8
fractional bits, (d_pad, seq), padded rows zero, from the seed and ``i``.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

WEIGHT_SCALE = 0.6
QUERY_STD = 0.5


def pow2(n: int) -> int:
    return 1 << max((n - 1).bit_length(), 0) if n > 1 else 1


def block(cfg: Dict, seq: int) -> Dict:
    """The block's sizes with its padded widths, from a configuration
    file's ``block`` group and the traffic's ``seq``."""
    b = dict(cfg["block"], seq=seq)
    b.update(d_pad=pow2(b["d"]), qd_pad=pow2(b["heads"] * b["dh"]),
             kvd_pad=pow2(b["kv_heads"] * b["dh"]), dff_pad=pow2(b["dff"]))
    return b


def weight_shapes(b: Dict) -> Dict[str, tuple]:
    d, qd, kv, ff = b["d_pad"], b["qd_pad"], b["kvd_pad"], b["dff_pad"]
    shapes = {"wqT": (qd, d), "wkT": (kv, d), "wvT": (kv, d), "woT": (d, qd),
              "w1T": (ff, d), "w2T": (d, ff), "g1": (d,), "g2": (d,)}
    if b["family"] == "gpt2":
        shapes.update(bq=(qd,), bk=(kv,), bv=(kv,), bo=(d,), b1f=(ff,),
                      b2f=(d,), be1=(d,), be2=(d,))
    else:
        shapes["w3T"] = (ff, d)
    return shapes


def _real(b: Dict, name: str, axis: int) -> int:
    """The unpadded extent of weight ``name`` along ``axis``."""
    q, kv = b["heads"] * b["dh"], b["kv_heads"] * b["dh"]
    rows = {"wqT": q, "wkT": kv, "wvT": kv, "woT": b["d"], "w1T": b["dff"],
            "w3T": b["dff"], "w2T": b["d"], "bq": q, "bk": kv, "bv": kv,
            "b1f": b["dff"]}
    cols = {"wqT": b["d"], "wkT": b["d"], "wvT": b["d"], "woT": q,
            "w1T": b["d"], "w3T": b["d"], "w2T": b["dff"]}
    return (rows if axis == 0 else cols).get(name, b["d"])


def weights(b: Dict, layers: int, seed: int, device) -> List[Dict[str, np.ndarray]]:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = []
    for _ in range(layers):
        w = {}
        for name, shp in weight_shapes(b).items():
            z = torch.randn(shp, generator=gen, device=device,
                            dtype=torch.float32)
            if name.startswith("w"):
                fan_in = b["dff"] if name == "w2T" else b["d"]
                arr = z * (WEIGHT_SCALE / math.sqrt(fan_in))
            elif name.startswith("g"):
                arr = 1.0 + 0.02 * z
            else:
                arr = 0.02 * z
            q = torch.clamp(torch.round(arr * 256), -32768, 32767).long()
            q[_real(b, name, 0):] = 0
            if q.ndim == 2:
                q[:, _real(b, name, 1):] = 0
            w[name] = q.cpu().numpy()
        out.append(w)
    return out


def query(b: Dict, seed: int, index: int, std: float = QUERY_STD) -> np.ndarray:
    rng = np.random.default_rng([seed, index])
    x = np.clip(np.round(rng.normal(0.0, std, (b["d_pad"], b["seq"])) * 256),
                -32768, 32767).astype(np.int64)
    x[b["d"]:] = 0
    return x
