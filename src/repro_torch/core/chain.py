"""Commitment chain + compositional soundness (mirrors
``repro.core.chain``; paper §3, Theorem 3.1).

A ModelProof is the layer proofs plus the boundary roots c_0 .. c_L;
verification checks every layer proof against its weight root and the
Eq. 3 adjacency c_out(pi_l) == c_in(pi_{l+1}).  ``prove_model`` is the
JAX package's legacy shim over the staged prover engine; new callers use
``repro_torch.api.ProofService``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import blocks as B
from . import field as F
from . import layer_proof as LP
from . import pcs as PCS


@dataclasses.dataclass
class ModelProof:
    layer_proofs: List[LP.LayerProof]
    boundary_roots: List[np.ndarray]     # c_0 .. c_L
    wt_roots: List[np.ndarray]

    def size_bytes(self) -> int:
        return sum(p.size_bytes() for p in self.layer_proofs)


def prove_model(cfgs: Sequence[B.BlockCfg],
                weights_raw: Sequence[Dict[str, np.ndarray]],
                wt_commits: Sequence[LP.WeightCommit],
                x0: np.ndarray, params: PCS.PCSParams,
                layer_subset: Optional[Sequence[int]] = None,
                workers: int = 1, device=None) -> ModelProof:
    """Run the quantized forward chain and prove every (selected) layer:
    a thin wrapper over ``runtime.engine.ProverEngine`` (forward replay,
    one batched boundary commit, per-layer proofs on ``workers``
    threads).  Proving is Fiat-Shamir deterministic, so any worker count
    gives the same transcripts."""
    from repro_torch.runtime.engine import ProverEngine  # runtime sits above core
    with ProverEngine(cfgs, weights_raw, params, wt_commits=wt_commits,
                      workers=workers, device=device) as eng:
        proof, _report = eng.prove(x0, layer_subset=layer_subset)
    return proof


def verify_model(cfgs: Sequence[B.BlockCfg], proof: ModelProof,
                 wt_roots: Sequence[np.ndarray], params: PCS.PCSParams,
                 in_root: Optional[np.ndarray] = None,
                 out_root: Optional[np.ndarray] = None,
                 device=None) -> bool:
    """Full composite verification incl. the Eq. 3 adjacency checks."""
    if in_root is not None and not np.array_equal(
            proof.boundary_roots[0], in_root):
        return False
    if out_root is not None and not np.array_equal(
            proof.boundary_roots[-1], out_root):
        return False
    for lp in proof.layer_proofs:
        l = lp.layer_index
        if not np.array_equal(lp.in_root, proof.boundary_roots[l]):
            return False
        if not np.array_equal(lp.out_root, proof.boundary_roots[l + 1]):
            return False
        if not LP.verify_layer(cfgs[l], lp, wt_roots[l], params,
                               check_input_range=(l == 0), device=device):
            return False
    return True


# ---------------------------------------------------------------------------
# Theorem 3.1 accounting for this proof system.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SoundnessReport:
    eps_layer: float
    eps_total: float
    bits_layer: float
    bits_total: float
    components: Dict[str, float]


def layer_circuit_stats(cfg: B.BlockCfg) -> Dict[str, int]:
    """Conservative counts of soundness-relevant events per layer proof."""
    H, seq = cfg.heads, cfg.seq
    llama = cfg.family == "llama"
    n_matmul = 3 + 2 * H + 2 + (1 if llama else 0)
    n_sumchecks = 9 * n_matmul + 30 + (8 * H if llama else 0)
    max_vars = max((cfg.dff_pad * cfg.seq).bit_length(),
                   (H * seq * seq).bit_length()) + 3
    return dict(n_sumchecks=n_sumchecks, max_vars=max_vars,
                n_lookups=5, n_openings=16, n_relations=40,
                witness=8 * cfg.dff_pad * cfg.seq + 12 * H * seq * seq)


def soundness_bound(cfgs: Sequence[B.BlockCfg], params: PCS.PCSParams
                    ) -> SoundnessReport:
    """eps_total <= sum_l eps_l + (L+2) negl (Thm 3.1): sum-checks, LogUp,
    linear relations, Ligero queries with the index-bias term, Poseidon2
    collisions — the JAX package's accounting."""
    f4 = float(F.P) ** 4
    eps_total = 0.0
    comp = dict(sumcheck=0.0, logup=0.0, relations=0.0, pcs=0.0,
                index_bias=0.0)
    for cfg in cfgs:
        st = layer_circuit_stats(cfg)
        e_sc = st["n_sumchecks"] * st["max_vars"] * 4 / f4
        e_lu = st["n_lookups"] * (st["witness"] + 2 ** 16) / f4
        e_rel = st["n_relations"] * st["max_vars"] / f4
        rho = 1.0 / params.blowup
        n_cols_max = params.blowup * (
            1 << ((st["witness"].bit_length() + 1) // 2))
        bias = n_cols_max / (4.0 * float(F.P))
        e_pcs = st["n_openings"] * ((1 + rho) / 2) ** params.queries
        e_bias = (st["n_openings"]
                  * ((1 + rho) / 2 + bias) ** params.queries) - e_pcs
        comp["sumcheck"] += e_sc
        comp["logup"] += e_lu
        comp["relations"] += e_rel
        comp["pcs"] += e_pcs
        comp["index_bias"] += e_bias
        eps_total += e_sc + e_lu + e_rel + e_pcs + e_bias
    L = len(cfgs)
    negl_hash = (L + 2) * 2.0 ** -124
    eps_total += negl_hash
    comp["hash"] = negl_hash
    eps_layer = eps_total / max(L, 1)
    return SoundnessReport(
        eps_layer=eps_layer, eps_total=eps_total,
        bits_layer=-math.log2(eps_layer) if eps_layer else float("inf"),
        bits_total=-math.log2(eps_total) if eps_total else float("inf"),
        components=comp)
