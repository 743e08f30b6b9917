"""Per-layer proof objects: pi_l proving h_l = f_l(h_{l-1}; W_l)
(mirrors ``repro.core.layer_proof``).

A LayerProof binds the boundary roots c_{l-1}, c_l, the weight root from
setup, and the tape of the block argument.  Weight commitments and their
range proofs are made once at setup and reused across queries.
"""
from __future__ import annotations

import dataclasses
import pickle
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device

from . import blocks as B
from . import circuit as C
from . import field as F
from . import pcs as PCS
from .transcript import Transcript


@dataclasses.dataclass
class BoundaryCommit:
    """Commitment to one inter-layer activation h_l (limb slices)."""
    com: Optional[PCS.Commitment]      # prover side only
    ints: Optional[np.ndarray]
    root: np.ndarray
    n: int
    slices: Dict[str, C.Slice]
    layout: Dict


@dataclasses.dataclass
class WeightCommit:
    com: Optional[PCS.Commitment]
    ints: Optional[np.ndarray]
    root: np.ndarray
    n: int
    slices: Dict[str, C.Slice]
    layout: Dict
    range_tape: List                   # standalone range proof (setup)


@dataclasses.dataclass
class LayerProof:
    layer_index: int
    in_root: np.ndarray                # c_{l-1}
    out_root: np.ndarray               # c_l
    wt_root: np.ndarray
    tape: List

    def size_bytes(self) -> int:
        """Pickled size of the tape (numpy throughout).  A pickle names
        each class by its module path, so this differs from the JAX
        package's count only by the longer ``repro_torch`` paths."""
        return len(pickle.dumps(self.tape))


def _host(x) -> Optional[np.ndarray]:
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Setup / commitment helpers.
# ---------------------------------------------------------------------------
def pack_boundary(cfg: B.BlockCfg, x, name: str = "bnd"):
    """Public boundary layout + packed witness ints (no commitment yet)."""
    wb = C.WitnessBuilder(name)
    layout = B.declare_boundary(cfg, wb, _host(x))
    slices, packed, total = wb.pack()
    return layout, slices, packed, total


def commit_boundary(cfg: B.BlockCfg, x, params: PCS.PCSParams,
                    name: str = "bnd", device=None) -> BoundaryCommit:
    layout, slices, packed, total = pack_boundary(cfg, x, name)
    if packed is None:
        return BoundaryCommit(None, None, None, total, slices, layout)
    com = PCS.commit(F.f_from_int(packed, resolve_device(device)), params)
    return BoundaryCommit(com, packed, com.root, total, slices, layout)


def commit_boundaries(cfgs: List[B.BlockCfg], xs: List, params: PCS.PCSParams,
                      name: str = "bnd", device=None) -> List[BoundaryCommit]:
    """Commit all boundary activations through one batched PCS pass per
    width (roots bit-identical to sequential ``commit_boundary``)."""
    dev = resolve_device(device)
    packs = [pack_boundary(cfg, x, name) for cfg, x in zip(cfgs, xs)]
    out: List[Optional[BoundaryCommit]] = [None] * len(packs)
    groups: Dict[int, List[int]] = {}
    for i, (layout, slices, packed, total) in enumerate(packs):
        if packed is None:
            out[i] = BoundaryCommit(None, None, None, total, slices, layout)
        else:
            groups.setdefault(packed.shape[0], []).append(i)
    for idxs in groups.values():
        coms = PCS.commit_batch(
            [F.f_from_int(packs[i][2], dev) for i in idxs], params)
        for i, com in zip(idxs, coms):
            layout, slices, packed, total = packs[i]
            out[i] = BoundaryCommit(com, packed, com.root, total, slices,
                                    layout)
    return out


def commit_weights(cfg: B.BlockCfg, w: Optional[Dict[str, np.ndarray]],
                   params: PCS.PCSParams, name: str = "wt",
                   device=None) -> WeightCommit:
    """Commit layer weights (no range proof — see weight_range_proof)."""
    wb = C.WitnessBuilder(name)
    layout = B.declare_weights(cfg, wb, w)
    slices, packed, total = wb.pack()
    if packed is None:
        return WeightCommit(None, None, None, total, slices, layout, [])
    com = PCS.commit(F.f_from_int(packed, resolve_device(device)), params)
    return WeightCommit(com, packed, com.root, total, slices, layout, [])


def weight_range_proof(wt: WeightCommit, params: PCS.PCSParams,
                       name: str = "wt") -> List:
    """Standalone range proof over a committed weight vector (setup)."""
    tr = Transcript("nanozk.wt.range", wt.com.mat.device)
    # The LogUp helper is 4x the weights; its codewords (blowup times more)
    # are encoded again for the opened columns, not held through the
    # opening's sum-check (16 GiB at TinyLlama width).
    ctx = C.ProverCtx(tr, params, keep_codewords=False)
    ctx.attach(name, wt.com, wt.ints)
    C.g_range8(ctx, name, wt.n)
    C.flush_lookups(ctx)
    ctx.finalize()
    return ctx.tape


def setup_weights(cfg: B.BlockCfg, w: Optional[Dict[str, np.ndarray]],
                  params: PCS.PCSParams, name: str = "wt",
                  device=None) -> WeightCommit:
    """Commit layer weights + produce the amortized range proof."""
    wt = commit_weights(cfg, w, params, name, device)
    if wt.com is not None:
        wt.range_tape = weight_range_proof(wt, params, name)
    return wt


def verify_weight_setup(cfg: B.BlockCfg, root: np.ndarray, range_tape: List,
                        params: PCS.PCSParams, name: str = "wt",
                        device=None) -> bool:
    wb = C.WitnessBuilder(name)
    B.declare_weights(cfg, wb, None)
    _, _, total = wb.pack()
    tr = Transcript("nanozk.wt.range", device)
    ctx = C.VerifierCtx(tr, params, range_tape)
    ctx.attach(name, root, total)
    try:
        C.g_range8(ctx, name, total)
        C.flush_lookups(ctx)
        ctx.finalize()
    except C.ProofError:
        return False
    return True


# ---------------------------------------------------------------------------
# Layer prove / verify.
# ---------------------------------------------------------------------------
def _boundary_views(bc: BoundaryCommit, com_name: str) -> C.Affine:
    slices = {k: dataclasses.replace(v, com=com_name)
              for k, v in bc.slices.items()}
    return B.Views(bc.layout, slices).limb("act")


def prove_layer(cfg: B.BlockCfg, layer_index: int, wt: WeightCommit,
                b_in: BoundaryCommit, b_out: BoundaryCommit,
                trace: Dict, params: PCS.PCSParams,
                check_input_range: bool = False) -> LayerProof:
    """trace: the block_forward trace (tensors or numpy)."""
    trace = {k: _host(v) for k, v in trace.items()}
    tr = Transcript("nanozk.layer", wt.com.mat.device)
    tr.absorb_int(layer_index)
    ctx = C.ProverCtx(tr, params)
    ctx.attach("wt", wt.com, wt.ints)
    ctx.attach("b_in", b_in.com, b_in.ints)
    ctx.attach("b_out", b_out.com, b_out.ints)

    wb = C.WitnessBuilder("aux")
    layout = B.declare_aux(cfg, wb, B.prepare_trace(cfg, trace))
    slices = wb.build(ctx)
    V = B.Views(layout, slices)
    Vw = B.Views(wt.layout, wt.slices)
    B.block_argument(ctx, cfg, V, Vw, _boundary_views(b_in, "b_in"),
                     _boundary_views(b_out, "b_out"),
                     lut_ints=B.lut_int_arrays(cfg, trace))
    wb.run_checks(ctx, slices)
    C.g_range8(ctx, "b_out", b_out.n)
    if check_input_range:
        C.g_range8(ctx, "b_in", b_in.n)
    C.flush_lookups(ctx)
    ctx.finalize()
    return LayerProof(layer_index=layer_index, in_root=b_in.root,
                      out_root=b_out.root, wt_root=wt.root, tape=ctx.tape)


def verify_layer(cfg: B.BlockCfg, proof: LayerProof, wt_root: np.ndarray,
                 params: PCS.PCSParams, check_input_range: bool = False,
                 store: Optional[PCS.ColumnStore] = None,
                 device=None) -> bool:
    if not np.array_equal(proof.wt_root, wt_root):
        return False
    tr = Transcript("nanozk.layer", device)
    tr.absorb_int(proof.layer_index)
    ctx = C.VerifierCtx(tr, params, proof.tape, store=store)
    wb_wt = C.WitnessBuilder("wt")
    wt_layout = B.declare_weights(cfg, wb_wt, None)
    wt_slices, _, wt_total = wb_wt.pack()
    wb_b = C.WitnessBuilder("bnd")
    b_layout = B.declare_boundary(cfg, wb_b, None)
    b_slices, _, b_total = wb_b.pack()
    ctx.attach("wt", proof.wt_root, wt_total)
    ctx.attach("b_in", proof.in_root, b_total)
    ctx.attach("b_out", proof.out_root, b_total)

    wb = C.WitnessBuilder("aux")
    layout = B.declare_aux(cfg, wb, None)
    try:
        slices = wb.build(ctx)
        V = B.Views(layout, slices)
        Vw = B.Views(wt_layout, {k: dataclasses.replace(v, com="wt")
                                 for k, v in wt_slices.items()})
        bv_in = B.Views(b_layout, {k: dataclasses.replace(v, com="b_in")
                                   for k, v in b_slices.items()})
        bv_out = B.Views(b_layout, {k: dataclasses.replace(v, com="b_out")
                                    for k, v in b_slices.items()})
        B.block_argument(ctx, cfg, V, Vw, bv_in.limb("act"),
                         bv_out.limb("act"))
        wb.run_checks(ctx, slices)
        C.g_range8(ctx, "b_out", b_total)
        if check_input_range:
            C.g_range8(ctx, "b_in", b_total)
        C.flush_lookups(ctx)
        ctx.finalize()
    except C.ProofError:
        return False
    return True
