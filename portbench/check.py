"""The comparison that decides ``correct``: the program's attestations and
ModelCard against the plain reference, on the inputs the benchmark made.

For every attestation the run produced (each is decoded from the wire
bytes the client received) and the published card:

* ``weight_roots_off``: layers whose published weight root differs from
  the reference's commitment of the layer's weights;
* ``boundary_roots_off``: boundary roots c_0 .. c_L that differ from the
  reference's commitments of its own forward replay's h_0 .. h_L (the
  quantized block over the same weights and query), so one differing
  activation word, or one differing commitment word, counts;
* ``columns_off``: words of the codeword columns the layer proofs opened
  under a boundary or weight root that differ from the reference's
  codewords at the same positions;
* ``rejected``: attestations the program's verifier rejected.

Each is exact: its limit is 0.  ``columns_checked`` says how many opened
words were compared (the trace commitments and LogUp helpers are the
program's own and are not recomputed).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .reference import commit as RC
from .reference import forward as RF

LIMITS = dict(weight_roots_off=0, boundary_roots_off=0, columns_off=0,
              rejected=0)


@dataclasses.dataclass
class Served:
    """One attestation as the client received it, in plain arrays."""
    query: np.ndarray
    boundary_roots: List[np.ndarray]          # (8,) uint32 each
    stores: List[Tuple[np.ndarray, np.ndarray, np.ndarray]]  # root, idx, cols
    verified: bool


def _columns_off(enc: torch.Tensor, idx: np.ndarray, cols: np.ndarray) -> int:
    ref = enc[:, torch.as_tensor(idx, device=enc.device)].T.cpu().numpy()
    return int((ref.astype(np.int64) != cols.astype(np.int64)).sum())


def _match(served: Sequence[Served], root: np.ndarray, enc: torch.Tensor,
           counts: Dict, only=None) -> None:
    for k, s in enumerate(served):
        if only is not None and k != only:
            continue
        for r, idx, cols in s.stores:
            if np.array_equal(r, root):
                counts["columns_off"] += _columns_off(enc, idx, cols)
                counts["columns_checked"] += int(cols.size)


def compare(block: Dict, weights: Sequence[Dict[str, np.ndarray]],
            card_wt_roots: Sequence[np.ndarray], served: Sequence[Served],
            blowup: int, device) -> Dict[str, int]:
    """The numbers compared."""
    counts = boundaries(block, weights, served, blowup, device)
    for l, w in enumerate(weights):
        root, enc = RC.commit_weights(block, w, blowup, device)
        counts["weight_roots_off"] += int(
            not np.array_equal(root, np.asarray(card_wt_roots[l])))
        _match(served, root, enc, counts)
        del enc
    return counts


def boundaries(block: Dict, weights: Sequence[Dict[str, np.ndarray]],
               served: Sequence[Served], blowup: int, device
               ) -> Dict[str, int]:
    """The numbers compared, of the boundaries alone: ``served`` against
    the reference's forward replay and its boundary commitments, with
    ``weight_roots_off`` left at 0 (``compare`` adds the weights')."""
    counts = dict(weight_roots_off=0, boundary_roots_off=0, columns_off=0,
                  rejected=sum(not s.verified for s in served),
                  columns_checked=0, attestations=len(served))
    for k, s in enumerate(served):
        acts = RF.chain_forward(block, weights, s.query, device)
        for l, h in enumerate(acts):
            root, enc = RC.commit_boundary(h, blowup, device)
            counts["boundary_roots_off"] += int(
                l >= len(s.boundary_roots)
                or not np.array_equal(root, np.asarray(s.boundary_roots[l])))
            _match(served, root, enc, counts, only=k)
    return counts


def correct(counts: Dict[str, int]) -> bool:
    return counts["attestations"] > 0 and all(
        counts[k] <= lim for k, lim in LIMITS.items())


def lines(counts: Dict[str, int]) -> List[str]:
    return [f"{k} {counts[k]} limit {lim}" for k, lim in LIMITS.items()]
