"""Golden-prove replay harness shared by fs_lint, tape_lint and mutants
(mirrors ``repro.analysis.replay``).

``ReplayLog`` implements both hook interfaces — the transcript recorder
(``core.transcript.set_recorder``) and the circuit observer
(``core.circuit.set_observer``) — and serializes every event of a prover
run into one globally-ordered list.  Payloads arrive as numpy uint32 (the
hooks copy them off the device), so the log reads the same bytes as the
JAX package's.  ``run_golden_prove`` drives a real attestation of a small
toy model through ``api.ProofService`` with the hooks installed, so the
linters analyze exactly the code path production uses, not a mock.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, List

import numpy as np

from repro_torch.core import circuit as C
from repro_torch.core import transcript as T


@dataclasses.dataclass
class Event:
    seq: int
    kind: str           # init|absorb|squeeze|set_state|indices|
    #                     commit|tape|leaf_claim|slice_claim|range_tie|
    #                     witness_slices|open|finalize
    tr: int             # id() of the Transcript (0 if n/a)
    prover: bool        # ctx.is_prover for circuit events (True for tr events)
    data: Dict[str, Any]


class ReplayLog:
    """Recorder + observer writing one ordered event stream."""

    def __init__(self):
        self.events: List[Event] = []
        self.domains: Dict[int, str] = {}
        self._range_tie_pending: Dict[int, str] = {}
        # prover worker threads share this log; per-transcript ordering is
        # what the linters rely on, and each transcript lives on one thread
        self._mu = threading.Lock()

    def _emit(self, kind: str, tr: int, prover: bool, **data):
        with self._mu:
            self.events.append(Event(len(self.events), kind, tr, prover,
                                     data))

    # -- transcript recorder interface --------------------------------------
    def on_init(self, tr, domain: str):
        self.domains[id(tr)] = domain
        self._emit("init", id(tr), True, domain=domain)

    def on_absorb(self, tr, payload: np.ndarray):
        self._emit("absorb", id(tr), True, payload=payload.tobytes(),
                   shape=payload.shape)

    def on_squeeze(self, tr, old: np.ndarray, new: np.ndarray,
                   out: np.ndarray):
        self._emit("squeeze", id(tr), True, old=old.tobytes(),
                   new=new.tobytes(), out=out.tobytes())

    def on_set_state(self, tr, old: np.ndarray, new: np.ndarray):
        self._emit("set_state", id(tr), True, old=old.tobytes(),
                   new=new.tobytes())

    def on_indices(self, tr, n: int, k: int, raw: np.ndarray,
                   idx: np.ndarray):
        self._emit("indices", id(tr), True, n=n, k=k, raw=raw.copy(),
                   idx=idx.copy())

    # -- circuit observer interface -----------------------------------------
    def _ctx_emit(self, kind: str, ctx, **data):
        self._emit(kind, id(ctx.tr), bool(ctx.is_prover), ctx=id(ctx), **data)

    def on_commit(self, ctx, name: str, root: np.ndarray, log_total: int,
                  kind: str):
        self._ctx_emit("commit", ctx, name=name, root=root.tobytes(),
                       log_total=log_total, com_kind=kind)

    def on_tape(self, ctx, kind: str, payload):
        data = dict(tape_kind=kind)
        if kind == "val":
            data["payload"] = np.asarray(payload).tobytes()
        else:
            data["obj"] = payload
        self._ctx_emit("tape", ctx, **data)

    def on_leaf_claim(self, ctx, com: str, point: np.ndarray,
                      value: np.ndarray):
        self._ctx_emit("leaf_claim", ctx, com=com, point=point.tobytes(),
                       value=value.tobytes())

    def on_slice_claim(self, ctx, com: str, offset: int, log_n: int):
        tag = self._range_tie_pending.pop(id(ctx), None)
        self._ctx_emit("slice_claim", ctx, com=com, offset=offset,
                       log_n=log_n, tag=tag)

    def on_range_tie(self, ctx, com: str):
        self._range_tie_pending[id(ctx)] = "range8-tie"

    def on_witness_slices(self, ctx, com: str, slices: Dict):
        self._ctx_emit("witness_slices", ctx, com=com, slices=slices)

    def on_open(self, ctx, name: str, n_points: int):
        self._ctx_emit("open", ctx, name=name, n_points=n_points)

    def on_finalize(self, ctx):
        self._ctx_emit("finalize", ctx)


@contextlib.contextmanager
def recording(log: ReplayLog):
    """Install ``log`` as transcript recorder and circuit observer for the
    duration of the block (any prover run inside it is recorded)."""
    T.set_recorder(log)
    C.set_observer(log)
    try:
        yield log
    finally:
        T.set_recorder(None)
        C.set_observer(None)


def golden_setup():
    """Small-but-real model config mirroring the transcript-determinism
    golden fixture (one gpt2 block, d=8): the JAX package's config and
    seeds."""
    from repro_torch.core import blocks as B
    cfg = B.BlockCfg(family="gpt2", d=8, dff=16, heads=1, kv_heads=1, dh=8,
                     seq=4)
    rng = np.random.default_rng(1234)
    weights = [B.init_weights(cfg, rng)]
    qrng = np.random.default_rng(5678)
    query = np.clip(np.round(qrng.normal(0, 0.5, (cfg.d_pad, cfg.seq)) * 256),
                    -32768, 32767).astype(np.int64)
    return cfg, weights, query


def run_golden_prove(log: ReplayLog | None = None, device=None) -> ReplayLog:
    """Attest the golden toy model with recorder + observer installed, on
    ``device`` (default: the card).

    Pass ``log`` to keep a reference to the (partial) event stream even
    when the prove raises — the mutation corpus lints crashed proves.
    """
    from repro_torch import api
    cfg, weights, query = golden_setup()
    log = log if log is not None else ReplayLog()
    with recording(log):
        with api.ProofService([cfg], weights, default_queries=1,
                              name="analysis-golden", device=device) as svc:
            svc.attest(query, api.VerifyPolicy(pcs_queries=1),
                       tokens=np.arange(3, dtype=np.int32))
    return log
