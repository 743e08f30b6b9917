"""Circuit-tape lint (analysis pass ``tape``; mirrors
``repro.analysis.tape_lint``).

Walks the circuit events of a recorded golden prove (``replay.ReplayLog``)
and checks constraint coverage per prover context:

* **unconstrained-commitment** — a commitment was absorbed into the
  transcript but no evaluation claim ever touched it: its contents are
  free variables the verifier never checks.
* **unconstrained-witness** — a named witness slice (from a
  ``WitnessBuilder`` pack) that no slice-level claim intersects.  The
  blanket range8 lookup tie claims the *whole* commitment once per
  flush; that claim is tagged by the recorder and deliberately does not
  count — it proves bytes are in [0,256), not that any relation holds.
* **uncommitted-claim** — an evaluation claim against a name that was
  never committed in that context (the value would be unbound).
* **orphaned-claim** — claims that never reach a PCS opening: the
  context finalized without an ``open`` bundle for the name, or the
  bundle covers fewer points than were claimed.
* **no-finalize** — a prover context committed data but never finalized
  (no openings at all would be emitted).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from . import Finding
from .replay import ReplayLog


class _Ctx:
    def __init__(self):
        self.commits: Dict[str, int] = {}        # name -> log_total
        self.claims: Dict[str, int] = {}         # name -> n leaf claims
        self.slice_claims: Dict[str, List] = {}  # com -> [(offset, log_n)]
        self.witness: Dict[str, Dict] = {}       # com -> {name: Slice}
        self.opens: Dict[str, int] = {}          # name -> n_points
        self.finalized = False


def _collect(log: ReplayLog) -> Dict[int, _Ctx]:
    ctxs: Dict[int, _Ctx] = {}
    for ev in log.events:
        if not ev.prover or "ctx" not in ev.data:
            continue
        c = ctxs.setdefault(ev.data["ctx"], _Ctx())
        if ev.kind == "commit":
            c.commits[ev.data["name"]] = ev.data["log_total"]
        elif ev.kind == "leaf_claim":
            c.claims[ev.data["com"]] = c.claims.get(ev.data["com"], 0) + 1
        elif ev.kind == "slice_claim" and ev.data.get("tag") != "range8-tie":
            c.slice_claims.setdefault(ev.data["com"], []).append(
                (ev.data["offset"], ev.data["log_n"]))
        elif ev.kind == "witness_slices":
            c.witness[ev.data["com"]] = ev.data["slices"]
        elif ev.kind == "open":
            c.opens[ev.data["name"]] = ev.data["n_points"]
        elif ev.kind == "finalize":
            c.finalized = True
    return ctxs


def _check_ctx(cid: int, c: _Ctx, findings: List[Finding]):
    where = f"ctx@{cid}"
    for name in c.commits:
        if not c.claims.get(name):
            findings.append(Finding(
                "tape", "unconstrained-commitment", f"{where}:{name}",
                "commitment absorbed into the transcript but no evaluation "
                "claim ever constrains it"))
    for name, n in c.claims.items():
        if name not in c.commits:
            findings.append(Finding(
                "tape", "uncommitted-claim", f"{where}:{name}",
                f"{n} evaluation claim(s) against a name never committed "
                "in this context"))
            continue
        opened = c.opens.get(name)
        if c.finalized and opened is None:
            findings.append(Finding(
                "tape", "orphaned-claim", f"{where}:{name}",
                f"{n} claim(s) never reached a PCS opening bundle"))
        elif opened is not None and opened < n:
            findings.append(Finding(
                "tape", "orphaned-claim", f"{where}:{name}",
                f"opening bundle covers {opened} point(s) but {n} were "
                "claimed"))
    if c.commits and not c.finalized:
        findings.append(Finding(
            "tape", "no-finalize", where,
            f"context committed {sorted(c.commits)} but never finalized"))
    # witness-slice coverage: each packed slice needs a non-tie claim
    # whose range intersects it
    for com, slices in c.witness.items():
        claimed = c.slice_claims.get(com, [])
        for name, sl in slices.items():
            lo, hi = sl.offset, sl.offset + (1 << sl.log_n)
            if not any(o < hi and lo < o + (1 << ln) for o, ln in claimed):
                findings.append(Finding(
                    "tape", "unconstrained-witness",
                    f"{where}:{com}[{name}]",
                    f"witness slice [{lo}:{hi}) committed but no relation "
                    "claims it (range8 tie excluded)"))


def replay_checks(log: ReplayLog) -> List[Finding]:
    findings: List[Finding] = []
    ctxs = _collect(log)
    if not ctxs:
        findings.append(Finding(
            "tape", "replay-coverage", "golden-prove",
            "no prover circuit contexts observed — replay harness is not "
            "seeing the prover"))
    for cid, c in ctxs.items():
        _check_ctx(cid, c, findings)
    return findings


def run(log: Optional[ReplayLog] = None, device=None) -> List[Finding]:
    """Replay rules over ``log``, or over a golden prove on ``device``
    (default: the card) when no log is given."""
    if log is None:
        from .replay import run_golden_prove
        log = run_golden_prove(device=device)
    return replay_checks(log)
