"""Fiat-Shamir discipline checker (analysis pass ``fs``; mirrors
``repro.analysis.fs_lint``).

Two complementary halves:

* **AST rules** over ``src/repro_torch`` (excluding this package): every
  ``Transcript(...)`` construction must pass a literal, non-empty domain
  string (domain separation is a static property — a computed domain can
  silently collide); ``._squeeze`` must never be called outside
  ``core/transcript.py``; ``.set_state`` (which rewinds/replaces the
  sponge and is sound only when the new state was produced by an
  equivalent absorb/squeeze sequence) is restricted to an allowlist.

* **Replay rules** over a recorded golden prove (``replay.ReplayLog``):
  every squeeze must advance the sponge state and never repeat an output
  on the same transcript (challenge reuse); every prover-sent value —
  commitment root, tape value, leaf-claim evaluation — must be absorbed
  into its transcript after the value event and before the next
  challenge is squeezed from that transcript (the hooks in circuit.py
  deliberately fire *before* the corresponding absorb, so the matching
  absorb must appear strictly later in the event stream); sum-check
  round polynomials on the tape must each have been absorbed; and the
  ``challenge_indices`` modulo bias must stay within the bound charged
  to the soundness budget (``Transcript.INDEX_BIAS_PER_CALL``,
  ``chain.soundness_bound`` component ``index_bias``).

Known gap: every sum-check of the port runs its rounds through the K3
kernel (``core/sumcheck.py``), which absorbs each round polynomial and
squeezes each challenge inside the kernel and hands the new sponge state
back with ``set_state`` — on the CPU too, where K3's plain version runs.
So ``_check_sumcheck_tape`` exempts every sum-check of the port, as the
JAX package exempts its fused path: no absorb events exist to match the
round polynomials against.  The state handoff is covered by the golden
byte tests (the port's attestations equal ``tests/data/golden_v{1,2}.bin``).
"""
from __future__ import annotations

import ast
import pathlib
from typing import List, Optional

import numpy as np

from repro_torch.core import field as F
from repro_torch.core.transcript import Transcript

from . import Finding
from .replay import ReplayLog

SRC_ROOT = pathlib.Path(__file__).resolve().parents[1]   # src/repro_torch

# Files allowed to call Transcript.set_state — each installs a state
# produced by an equivalent absorb/squeeze sequence (the K3 kernel, alone
# or through the round batcher) and is covered by the golden byte tests.
SET_STATE_ALLOW = {
    "core/transcript.py",
    "core/sumcheck.py",
    "runtime/engine.py",
}
SQUEEZE_ALLOW = {"core/transcript.py"}

# challenge_indices bias thresholds. What the soundness accounting
# charges (chain.soundness_bound, "index_bias") is the PER-INDEX
# total-variation bias n/(4P), folded into the per-query column-miss
# probability (1+rho)/2 + n/(4P); we assert it stays under 2^-12, i.e.
# below 0.02% of the factor it perturbs, for every call observed.  The
# summed per-call union bounds k*n/(4P) are additionally checked against
# a loose golden-prove-sized ceiling as a tripwire for a grossly wrong
# sampler (e.g. reducing a multi-lane integer mod a tiny n).
PER_INDEX_BIAS_MAX = 2.0 ** -12
BIAS_TOTAL_MAX = 2.0 ** -16


# ---------------------------------------------------------------------------
# AST half
# ---------------------------------------------------------------------------
def _iter_source_files():
    for p in sorted(SRC_ROOT.rglob("*.py")):
        rel = p.relative_to(SRC_ROOT).as_posix()
        if rel.startswith("analysis/"):
            continue         # the linter itself patches/replays transcripts
        yield p, rel


def _domain_is_literal(node: Optional[ast.expr]) -> bool:
    """Literal non-empty str, or an f-string with a non-empty literal part."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and bool(node.value)
    if isinstance(node, ast.JoinedStr):
        return any(isinstance(v, ast.Constant) and v.value
                   for v in node.values)
    return False


class _AstPass(ast.NodeVisitor):
    def __init__(self, rel: str, findings: List[Finding]):
        self.rel = rel
        self.findings = findings

    def _flag(self, category: str, node: ast.AST, detail: str):
        self.findings.append(Finding(
            "fs", category, f"{self.rel}:{node.lineno}", detail))

    def visit_Call(self, node: ast.Call):
        fn = node.func
        name = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else None)
        if name == "Transcript":
            dom = node.args[0] if node.args else next(
                (kw.value for kw in node.keywords if kw.arg == "domain"),
                None)
            if not _domain_is_literal(dom):
                self._flag("nonliteral-domain", node,
                           "Transcript() domain must be a literal non-empty "
                           "string (static domain separation)")
        elif name == "_squeeze" and isinstance(fn, ast.Attribute):
            if self.rel not in SQUEEZE_ALLOW:
                self._flag("raw-squeeze", node,
                           "._squeeze() bypasses the challenge_* API; "
                           "only core/transcript.py may call it")
        elif name == "set_state" and isinstance(fn, ast.Attribute):
            if self.rel not in SET_STATE_ALLOW:
                self._flag("unvetted-set-state", node,
                           ".set_state() replaces the sponge state; only "
                           f"{sorted(SET_STATE_ALLOW)} may call it")
        self.generic_visit(node)


def ast_checks() -> List[Finding]:
    findings: List[Finding] = []
    for path, rel in _iter_source_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        _AstPass(rel, findings).visit(tree)
    return findings


# ---------------------------------------------------------------------------
# Replay half
# ---------------------------------------------------------------------------
def _check_squeezes(log: ReplayLog, findings: List[Finding]):
    seen_out = {}    # tr -> {out bytes -> seq}
    for ev in log.events:
        if ev.kind != "squeeze":
            continue
        dom = log.domains.get(ev.tr, "?")
        if ev.data["old"] == ev.data["new"]:
            findings.append(Finding(
                "fs", "stuck-squeeze", f"transcript[{dom}]@{ev.seq}",
                "squeeze did not advance the sponge state — the next "
                "challenge would repeat"))
        prev = seen_out.setdefault(ev.tr, {})
        out = ev.data["out"]
        if out in prev:
            findings.append(Finding(
                "fs", "challenge-reuse", f"transcript[{dom}]@{ev.seq}",
                f"challenge bytes identical to squeeze @{prev[out]} on the "
                "same transcript"))
        else:
            prev[out] = ev.seq


def _value_events(log: ReplayLog):
    for ev in log.events:
        if ev.kind == "commit":
            yield ev, ev.data["root"], f"commit[{ev.data['name']}]"
        elif ev.kind == "tape" and ev.data.get("tape_kind") == "val":
            yield ev, ev.data["payload"], "tape-value"
        elif ev.kind == "leaf_claim":
            yield ev, ev.data["value"], f"claim[{ev.data['com']}]"


def _check_absorb_before_challenge(log: ReplayLog, findings: List[Finding]):
    """Every prover-sent value must be absorbed into its transcript after
    the value event and before that transcript's next squeeze."""
    by_tr = {}
    for ev in log.events:
        by_tr.setdefault(ev.tr, []).append(ev)
    for ev, value, what in _value_events(log):
        dom = log.domains.get(ev.tr, "?")
        ok = False
        for later in by_tr[ev.tr]:
            if later.seq <= ev.seq:
                continue
            if later.kind == "absorb" and value in later.data["payload"]:
                ok = True
                break
            if later.kind == "squeeze":
                break
        if not ok:
            findings.append(Finding(
                "fs", "dropped-absorb",
                f"transcript[{dom}]@{ev.seq}",
                f"{what} was sent to the verifier but not absorbed before "
                "the next challenge"))


def _check_sumcheck_tape(log: ReplayLog, findings: List[Finding]):
    """Round polynomials riding the tape must each have been absorbed.

    Transcripts advanced by ``set_state`` (the K3 kernel, which runs every
    sum-check of the port) absorb the rounds *inside* the kernel, so no
    absorb events exist to match against; those are exempt here (the gap
    the module docstring states) — the state handoff itself is covered by
    the golden byte tests.
    """
    absorbed = {}    # tr -> concatenated absorb payloads
    fused = set()
    for ev in log.events:
        if ev.kind == "absorb":
            absorbed[ev.tr] = absorbed.get(ev.tr, b"") + ev.data["payload"]
        elif ev.kind == "set_state" and ev.data["old"] != ev.data["new"]:
            fused.add(ev.tr)
    n_seen = 0
    for ev in log.events:
        if ev.kind != "tape" or ev.data.get("tape_kind") != "obj":
            continue
        obj = ev.data.get("obj")
        polys = getattr(obj, "round_polys", None)
        if polys is None:
            continue
        n_seen += 1
        if ev.tr in fused:
            continue
        blob = absorbed.get(ev.tr, b"")
        dom = log.domains.get(ev.tr, "?")
        for t in range(len(polys)):
            if np.asarray(polys[t]).tobytes() not in blob:
                findings.append(Finding(
                    "fs", "unabsorbed-round",
                    f"transcript[{dom}]@{ev.seq}",
                    f"sum-check round {t} polynomial on the tape was never "
                    "absorbed into its transcript"))
        fe = getattr(obj, "final_evals", None)
        if fe is not None and np.asarray(fe).tobytes() not in blob:
            findings.append(Finding(
                "fs", "unabsorbed-round", f"transcript[{dom}]@{ev.seq}",
                "sum-check final evaluations on the tape were never "
                "absorbed"))
    if not n_seen:
        findings.append(Finding(
            "fs", "replay-coverage", "golden-prove",
            "no sum-check proofs observed on the tape — replay harness is "
            "not seeing the prover"))


def _check_index_bias(log: ReplayLog, findings: List[Finding]):
    total = 0.0
    for ev in log.events:
        if ev.kind != "indices":
            continue
        n, k = ev.data["n"], ev.data["k"]
        if not np.array_equal(np.asarray(ev.data["raw"]) % n,
                              ev.data["idx"]):
            findings.append(Finding(
                "fs", "index-derivation", f"indices@{ev.seq}",
                "challenge_indices output does not equal raw % n"))
        total += Transcript.INDEX_BIAS_PER_CALL(n, k)
        per_index = n / (4.0 * float(F.P))
        if per_index > PER_INDEX_BIAS_MAX:
            findings.append(Finding(
                "fs", "index-bias", f"indices@{ev.seq}",
                f"per-index modulo bias n/(4P) = {per_index:.3e} exceeds "
                f"the {PER_INDEX_BIAS_MAX:.3e} charged to the soundness "
                f"budget (n={n}, k={k})"))
        if np.asarray(ev.data["raw"]).max(initial=0) >= F.P:
            findings.append(Finding(
                "fs", "index-derivation", f"indices@{ev.seq}",
                "raw challenge lane >= P — not a field element"))
    if total > BIAS_TOTAL_MAX:
        findings.append(Finding(
            "fs", "index-bias", "golden-prove",
            f"summed modulo bias {total:.3e} over the prove exceeds "
            f"{BIAS_TOTAL_MAX:.3e}"))


def _check_domains(log: ReplayLog, findings: List[Finding]):
    for tr, dom in log.domains.items():
        if not dom:
            findings.append(Finding(
                "fs", "empty-domain", f"transcript@{tr}",
                "Transcript constructed with an empty domain string"))


def replay_checks(log: ReplayLog) -> List[Finding]:
    findings: List[Finding] = []
    _check_domains(log, findings)
    _check_squeezes(log, findings)
    _check_absorb_before_challenge(log, findings)
    _check_sumcheck_tape(log, findings)
    _check_index_bias(log, findings)
    return findings


def run(log: Optional[ReplayLog] = None, device=None) -> List[Finding]:
    """AST rules plus the replay rules over ``log``, or over a golden
    prove on ``device`` (default: the card) when no log is given."""
    findings = ast_checks()
    if log is None:
        from .replay import run_golden_prove
        log = run_golden_prove(device=device)
    findings += replay_checks(log)
    return findings
