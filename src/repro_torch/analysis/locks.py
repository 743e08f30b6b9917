"""Lock-order lint (analysis pass ``locks``; mirrors
``repro.analysis.locks``).

The port's service stack takes locks on several layers (gateway → api →
engine → scheduler → round batcher → leaves: admission, metrics,
transport, the replay queue, the analysis log, the kernel build and
launch counters).  Deadlock freedom rests on one
rule: **locks are only ever acquired in increasing rank order**, with
ranks declared once in ``LOCK_RANKS`` below and documented in the
"Lock order" section of each owning module's docstring.

The lint enforces three things statically over ``src/repro_torch``:

* every ``threading.Lock/RLock/Condition/Semaphore`` creation site is
  present in ``LOCK_RANKS`` — adding a lock without ranking it is a
  finding (``unranked-lock``), and a rank whose creation site vanished
  is one too (``stale-rank``);
* inside any one function, lexically nested ``with <lock>:`` blocks
  must acquire strictly increasing ranks (``order-violation``) — equal
  ranks flag as well, since same-rank locks may be taken concurrently
  by different threads in either order;
* every module owning a ranked lock documents the order: its module
  docstring must contain the phrase "Lock order" (``undocumented``).

Cross-function acquisition chains (f holds a lock and calls g which
takes another) are out of static reach here; the rank table is the
contract every call site is held to.
"""
from __future__ import annotations

import ast
import pathlib
from typing import Dict, List, Optional, Tuple

from . import Finding

SRC_ROOT = pathlib.Path(__file__).resolve().parents[1]   # src/repro_torch

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore"}

# (file, owning class or None, attribute/variable name) -> rank.
# Outermost (taken first) = lowest rank.  Same rank = never nested.  The
# ranks are the JAX package's.
LOCK_RANKS: Dict[Tuple[str, Optional[str], str], int] = {
    # gateway admission front door — held only for window bookkeeping,
    # never while proving
    ("gateway/gateway.py", "AttestationGateway", "_lock"): 10,
    # service-level engine/card creation
    ("api/service.py", "ProofService", "_lock"): 20,
    # engine process-pool lifecycle
    ("runtime/engine.py", "ProverEngine", "_pool_lock"): 30,
    # weight-commitment cache fills (may run under the service lock)
    ("runtime/engine.py", "WeightCommitCache", "_lock"): 40,
    # scheduler error/busy bookkeeping inside a prove (local to run())
    ("runtime/scheduler.py", "run", "lock"): 50,
    # sum-check round-batcher registry + wave condition (a wave's K3 call
    # runs under the condition and takes only leaves)
    ("core/sumcheck.py", None, "_BATCHER_LOCK"): 60,
    ("runtime/engine.py", "SumcheckRoundBatcher", "_cv"): 60,
    # leaves: telemetry / transport / replay buffers, the kernel build and
    # the kernels' launch counters — never hold anything else while held
    ("gateway/transport.py", "GatewayServer", "_lock"): 70,
    ("gateway/metrics.py", "GatewayMetrics", "_lock"): 70,
    ("gateway/admission.py", "AdmissionQueue", "_cv"): 70,
    ("runtime/fault.py", "ProofWorkReplayQueue", "_lock"): 70,
    ("analysis/replay.py", "ReplayLog", "_mu"): 70,
    ("kernels/_build.py", None, "_LOCK"): 70,
    ("kernels/_build.py", None, "_COUNT_LOCK"): 70,
}

# Modules that own a ranked lock must carry a "Lock order" docstring
# section (satellite documentation requirement).
_DOC_EXEMPT = {"analysis/replay.py"}   # single leaf lock, documented inline


def _iter_source_files():
    for p in sorted(SRC_ROOT.rglob("*.py")):
        yield p, p.relative_to(SRC_ROOT).as_posix()


def _is_lock_ctor(node: ast.expr) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _LOCK_CTORS
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "threading")


class _FilePass(ast.NodeVisitor):
    def __init__(self, rel: str, findings: List[Finding]):
        self.rel = rel
        self.findings = findings
        self.scope: List[str] = []       # class/function name stack
        self.created: List[Tuple[str, Optional[str], str]] = []
        self._held: List[Tuple[int, str]] = []   # (rank, label) with-stack

    # -- scope tracking ------------------------------------------------------
    def _owner(self) -> Optional[str]:
        return self.scope[-1] if self.scope else None

    def visit_ClassDef(self, node: ast.ClassDef):
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    def _visit_func(self, node):
        self.scope.append(node.name)
        held, self._held = self._held, []   # with-nesting is per-function
        self.generic_visit(node)
        self._held = held
        self.scope.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    # -- lock creation sites -------------------------------------------------
    def visit_Assign(self, node: ast.Assign):
        if _is_lock_ctor(node.value):
            for tgt in node.targets:
                if isinstance(tgt, ast.Attribute):       # self.X = ...
                    owner = next((s for s in reversed(self.scope[:-1])), None)
                    self.created.append((self.rel, owner, tgt.attr))
                elif isinstance(tgt, ast.Name):          # X = ... / global X
                    self.created.append((self.rel, self._owner(), tgt.id))
        self.generic_visit(node)

    # -- nested with-acquisition order ---------------------------------------
    def _resolve(self, expr: ast.expr) -> Optional[Tuple[int, str]]:
        """Rank of a with-item if it names a ranked lock in this file."""
        if isinstance(expr, ast.Attribute):
            name = expr.attr
        elif isinstance(expr, ast.Name):
            name = expr.id
        elif isinstance(expr, ast.Call):                 # _batcher_lock()
            return self._resolve(expr.func)
        else:
            return None
        hits = [(k, r) for k, r in LOCK_RANKS.items()
                if k[0] == self.rel and (k[2] == name
                                         or (isinstance(expr, ast.Call)
                                             and k[1] == name))]
        if not hits:
            return None
        (_, owner, attr), rank = hits[0]
        return rank, f"{owner or self.rel}.{attr}"

    def visit_With(self, node: ast.With):
        entered = []
        for item in node.items:
            got = self._resolve(item.context_expr)
            if got is None:
                continue
            rank, label = got
            if self._held and rank <= self._held[-1][0]:
                self.findings.append(Finding(
                    "locks", "order-violation",
                    f"{self.rel}:{node.lineno}",
                    f"acquires {label} (rank {rank}) while holding "
                    f"{self._held[-1][1]} (rank {self._held[-1][0]}) — "
                    "ranks must strictly increase inward"))
            self._held.append((rank, label))
            entered.append(1)
        self.generic_visit(node)
        for _ in entered:
            self._held.pop()


def run() -> List[Finding]:
    findings: List[Finding] = []
    created = []
    owning_modules = {}
    for path, rel in _iter_source_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        fp = _FilePass(rel, findings)
        fp.visit(tree)
        created.extend(fp.created)
        if any(k[0] == rel for k in LOCK_RANKS):
            owning_modules[rel] = ast.get_docstring(tree) or ""
    for site in created:
        if site not in LOCK_RANKS:
            findings.append(Finding(
                "locks", "unranked-lock", f"{site[0]}:{site[1]}.{site[2]}",
                "lock created but absent from analysis.locks.LOCK_RANKS — "
                "assign it a rank"))
    for site in LOCK_RANKS:
        if site not in created:
            findings.append(Finding(
                "locks", "stale-rank", f"{site[0]}:{site[1]}.{site[2]}",
                "ranked lock no longer exists — remove it from LOCK_RANKS"))
    for rel, doc in owning_modules.items():
        if rel in _DOC_EXEMPT:
            continue
        if "Lock order" not in doc:
            findings.append(Finding(
                "locks", "undocumented", rel,
                "module owns a ranked lock but its docstring has no "
                "'Lock order' section"))
    return findings
