"""aten-graph interval/overflow analyzer (analysis pass ``ranges``).

Counterpart of ``repro.analysis.ranges``, which interprets jaxprs.  The
port has no jaxprs, so the pass has three parts:

(a) **Graphs and bounds.**  Each entry — every field primitive in
    ``core/field.py`` (``ANALYSIS_BOUNDS``) and every kernel entry point
    in ``kernels/ops.py`` (``ANALYSIS_ENTRIES``, coverage asserted) — is
    traced on CPU tensors of its declared shapes, where each kernel
    wrapper runs its plain PyTorch version, to a functional aten graph
    with ``torch.fx.experimental.proxy_tensor.make_fx``.  A plain version
    that reads the host inside the graph (``.item()``, branching on a
    value, ``.numpy()``) cannot be traced faithfully; that is an
    ``AnalysisError`` to repair in the plain version, never an exemption.

(b) **Interval propagation.**  The graph is walked with exact Python-int
    ``[lo, hi]`` intervals from the declared input bounds (Fp in [0, P)):
    add, sub, mul, remainder (floor-mod, in [0, b) for a positive
    divisor), floor_divide, the bitwise and shift ops, where, sum (hi x
    count), and the view, index, stack and cat ops.  An intermediate that
    can leave its dtype is an ``i64-overflow`` finding at that op; a
    declared Fp output outside [0, P) is ``fp-range``; an output whose
    interval was lost is ``untracked-output``.  An aten op on integer data
    that the pass does not know is an ``analyzer-coverage`` finding, never
    a silent skip.  The port has no deliberate wraps (int64 holds every
    product of two residues), so nothing is exempt.

(c) **The kernels on the card.**  The JAX pass interprets the Pallas
    kernel bodies themselves; a CUDA kernel has no such counterpart.  On a
    CUDA device each ``ANALYSIS_ENTRIES`` entry is run instead through its
    kernel on edge-word inputs — every word at 0, 1, P-2 and P-1 in turn,
    then seeded random words with those words planted — and compared
    element for element with the plain version that (b) proved; so are
    K2's long rows (``LONG_ROW_ENTRIES``, rows of 2^16 and 2^17 words,
    which take the kernel's two-launch path).  A difference is a
    ``kernel-mismatch`` finding.  On the CPU there is no
    kernel and (c) does not run.
"""
from __future__ import annotations

import operator
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.func import functionalize
from torch.utils import _pytree as pytree

from repro_torch.core import field as F
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as KOPS

from . import AnalysisError, Finding

KIND_RANGE = {"fp": (0, F.P - 1)}
EDGE_WORDS = (0, 1, F.P - 2, F.P - 1)
RANDOM_SETS = 2            # seeded random inputs per entry in part (c)
SEED = 0


class AbsVal:
    """Interval [lo, hi] of exact ints; (None, None) = untracked (float)."""
    __slots__ = ("lo", "hi")

    def __init__(self, lo, hi):
        self.lo, self.hi = lo, hi

    @property
    def tracked(self) -> bool:
        return self.lo is not None

    @property
    def const(self):
        return self.lo if (self.lo is not None and self.lo == self.hi) else None

    def __repr__(self):
        return f"AbsVal[{self.lo}, {self.hi}]"


TOP = AbsVal(None, None)


def _join(a: AbsVal, b: AbsVal) -> AbsVal:
    if a is b:
        return a
    if not (a.tracked and b.tracked):
        return TOP
    return AbsVal(min(a.lo, b.lo), max(a.hi, b.hi))


def _join_all(vals: Sequence[AbsVal]) -> AbsVal:
    out = vals[0]
    for v in vals[1:]:
        out = _join(out, v)
    return out


def _dtype_range(dtype) -> Optional[Tuple[int, int]]:
    if dtype == torch.bool:
        return (0, 1)
    if dtype.is_floating_point or dtype.is_complex:
        return None
    info = torch.iinfo(dtype)
    return (int(info.min), int(info.max))


def _from_concrete(t: torch.Tensor) -> AbsVal:
    if _dtype_range(t.dtype) is None:
        return TOP
    if t.numel() == 0:
        return AbsVal(0, 0)
    return AbsVal(int(t.min()), int(t.max()))


def _overflow_category(dtype) -> str:
    return "i64-overflow" if dtype == torch.int64 else "int-overflow"


def _corners(f, a: AbsVal, b: AbsVal) -> Tuple[int, int]:
    vals = [f(x, y) for x in (a.lo, a.hi) for y in (b.lo, b.hi)]
    return min(vals), max(vals)


# views and indexing: the output holds only words of the first input
_PASS_THROUGH = frozenset({
    "view", "_unsafe_view", "reshape", "view_copy", "slice", "slice_copy",
    "select", "select_copy", "unsqueeze", "unsqueeze_copy", "squeeze",
    "squeeze_copy", "expand", "expand_copy", "permute", "permute_copy",
    "transpose", "transpose_copy", "alias", "alias_copy", "clone",
    "detach", "detach_copy", "lift_fresh_copy", "index",
})
# scatters and selects: op -> the argument positions whose words the
# output may hold
_SCATTER = {"select_scatter": (0, 1), "slice_scatter": (0, 1),
            "where": (1, 2), "copy": (1,)}
_COMPARE = frozenset({"eq", "ne", "lt", "le", "gt", "ge"})


class Analyzer:
    """Walks one aten graph with intervals, appending findings."""

    def __init__(self, entry: str, findings: List[Finding]):
        self.entry = entry
        self.findings = findings

    def _flag(self, category: str, node, detail: str):
        self.findings.append(Finding(
            "ranges", category, f"{self.entry}: {node.target} ({node.name})",
            detail))

    def run(self, gm: torch.fx.GraphModule, args: Sequence[AbsVal]
            ) -> List[AbsVal]:
        env: Dict = {}
        args = iter(args)
        for node in gm.graph.nodes:
            if node.op == "placeholder":
                env[node] = next(args)
            elif node.op == "get_attr":
                env[node] = _from_concrete(getattr(gm, node.target))
            elif node.op == "call_function":
                if (node.target.__name__.startswith("detach")
                        and not node.users):
                    raise AnalysisError(
                        f"{self.entry}: {node.name} hands a traced value to "
                        "the host (.numpy()/.cpu()); the plain version must "
                        "stay on the tensors it is given")
                env[node] = self.call(node, env)
            elif node.op == "output":
                return [self._val(x, env)
                        for x in pytree.tree_leaves(node.args[0])]
        raise AnalysisError(f"{self.entry}: graph has no output")

    @staticmethod
    def _val(a, env):
        if isinstance(a, torch.fx.Node):
            return env[a]
        if isinstance(a, bool):
            return AbsVal(int(a), int(a))
        if isinstance(a, int):
            return AbsVal(a, a)
        if isinstance(a, float) and a.is_integer():
            return AbsVal(int(a), int(a))   # a Scalar such as a pad value 0.0
        if isinstance(a, (list, tuple)):
            return [Analyzer._val(x, env) for x in a]
        return TOP

    # -- dispatch -------------------------------------------------------------
    def call(self, node, env):
        if node.target is operator.getitem:    # an output of a multi-output
            return env[node.args[0]]           # op, flagged below as unknown
        name = node.target.overloadpacket.__name__
        ins = [self._val(a, env) for a in node.args]
        handler = getattr(self, "op_" + name, None)
        if handler is not None:
            return handler(node, ins)
        if name in _PASS_THROUGH:
            return ins[0]
        if name in _SCATTER:
            vals = [ins[i] for i in _SCATTER[name]]
            return self._track(node, _join_all(
                [v if isinstance(v, AbsVal) else TOP for v in vals]))
        if name in _COMPARE:
            return AbsVal(0, 1)
        rng = self._range(node)
        if rng is None:
            return TOP                       # float math: untracked
        self._flag("analyzer-coverage", node,
                   f"unhandled aten op '{name}' on integer data — extend "
                   "repro_torch.analysis.ranges before trusting this entry")
        return AbsVal(*rng)

    @staticmethod
    def _range(node) -> Optional[Tuple[int, int]]:
        return _dtype_range(node.meta["val"].dtype)

    def _track(self, node, v: AbsVal) -> AbsVal:
        """v, or the whole dtype range when v is untracked."""
        if v.tracked:
            return v
        rng = self._range(node)
        return TOP if rng is None else AbsVal(*rng)

    def _int_out(self, node, lo: int, hi: int) -> AbsVal:
        rng = self._range(node)
        if rng is None:
            return TOP
        if lo < rng[0] or hi > rng[1]:
            dtype = node.meta["val"].dtype
            self._flag(_overflow_category(dtype), node,
                       f"interval [{lo}, {hi}] exceeds {dtype} range "
                       f"[{rng[0]}, {rng[1]}]")
            return AbsVal(*rng)
        return AbsVal(lo, hi)

    def _binary(self, node, ins, f):
        a, b = ins[0], ins[1]
        if not (a.tracked and b.tracked):
            return self._track(node, TOP)
        return self._int_out(node, *_corners(f, a, b))

    # -- integer arithmetic ---------------------------------------------------
    def op_add(self, node, ins):
        alpha = node.kwargs.get("alpha", 1)
        return self._binary(node, ins, lambda x, y: x + alpha * y)

    def op_sub(self, node, ins):
        alpha = node.kwargs.get("alpha", 1)
        return self._binary(node, ins, lambda x, y: x - alpha * y)

    def op_mul(self, node, ins):
        return self._binary(node, ins, operator.mul)

    def op_neg(self, node, ins):
        a = ins[0]
        if not a.tracked:
            return self._track(node, TOP)
        return self._int_out(node, -a.hi, -a.lo)

    def op_remainder(self, node, ins):
        a, b = ins[0], ins[1]
        if not b.tracked or b.lo <= 0 <= b.hi:
            return self._unknown_divisor(node, "remainder", b)
        if b.lo > 0:                          # floor-mod: [0, b)
            if a.tracked and 0 <= a.lo and a.hi < b.lo:
                return a                      # already reduced
            return AbsVal(0, b.hi - 1)
        return AbsVal(b.lo + 1, 0)            # negative divisor: (b, 0]

    def op_floor_divide(self, node, ins):
        a, b = ins[0], ins[1]
        if not b.tracked or b.lo <= 0 <= b.hi:
            return self._unknown_divisor(node, "floor_divide", b)
        if not a.tracked:
            return self._track(node, TOP)
        return self._int_out(node, *_corners(operator.floordiv, a, b))

    def _unknown_divisor(self, node, what: str, b: AbsVal) -> AbsVal:
        self._flag("analyzer-coverage", node,
                   f"{what} by a divisor interval {b} that may be 0")
        return self._track(node, TOP)

    def op_bitwise_and(self, node, ins):
        a, b = ins[0], ins[1]
        if a.tracked and b.tracked and a.lo >= 0 and b.lo >= 0:
            return AbsVal(0, min(a.hi, b.hi))
        return self._track(node, TOP)

    def op_bitwise_or(self, node, ins):
        a, b = ins[0], ins[1]
        if a.tracked and b.tracked and a.lo >= 0 and b.lo >= 0:
            bits = max(a.hi.bit_length(), b.hi.bit_length())
            return AbsVal(max(a.lo, b.lo), (1 << bits) - 1)
        return self._track(node, TOP)

    def op_bitwise_xor(self, node, ins):
        a, b = ins[0], ins[1]
        if a.tracked and b.tracked and a.lo >= 0 and b.lo >= 0:
            bits = max(a.hi.bit_length(), b.hi.bit_length())
            return AbsVal(0, (1 << bits) - 1)
        return self._track(node, TOP)

    def op_bitwise_right_shift(self, node, ins):
        a, s = ins[0], ins[1]
        if not (a.tracked and s.tracked) or s.lo < 0:
            return self._track(node, TOP)
        return AbsVal(*_corners(operator.rshift, a, s))

    op___rshift__ = op_bitwise_right_shift

    def op_bitwise_left_shift(self, node, ins):
        a, s = ins[0], ins[1]
        if not (a.tracked and s.tracked) or s.lo < 0:
            return self._track(node, TOP)
        return self._int_out(node, *_corners(operator.lshift, a, s))

    op___lshift__ = op_bitwise_left_shift

    def op_sum(self, node, ins):
        a = ins[0]
        if not a.tracked:
            return self._track(node, TOP)
        n_in = node.args[0].meta["val"].numel()
        n_out = node.meta["val"].numel()
        if n_in == 0:
            return AbsVal(0, 0)
        count = n_in // n_out
        return self._int_out(node, count * a.lo, count * a.hi)

    # -- data movement ---------------------------------------------------------
    def op_cat(self, node, ins):
        return self._track(node, _join_all(ins[0]))

    op_stack = op_cat

    def op_constant_pad_nd(self, node, ins):
        value = ins[2] if len(ins) > 2 else AbsVal(0, 0)
        return self._track(node, _join(ins[0], value))

    def op_zeros(self, node, ins):
        return AbsVal(0, 0)

    def op_full(self, node, ins):
        v = ins[1]            # full(size, v), full_like(t, v), fill(t, v)
        return self._track(node, v if isinstance(v, AbsVal) else TOP)

    op_full_like = op_fill = op_full


def _varargs(fn):
    return lambda *args: fn(*args)


def _make_arg(kind: str, shape: Tuple[int, ...]) -> torch.Tensor:
    if kind not in KIND_RANGE:
        raise AnalysisError(f"unknown bound kind {kind!r}")
    return torch.zeros(shape, dtype=F.I64)


def trace(name: str, fn, args: Sequence[torch.Tensor]) -> torch.fx.GraphModule:
    """The functional aten graph of ``fn`` on CPU ``args``, traced with
    fake tensors; the plain versions' constant tables enter it as real
    constants."""
    fn(*args)   # fill the plain versions' constant caches outside the trace
    try:
        return make_fx(functionalize(_varargs(fn),
                                     remove="mutations_and_views"),
                       tracing_mode="fake", _allow_non_fake_inputs=True)(*args)
    except RuntimeError as e:
        raise AnalysisError(
            f"{name}: make_fx cannot trace the plain version — it reads the "
            f"host inside the graph ({e})") from e


def analyze_fn(name: str, fn, arg_specs, out_kind: Optional[str]
               ) -> List[Finding]:
    """Trace fn under declared bounds and interval-check its aten graph."""
    findings: List[Finding] = []
    gm = trace(name, fn, [_make_arg(kind, shape) for kind, shape in arg_specs])
    abs_args = [AbsVal(*KIND_RANGE[kind]) for kind, _ in arg_specs]
    outs = Analyzer(name, findings).run(gm, abs_args)
    if out_kind is not None:
        lo, hi = KIND_RANGE[out_kind]
        for i, o in enumerate(outs):
            if not o.tracked:
                findings.append(Finding(
                    "ranges", "untracked-output", name,
                    f"output {i} escaped interval tracking"))
            elif o.lo < lo or o.hi > hi:
                findings.append(Finding(
                    "ranges", f"{out_kind}-range", name,
                    f"output {i} interval [{o.lo}, {o.hi}] exceeds declared "
                    f"{out_kind} bound [{lo}, {hi}]"))
    return findings


# ---------------------------------------------------------------------------
# Part (c): every entry's kernel against its proved plain version.
# ---------------------------------------------------------------------------
def _input_sets(arg_specs, gen: np.random.Generator):
    """Each argument at every edge word in turn, then seeded random words
    with the edge words planted at the front."""
    for w in EDGE_WORDS:
        yield f"all {w}", [torch.full(shape, w, dtype=F.I64)
                           for _, shape in arg_specs]
    for r in range(RANDOM_SETS):
        args = []
        for kind, shape in arg_specs:
            lo, hi = KIND_RANGE[kind]
            a = gen.integers(lo, hi + 1, size=shape, dtype=np.int64)
            flat = a.reshape(-1)
            k = min(len(EDGE_WORDS), flat.size)
            flat[:k] = EDGE_WORDS[:k]
            args.append(torch.as_tensor(a))
        yield f"random {r}", args


def kernel_checks(entries: Dict, device: torch.device) -> List[Finding]:
    """Run each entry through its kernel on ``device`` and compare it with
    the plain version on the same inputs, element for element."""
    findings: List[Finding] = []
    gen = np.random.default_rng(SEED)
    for name, spec in entries.items():
        for label, args in _input_sets(spec["args"], gen):
            want = pytree.tree_leaves(spec["fn"](*args))
            got = pytree.tree_leaves(spec["fn"](*[a.to(device) for a in args]))
            torch.cuda.synchronize(device)
            bad = [i for i, (g, w) in enumerate(zip(got, want))
                   if g.shape != w.shape or not torch.equal(g.cpu(), w)]
            if len(got) != len(want) or bad:
                findings.append(Finding(
                    "ranges", "kernel-mismatch", name,
                    f"kernel on {device} differs from the plain version on "
                    f"inputs '{label}' (outputs {bad or 'count'})"))
    return findings


def _covered_ops_entry_points() -> List[str]:
    """Public kernel entry points in ops.py that must appear in the
    registry — coverage is asserted, not assumed."""
    import inspect
    return [nm for nm, obj in vars(KOPS).items()
            if not nm.startswith("_") and inspect.isfunction(obj)
            and obj.__module__ == KOPS.__name__]


def run(device=None) -> List[Finding]:
    """Parts (a) and (b) over every entry; part (c) when ``device`` (default:
    the card) is a CUDA device."""
    dev = resolve_device(device)
    entries = dict(KOPS.ANALYSIS_ENTRIES)
    missing = [nm for nm in _covered_ops_entry_points()
               if not any(k == nm or k.startswith(nm + "_") for k in entries)]
    if missing:
        raise AnalysisError(
            f"kernel entry points missing ANALYSIS_ENTRIES bounds: {missing}")
    findings: List[Finding] = []
    for nm, spec in list(F.ANALYSIS_BOUNDS.items()) + list(entries.items()):
        findings.extend(analyze_fn(nm, spec["fn"], spec["args"], spec["out"]))
    if dev.type == "cuda":
        findings.extend(kernel_checks({**entries, **KOPS.LONG_ROW_ENTRIES},
                                      dev))
    return findings
