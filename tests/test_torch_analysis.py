"""The port's soundness analysis (``repro_torch.analysis``) and K5 on the CPU.

* K5's plain version, word for word, against the JAX package's
  ``fold_round`` (its Pallas kernel in interpret mode) and its jnp
  reference ``fold_round_ref``, on numpy-seeded inputs with the edge words
  0, 1, P-1, P-2 planted; ``partial_eval_cols_mm`` against the JAX one;
  the entry registry against the JAX package's.
* The ``ranges`` interval units of ``tests/test_analysis.py`` restated
  for int64, and the host-read rule.
* A clean tree for ``ranges``, ``locks``, ``fs`` and ``tape`` over one
  golden prove of the port on the CPU, and every mutant caught.

Nothing is proved on JAX here.  The module runs torch on one thread: the
golden proves are thousands of tiny tensor ops, which a pool of intra-op
threads only slows down on a shared CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.kernels import sumcheck_fold as JSF
from repro_torch.analysis import AnalysisError, locks, ranges
from repro_torch.analysis.ranges import TOP, AbsVal, _join, analyze_fn
from repro_torch.core import field as F
from repro_torch.kernels import ops as OPS
from repro_torch.kernels import sumcheck_fold as K5

P = F.P
EDGE = (0, 1, P - 1, P - 2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(rng, shape):
    """Uniform Montgomery words (numpy int64) with the edge words planted."""
    a = rng.integers(0, P, size=shape, dtype=np.int64)
    flat = a.reshape(-1)
    k = min(len(EDGE), flat.size)
    flat[:k] = EDGE[:k]
    return a


def _fold_inputs(seed, d, n):
    rng = np.random.default_rng(seed)
    return [_words(rng, (n, 4)) for _ in range(d)], _words(rng, (4,))


def _assert_fold_equal(jax_out, torch_out):
    (jg, jf), (g, folded) = jax_out, torch_out
    assert np.array_equal(np.asarray(jg), F.to_np(g))
    assert len(jf) == len(folded)
    for a, b in zip(jf, folded):
        assert np.array_equal(np.asarray(a), F.to_np(b))


# ---------------------------------------------------------------------------
# K5 and the kernel surface against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d", [1, 2, 3])
def test_fold_plain_matches_pallas_interpret(d):
    fs, c = _fold_inputs(10 + d, d, 16)
    want = JSF.fold_round([jnp.asarray(f.astype(np.uint32)) for f in fs],
                          jnp.asarray(c.astype(np.uint32)), block=4,
                          interpret=True)
    got = K5.fold_round_plain([torch.as_tensor(f) for f in fs],
                              torch.as_tensor(c))
    _assert_fold_equal(want, got)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_fold_plain_matches_reference(d):
    fs, c = _fold_inputs(20 + d, d, 1 << 10)
    want = JREF.fold_round_ref([jnp.asarray(f.astype(np.uint32)) for f in fs],
                               jnp.asarray(c.astype(np.uint32)))
    got = K5.fold_round_plain([torch.as_tensor(f) for f in fs],
                              torch.as_tensor(c))
    _assert_fold_equal(want, got)


def test_fold_wrapper_runs_plain_only_on_cpu_tensors():
    fs, c = _fold_inputs(3, 2, 2)           # n = 2: one (lo, hi) pair
    tf, tc = [torch.as_tensor(f) for f in fs], torch.as_tensor(c)
    want = K5.fold_round_plain(tf, tc)
    for got in (K5.fold_round(tf, tc), OPS.sumcheck_fold(tf, tc)):
        assert torch.equal(got[0], want[0])
        assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    assert tuple(want[0].shape) == (3, 4) and tuple(want[1][0].shape) == (1, 4)
    with pytest.raises(ValueError, match="CUDA"):
        K5.fold_round([f.to("meta") for f in tf], tc.to("meta"))
    for bad in ([tf[0]] * 4, [tf[0][:1]], [torch.zeros((6, 4), dtype=torch.int64)]):
        with pytest.raises(ValueError):
            K5.fold_round(bad, tc)
    with pytest.raises(ValueError):
        K5.fold_round(tf, tc[:3])


def test_partial_eval_cols_mm_matches_jax():
    rng = np.random.default_rng(5)
    mat, r = _words(rng, (8, 8)), _words(rng, (3, 4))
    want = JOPS.partial_eval_cols_mm(jnp.asarray(mat.astype(np.uint32)),
                                     jnp.asarray(r.astype(np.uint32)))
    got = OPS.partial_eval_cols_mm(torch.as_tensor(mat), torch.as_tensor(r))
    assert np.array_equal(np.asarray(want), F.to_np(got))


def test_entry_registry_matches_jax():
    jax_keys = {k for k in JOPS.ANALYSIS_ENTRIES if not k.endswith("_pallas")}
    assert set(OPS.ANALYSIS_ENTRIES) == jax_keys
    for k in jax_keys:
        assert OPS.ANALYSIS_ENTRIES[k]["args"] == JOPS.ANALYSIS_ENTRIES[k]["args"]


@pytest.mark.parametrize("name", sorted(OPS.LONG_ROW_ENTRIES))
def test_long_row_entries_trace_clean(name):
    """K2's long-row entries (part (c) runs them through the kernel's
    two-launch path): their plain version at those shapes proves clean,
    and their shapes are past the one-launch rows."""
    from repro_torch.kernels import ntt_kernel as K2
    spec = OPS.LONG_ROW_ENTRIES[name]
    assert analyze_fn(name, spec["fn"], spec["args"], spec["out"]) == []
    out = spec["fn"](*[torch.zeros(shape, dtype=torch.int64)
                       for _, shape in spec["args"]])
    assert K2.plan(out.shape[1], spec["args"][0][1][1]).launches == 2


def test_ranges_registry_covers_ops_entry_points():
    entries = OPS.ANALYSIS_ENTRIES
    for nm in ranges._covered_ops_entry_points():
        assert any(k == nm or k.startswith(nm + "_") for k in entries), nm


# ---------------------------------------------------------------------------
# interval domain units (int64)
# ---------------------------------------------------------------------------
def test_absval_join_and_const():
    a, b = AbsVal(2, 5), AbsVal(4, 9)
    j = _join(a, b)
    assert (j.lo, j.hi) == (2, 9)
    assert _join(a, TOP) is TOP
    assert AbsVal(7, 7).const == 7 and AbsVal(2, 5).const is None
    assert not TOP.tracked


def test_analyze_fn_clean_add():
    findings = analyze_fn("t_add", F.fadd, [("fp", (8,)), ("fp", (8,))], "fp")
    assert findings == []


def test_analyze_fn_flags_unreduced_add():
    def bad(a, b):
        return a + b
    findings = analyze_fn("t_bad_add", bad, [("fp", (8,)), ("fp", (8,))], "fp")
    assert any(f.category == "fp-range" for f in findings), findings


def test_analyze_fn_flags_i64_mul_overflow():
    # (P-1)^2 < 2^62 fits; (P-1)^3 does not, and is flagged at the op
    def bad(a, b):
        return a * b * a
    findings = analyze_fn("t_bad_mul", bad, [("fp", (8,)), ("fp", (8,))], None)
    assert any(f.category == "i64-overflow" for f in findings), findings
    assert analyze_fn("t_mul", lambda a, b: a * b % P,
                      [("fp", (8,)), ("fp", (8,))], "fp") == []


@pytest.mark.parametrize("read", ["item", "numpy"])
def test_host_read_is_an_analysis_error(read):
    def reads_host(a):
        if read == "item":
            return a * int(a.max())
        return a + torch.as_tensor(a.numpy() % 7)
    with pytest.raises(AnalysisError, match="host"):
        analyze_fn("t_host", reads_host, [("fp", (8,))], None)


# ---------------------------------------------------------------------------
# clean-tree gates over one golden prove of the port
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def golden_log():
    from repro_torch.analysis.replay import run_golden_prove
    return run_golden_prove(device="cpu")


def test_ranges_clean_tree():
    assert ranges.run("cpu") == []


def test_locks_clean_tree():
    assert locks.run() == []


def test_fs_clean_tree(golden_log):
    from repro_torch.analysis import fs_lint
    assert fs_lint.ast_checks() == []
    assert fs_lint.replay_checks(golden_log) == []


def test_tape_clean_tree(golden_log):
    from repro_torch.analysis import tape_lint
    assert tape_lint.replay_checks(golden_log) == []


def test_golden_log_sees_the_prover(golden_log):
    kinds = {ev.kind for ev in golden_log.events}
    assert {"absorb", "squeeze", "set_state", "commit", "leaf_claim",
            "tape", "open", "finalize"} <= kinds
    assert any(ev.prover for ev in golden_log.events)


def test_absorb_each_is_recorded_row_by_row():
    from repro_torch.analysis.replay import ReplayLog, recording
    from repro_torch.core.transcript import Transcript
    rows = torch.as_tensor(_words(np.random.default_rng(8), (3, 4)))
    log = ReplayLog()
    with recording(log):
        tr = Transcript("t", "cpu")
        tr.absorb_each(rows)
    payloads = [ev.data["payload"] for ev in log.events if ev.kind == "absorb"]
    assert payloads[1:] == [F.to_np(r).tobytes() for r in rows]


def test_locks_flag_undocumented_and_unranked(tmp_path, monkeypatch):
    """The faults the lock pass found in the first slice: two modules
    owning ranked locks without a "Lock order" section, and the kernel
    build lock without a rank."""
    import shutil
    root = tmp_path / "repro_torch"
    shutil.copytree(locks.SRC_ROOT, root)
    for rel in ("api/service.py", "runtime/engine.py"):
        p = root / rel
        p.write_text(p.read_text().replace("Lock order", "Locks"))
    monkeypatch.setattr(locks, "SRC_ROOT", root)
    ranks = {k: v for k, v in locks.LOCK_RANKS.items()
             if k[0] != "kernels/_build.py"}
    monkeypatch.setattr(locks, "LOCK_RANKS", ranks)
    got = {(f.category, f.where.split(":")[0]) for f in locks.run()}
    assert got == {("undocumented", "api/service.py"),
                   ("undocumented", "runtime/engine.py"),
                   ("unranked-lock", "kernels/_build.py")}


def test_cli_locks_on_cpu_and_no_silent_cpu():
    from repro_torch.analysis.__main__ import main
    assert main(["--locks", "--device", "cpu"]) == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            main(["--locks"])


# ---------------------------------------------------------------------------
# seeded-bug corpus: each mutant must be caught
# ---------------------------------------------------------------------------
def _mutant_names():
    from repro_torch.analysis.mutants import MUTANTS
    return [m.name for m in MUTANTS]


def test_mutant_corpus_mirrors_jax():
    from repro.analysis.mutants import MUTANTS as JM
    names = set(_mutant_names())
    assert len(names) == 6
    assert names == {m.name for m in JM} - {"wide-limbs"} | {"wide-product"}


@pytest.mark.parametrize("name", _mutant_names())
def test_mutant_is_caught(name):
    from repro_torch.analysis.mutants import MUTANTS, run_mutant
    m, = [m for m in MUTANTS if m.name == name]
    r = run_mutant(m, device="cpu")
    assert r.detected, (
        f"mutant {m.name} ({m.description}) not flagged by {m.analysis}; "
        f"findings: {[str(f) for f in r.findings][:10]}")
