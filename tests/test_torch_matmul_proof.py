"""The item-6 modules of repro_torch against the JAX package: quantize, the
LUT float path, intt and q_layernorm element for element; the matmul
sum-check's proof words and claims under the same transcript;
``chain.prove_model`` against the committed gpt2 golden (which
``ProofService.attest`` wrote); and ``size_bytes``.  Nothing is proved on
JAX here but the small matmul claims."""
import dataclasses
import os
import pickle
import pickletools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import field as JF
from repro.core import luts as JLUTS
from repro.core import matmul_proof as JMM
from repro.core import ntt as JNTT
from repro.core import qops as JQ
from repro.core import quantize as JQZ
from repro.core.transcript import Transcript as JTranscript
from repro_torch import api
from repro_torch.core import blocks as B
from repro_torch.core import chain as CH
from repro_torch.core import field as F
from repro_torch.core import luts as LUTS
from repro_torch.core import matmul_proof as MM
from repro_torch.core import ntt as NTT
from repro_torch.core import qops as Q
from repro_torch.core import quantize as QZ
from repro_torch.core.transcript import Transcript
from repro_torch.kernels import ntt_kernel as K2

DATA = os.path.join(os.path.dirname(__file__), "data")
GOLDEN = dict(family="gpt2", d=8, dff=16, heads=1, kv_heads=1, dh=8, seq=4)
P = F.P


def _eq(j, t):
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert j.dtype == t.dtype, (j.dtype, t.dtype)
    assert np.array_equal(j, t)


# ---------------------------------------------------------------------------
# quantize
# ---------------------------------------------------------------------------
def _quant_inputs():
    rng = np.random.default_rng(11)
    x = rng.normal(0, 40, 4096).astype(np.float32)
    ties = (np.arange(-600, 600) + 0.5) / 256        # x * 256 = k + 1/2
    sat = np.array([127.99, 128.0, 128.01, -128.0, -128.002, -129.0,
                    1e6, -1e6, 0.0, -0.0], np.float64)
    return np.concatenate([x, ties.astype(np.float32),
                           sat.astype(np.float32)])


def test_quantize_matches_jax():
    x = _quant_inputs()
    q = QZ.quantize(torch.as_tensor(x))
    _eq(JQZ.quantize(jnp.asarray(x)), q)
    assert int(q.max()) == QZ.QMAX and int(q.min()) == QZ.QMIN
    # ties round half to even in both: 0.5/256 -> 0, 1.5/256 -> 2
    assert QZ.quantize(torch.tensor([0.5 / 256, 1.5 / 256])).tolist() == [0, 2]
    # a float64 input is taken as float32, as JAX (x64 off) takes it
    _eq(JQZ.quantize(x.astype(np.float64)), QZ.quantize(x.astype(np.float64)))
    _eq(JQZ.dequantize(jnp.asarray(q.numpy())), QZ.dequantize(q))
    fq = QZ.to_field(q)
    _eq(np.asarray(JQZ.to_field(q.numpy())), F.to_np(fq))
    _eq(JQZ.from_field(JQZ.to_field(q.numpy())), torch.as_tensor(
        QZ.from_field(fq)))
    acc = np.random.default_rng(12).integers(-(1 << 24), 1 << 24, 4096,
                                             dtype=np.int32)
    acc[:4] = [1 << 23, -(1 << 23), 127, -128]
    for s in (1, 8, 12):
        _eq(JQZ.requant_shift(jnp.asarray(acc), s),
            QZ.requant_shift(torch.as_tensor(acc), s))


# ---------------------------------------------------------------------------
# LUT float path
# ---------------------------------------------------------------------------
def _lut_inputs(name):
    spec = LUTS.ALL_SPECS[name]
    rng = np.random.default_rng(13)
    step = 2.0 ** -spec.f_in
    x = rng.uniform(spec.lo - 2, spec.hi + 2, 20000)
    mid = spec.lo + (rng.integers(0, LUTS.LUT_SIZE, 4000) + 0.5) * step
    edges = np.array([spec.lo, spec.lo - step / 2, spec.hi, spec.hi - step,
                      spec.hi - step / 2, 0.0])
    return np.concatenate([x, mid, edges]).astype(np.float32)


@pytest.mark.parametrize("name", sorted(LUTS.ALL_SPECS))
def test_lut_float_path_matches_jax(name):
    assert np.array_equal(JLUTS.table_f32(name), LUTS.table_f32(name))
    x = _lut_inputs(name)
    _eq(JLUTS.index_of(name, jnp.asarray(x)),
        LUTS.index_of(name, torch.as_tensor(x)))
    _eq(JLUTS.apply(name, jnp.asarray(x)), LUTS.apply(name, torch.as_tensor(x)))
    spec = LUTS.ALL_SPECS[name]
    codes = np.random.default_rng(14).integers(-(1 << 17), 1 << 17, 4000)
    for f_q in (8, spec.f_in, 16):
        _eq(JLUTS.index_of_q(name, jnp.asarray(codes, jnp.int32), f_q),
            LUTS.index_of_q(name, torch.as_tensor(codes), f_q))
        _eq(JLUTS.apply_q(name, jnp.asarray(codes, jnp.int32), f_q),
            LUTS.apply_q(name, torch.as_tensor(codes), f_q))
    assert JLUTS.measured_errors(name, 20001) == \
        LUTS.measured_errors(name, 20001, device="cpu")


def test_q_layernorm_matches_jax():
    rng = np.random.default_rng(15)
    d, seq = 16, 8
    x = rng.integers(-700, 700, (d, seq))
    g = rng.integers(100, 400, d)
    b = rng.integers(-200, 200, d)
    for bias, sub in ((b, True), (None, False)):
        jt = JQ.q_layernorm(x, g, bias, subtract_mean=sub)
        tt = Q.q_layernorm(torch.as_tensor(x), torch.as_tensor(g),
                           None if bias is None else torch.as_tensor(bias),
                           subtract_mean=sub)
        assert sorted(jt) == sorted(tt)
        for k in jt:
            _eq(np.asarray(jt[k], np.int64), tt[k])


# ---------------------------------------------------------------------------
# NTT: intt, and the plain transform at rows longer than 2^15 words
# ---------------------------------------------------------------------------
def _words(seed, shape):
    a = np.random.default_rng(seed).integers(0, P, shape, dtype=np.int64)
    a.reshape(-1)[:4] = [0, 1, P - 1, P - 2]
    return a.astype(np.uint32)


@pytest.mark.parametrize("n", [2, 64, 1024])
def test_intt_matches_jax(n):
    x = _words(n, (3, n))
    t = F.tensor(x, "cpu")
    _eq(JNTT.intt(jnp.asarray(x)), F.to_np(NTT.intt(t)))
    assert np.array_equal(F.to_np(NTT.intt(NTT.ntt(t))), x)


@pytest.mark.parametrize("log_n", [16, 17])
def test_plain_ntt_matches_jax_at_long_rows(log_n):
    """The plain transform against ``repro.core.ntt`` on rows of 2^16 and
    2^17 words (the K2 long-row path's shapes), both directions, and the
    RS encode into them at blowup 4."""
    n = 1 << log_n
    x = _words(log_n, (2, n))
    t = F.tensor(x, "cpu")
    for inverse in (False, True):
        want = np.asarray(JNTT.ntt(jnp.asarray(x), inverse=inverse))
        assert np.array_equal(want, F.to_np(K2.ntt_rows_plain(t, inverse)))
    assert np.array_equal(np.asarray(JNTT.intt(jnp.asarray(x))),
                          F.to_np(NTT.intt(t)))
    msg = _words(log_n + 1, (2, n // 4))
    assert np.array_equal(np.asarray(JNTT.rs_encode(jnp.asarray(msg), 4)),
                          F.to_np(NTT.rs_encode(F.tensor(msg, "cpu"), 4)))


# ---------------------------------------------------------------------------
# matmul_proof
# ---------------------------------------------------------------------------
def _mm_operands(n, k, m, seed):
    rng = np.random.default_rng(seed)
    A = rng.integers(-300, 300, (n, k))
    Bm = rng.integers(-300, 300, (k, m))
    return A, Bm, A @ Bm


def _claims_equal(jc, tc):
    assert [c.tensor for c in jc] == [c.tensor for c in tc]
    for a, b in zip(jc, tc):
        _eq(a.point, b.point)
        _eq(a.value, b.value)


@pytest.mark.parametrize("n,k,m", [(4, 8, 2), (8, 16, 4), (2, 1, 2)])
def test_matmul_proof_matches_jax(n, k, m):
    """Proof words and claims equal under the same transcript seed; (2, 1,
    2) is the zero-variable sum-check (k = 1)."""
    A, Bm, Cm = _mm_operands(n, k, m, n * k * m)
    jpf, jcl = JMM.prove("A", JF.f_from_int(A), "B", JF.f_from_int(Bm),
                         "C", JF.f_from_int(Cm), JTranscript("mm"))
    tr = Transcript("mm", device="cpu")
    pf, cl = MM.prove("A", F.f_from_int(A, "cpu"), "B",
                      F.f_from_int(Bm, "cpu"), "C", F.f_from_int(Cm, "cpu"),
                      tr)
    _eq(jpf.c_claim, pf.c_claim)
    _eq(jpf.sumcheck.round_polys, pf.sumcheck.round_polys)
    _eq(jpf.sumcheck.final_evals, pf.sumcheck.final_evals)
    _claims_equal(jcl, cl)
    ok, vcl = MM.verify(pf, (n, k, m), ("A", "B", "C"),
                        Transcript("mm", device="cpu"))
    assert ok
    _claims_equal(jcl, vcl)
    jok, jvcl = JMM.verify(pf, (n, k, m), ("A", "B", "C"), JTranscript("mm"))
    assert jok
    _claims_equal(jvcl, vcl)
    # the claims hold: direct MLE evaluations of A, B, C at their points
    from repro_torch.core.mle import mle_eval_base
    flat = {"A": A, "B": Bm, "C": Cm}
    for c in cl:
        v = mle_eval_base(F.f_from_int(flat[c.tensor].reshape(-1), "cpu"),
                          F.tensor(c.point, "cpu"))
        _eq(c.value, F.to_np(v))
    bad = dataclasses.replace(pf, c_claim=pf.c_claim ^ np.uint32(1))
    ok, _ = MM.verify(bad, (n, k, m), ("A", "B", "C"),
                      Transcript("mm", device="cpu"))
    assert not ok


# ---------------------------------------------------------------------------
# prove_model and size_bytes on the gpt2 golden
# ---------------------------------------------------------------------------
def _read(name):
    with open(os.path.join(DATA, name), "rb") as fh:
        return fh.read()


def _module_strings(data: bytes):
    """Opcodes of a pickle with its argument strings, FRAME lengths and
    memo positions left out; and the module paths it names."""
    ops, modules = [], []
    for op, arg, _pos in pickletools.genops(data):
        if op.name in ("FRAME", "MEMOIZE", "PUT", "BINPUT", "LONG_BINPUT"):
            continue
        if isinstance(arg, str) and arg.startswith("repro"):
            modules.append(arg)
            arg = "repro." + arg.split(".", 1)[1] if arg.startswith(
                "repro_torch.") else arg
        ops.append((op.name, arg))
    return ops, modules


def test_prove_model_and_size_bytes_on_the_golden():
    """``prove_model`` proves the golden layer as ``ProofService.attest``
    did for tests/data/golden_v1.bin: the same tapes and roots.

    ``size_bytes`` is ``len(pickle.dumps(tape))`` in both packages.  A
    pickle names each class by its module path (once per path: the
    string is memoised), so the counts may differ only by the length of
    those paths.  The comparison: walk both pickles' opcodes, map
    ``repro_torch.`` to ``repro.`` in every argument string, drop the
    FRAME lengths and memo puts; the two opcode streams must be equal, and
    the port's count must exceed JAX's by exactly 6 bytes
    (``len("_torch")``) for each module path the port's pickle names."""
    cfg = B.BlockCfg(**GOLDEN)
    weights = [B.init_weights(cfg, np.random.default_rng(1234))]
    qrng = np.random.default_rng(5678)
    query = np.clip(np.round(qrng.normal(0, 0.5, (cfg.d_pad, cfg.seq)) * 256),
                    -32768, 32767).astype(np.int64)
    with api.ProofService([cfg], weights, default_queries=1, workers=1,
                          device="cpu") as svc:
        eng = svc.engine_for(1)
        proof = CH.prove_model([cfg], weights, eng.wt_commits, query,
                               eng.params, layer_subset=[0], device="cpu")
    gold = _read("golden_v1.bin")
    want = api.Attestation.from_bytes(gold, device="cpu").proof
    for a, b in zip(want.boundary_roots + want.wt_roots,
                    proof.boundary_roots + proof.wt_roots):
        assert np.array_equal(a, b)
    assert [lp.layer_index for lp in proof.layer_proofs] == [0]
    assert pickle.dumps(proof.layer_proofs[0].tape) == \
        pickle.dumps(want.layer_proofs[0].tape)

    jproof = japi.Attestation.from_bytes(gold).proof
    jbytes = pickle.dumps(jproof.layer_proofs[0].tape)
    tbytes = pickle.dumps(proof.layer_proofs[0].tape)
    assert jproof.size_bytes() == len(jbytes)
    assert proof.size_bytes() == proof.layer_proofs[0].size_bytes() == \
        len(tbytes)
    jops, jmods = _module_strings(jbytes)
    tops, tmods = _module_strings(tbytes)
    assert jops == tops
    assert tmods and all(m.startswith("repro_torch.") for m in tmods)
    assert [m.replace("repro_torch.", "repro.", 1) for m in tmods] == jmods
    assert proof.size_bytes() - jproof.size_bytes() == 6 * len(tmods)
