"""PCS proofs whose codeword rows are longer than 2^15 words (the rows K2
encodes in two launches on the card; its plain version here) against the
JAX package: a 2^16-word vector committed at ``aspect=-6`` (4 rows of
2^14 words, codewords of 2^16) and opened at 2 points (the batched
sum-check) from a fresh transcript.  Equal word for word: the encoded
rows and the root; ``us``; the queried columns and their Merkle paths;
the batched sum-check; the transcript's final state."""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pcs as JPCS
from repro.core.transcript import Transcript as JTranscript
from repro_torch.core import field as F
from repro_torch.core import pcs as PCS
from repro_torch.core.transcript import Transcript

P = F.P
N_WORDS = 1 << 16
ASPECT = -6


def _words(seed, shape):
    a = np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.int64)
    flat = a.reshape(-1)
    flat[:4] = [0, 1, P - 1, P - 2]
    return a.astype(np.uint32)


@contextlib.contextmanager
def _one_thread():
    """The port's plain sponge is thousands of serial permutations of tiny
    ops, which torch's intra-op threads only slow down (~1.5x here)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def commitments():
    vec = _words(61, (N_WORDS,))
    jp, tp = JPCS.PCSParams(), PCS.PCSParams()
    jc = JPCS.commit(jnp.asarray(vec), jp, aspect=ASPECT)
    with _one_thread():
        tc = PCS.commit(F.tensor(vec, "cpu"), tp, aspect=ASPECT)
    return jp, tp, jc, tc


def test_long_rows_commit(commitments):
    _, _, jc, tc = commitments
    assert (tc.log_r, tc.log_c) == (jc.log_r, jc.log_c) == (2, 14)
    assert tuple(tc.enc.shape) == (4, 1 << 16)
    assert np.array_equal(np.asarray(jc.enc), F.to_np(tc.enc))
    assert np.array_equal(jc.root, tc.root)


def test_long_rows_batched_opening(commitments):
    jp, tp, jc, tc = commitments
    m = tc.log_r + tc.log_c
    pts = [_words(70 + i, (m, 4)) for i in range(2)]
    jt, tt = JTranscript("long-rows"), Transcript("long-rows", "cpu")
    jb = JPCS.prove_openings(jc, [jnp.asarray(p) for p in pts], jt, jp)
    with _one_thread():
        tb = PCS.prove_openings(tc, [F.tensor(p, "cpu") for p in pts], tt,
                                tp)
    assert np.array_equal(np.asarray(jb.us), np.asarray(tb.us))
    assert jb.u_prox is None and tb.u_prox is None
    assert np.array_equal(np.asarray(jb.columns), np.asarray(tb.columns))
    assert [p.index for p in jb.paths] == [p.index for p in tb.paths]
    assert all(np.array_equal(np.asarray(a.siblings), np.asarray(b.siblings))
               for a, b in zip(jb.paths, tb.paths))
    assert jb.batch_sc is not None and tb.batch_sc is not None
    assert np.array_equal(jb.batch_sc.round_polys, tb.batch_sc.round_polys)
    assert np.array_equal(jb.batch_sc.final_evals, tb.batch_sc.final_evals)
    assert np.array_equal(np.asarray(jt.state), F.to_np(tt.state))
