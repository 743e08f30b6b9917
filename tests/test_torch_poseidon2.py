"""Poseidon2, the K1 plain versions and the transcript sponge of repro_torch
against the JAX package, exact equality."""
import numpy as np
import pytest

import jax.numpy as jnp

from repro.core import poseidon2 as JP2
from repro.core import transcript as JT
from repro.kernels import ops as KOPS
from repro.kernels import ref as KREF
from repro_torch.core import field as F
from repro_torch.core import poseidon2 as P2
from repro_torch.core import transcript as T
from repro_torch.kernels import poseidon2_kernel as K1

P = F.P


def _words(seed, shape):
    a = np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.int64)
    flat = a.reshape(-1)
    k = min(4, flat.size)
    flat[:k] = [0, 1, P - 1, P - 2][:k]
    return a.astype(np.uint32)


def _t(a):
    return F.tensor(a, "cpu")


def test_constants_match():
    assert np.array_equal(P2.RC_FULL, JP2._RC_FULL)
    assert np.array_equal(P2.RC_PART, JP2._RC_PART)
    assert np.array_equal(P2.DIAG, JP2._DIAG)
    assert np.array_equal(P2.RC_FULL_M.astype(np.uint32), JP2._RC_FULL_M)
    assert np.array_equal(P2.DIAG_M.astype(np.uint32), JP2._DIAG_M)


def test_permute_hash_compress():
    s = _words(1, (6, 16))
    assert np.array_equal(np.asarray(JP2.permute(jnp.asarray(s))),
                          F.to_np(P2.permute(_t(s))))
    e = _words(2, (2, 3, 21))
    assert np.array_equal(np.asarray(JP2.hash_elems(jnp.asarray(e))),
                          F.to_np(P2.hash_elems(_t(e))))
    l, r = _words(3, (5, 8)), _words(4, (5, 8))
    assert np.array_equal(np.asarray(JP2.compress(jnp.asarray(l), jnp.asarray(r))),
                          F.to_np(P2.compress(_t(l), _t(r))))


def test_k1_permute_batch_plain():
    s = _words(5, (33, 16))
    assert np.array_equal(np.asarray(KREF.permute_ref(jnp.asarray(s))),
                          F.to_np(K1.permute_plain(_t(s))))
    # the Pallas kernel itself, in interpret mode (one grid step)
    assert np.array_equal(np.asarray(KOPS.poseidon2_permute(jnp.asarray(s[:8]))),
                          F.to_np(K1.permute_batch(_t(s[:8]))))


@pytest.mark.parametrize("L", [1, 8, 13, 24, 29])
def test_k1_hash_rows_plain(L):
    e = _words(10 + L, (7, L))
    want = np.asarray(KOPS.poseidon2_hash(jnp.asarray(e)))
    assert np.array_equal(want, F.to_np(K1.sponge_plain(None, _t(e), L, 1, 8)))
    assert np.array_equal(want, F.to_np(K1.hash_rows(_t(e))))


def test_k1_compress_pairs_plain():
    l, r = _words(6, (9, 8)), _words(7, (9, 8))
    want = np.asarray(KOPS.poseidon2_compress(jnp.asarray(l), jnp.asarray(r)))
    assert np.array_equal(want, F.to_np(K1.compress_plain(_t(l), _t(r))))


def test_k1_squeeze_and_segments_plain():
    """squeeze = repeated permute-and-emit; multi-segment sponge = one
    length-tagged absorb per segment, as the transcript runs them."""
    s = _words(8, (3, 16))
    st, lanes = K1.squeeze_plain(_t(s), 3)
    cur = jnp.asarray(s)
    out = []
    for _ in range(3):
        cur = JP2.permute(cur)
        out.append(np.asarray(cur)[:, :8])
    assert np.array_equal(np.asarray(cur), F.to_np(st))
    assert np.array_equal(np.concatenate(out, axis=1), F.to_np(lanes))
    vals = _words(9, (5, 4))
    state = jnp.asarray(s[0])
    for v in vals:
        state = JT._absorb_any(state, jnp.asarray(v), 4)
    got = K1.sponge_plain(_t(s[:1]), _t(vals.reshape(1, 20)), 4, 5)
    assert np.array_equal(np.asarray(state), F.to_np(got[0]))


def _script(tr, absorb_arrays, ints):
    """A scripted absorb/squeeze sequence; returns every output."""
    out = []
    tr.absorb(absorb_arrays[0])
    out.append(tr.challenge_f())
    tr.absorb_int(ints[0])
    out.append(tr.challenge_f4())
    tr.absorb(absorb_arrays[1])
    out.append(tr.challenge_f4_vec(5))
    out.append(tr.challenge_indices(1 << 12, 16))
    tr.absorb(absorb_arrays[2])
    tr.absorb_int(ints[1])
    out.append(tr.challenge_indices(37, 9))
    out.append(tr.challenge_f4_vec(3))
    return out


def test_transcript_matches_sponge_states():
    arrays = [_words(20, (3,)), _words(21, (4, 5)), _words(22, (17,))]
    ints = [7, P + 5]
    jt = JT.Transcript("nanozk.test.domain-that-is-longer-than-32-bytes")
    tt = T.Transcript("nanozk.test.domain-that-is-longer-than-32-bytes",
                      device="cpu")
    jout = _script(jt, [jnp.asarray(a) for a in arrays], ints)
    tout = _script(tt, arrays, ints)
    for a, b in zip(jout, tout):
        b = b if isinstance(b, np.ndarray) and b.dtype == np.int64 else F.to_np(b)
        assert np.array_equal(np.asarray(a), b)
    assert np.array_equal(np.asarray(jt.state), F.to_np(tt.state))


def test_transcript_absorb_each_matches_loop():
    vals = _words(23, (6, 4))
    a = T.Transcript("x", device="cpu")
    b = T.Transcript("x", device="cpu")
    a.absorb_each(_t(vals))
    for v in vals:
        b.absorb(v)
    assert np.array_equal(F.to_np(a.state), F.to_np(b.state))


@pytest.mark.parametrize("n,blocks", [(1, 1), (8, 1), (9, 2), (17, 3), (33, 5),
                                      (4096, 512)])
def test_k1_launch_geometry(n, blocks):
    """16 lanes per state and 8 states per block of 128 threads: the Merkle
    leaf hashing of a 4096-column commitment runs 65,536 threads (512
    blocks, enough for the H100's 132 SMs), and a last block may hold rows
    past n, which compute on a zero state and store nothing."""
    assert K1.blocks(n) == blocks
    assert K1.blocks(n) * K1.THREADS >= n * K1.LANES > (K1.blocks(n) - 1) * K1.THREADS


@pytest.mark.parametrize("seg_len,nseg,perms", [(0, 1, 0), (1, 1, 1), (4, 1, 1),
                                                (8, 1, 1), (9, 1, 2), (3243, 1, 406),
                                                (4096, 1, 512), (4, 21, 21), (12, 3, 6)])
def test_k1_sponge_chain_length(seg_len, nseg, perms):
    """Permutations one sponge row runs in sequence: ceil(L / 8) per tagged
    segment — the serial chain a one-row transcript absorb pays."""
    assert nseg * -(-seg_len // 8) == perms
    if seg_len * nseg > 100:        # the plain sponge counts the short ones
        return
    e = _t(_words(seg_len + nseg, (1, seg_len * nseg)))
    calls = []
    orig = K1.permute_plain

    def counting(s):
        calls.append(1)
        return orig(s)
    K1.permute_plain = counting
    try:
        K1.sponge_plain(None, e, seg_len, nseg)
    finally:
        K1.permute_plain = orig
    assert len(calls) == perms
