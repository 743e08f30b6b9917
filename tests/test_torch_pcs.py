"""K2 (NTT, RS encode) and K4 (modular matmul) plain versions and launch
plans, Merkle trees and PCS commitments of repro_torch against the JAX
package, exact equality."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import merkle as JM
from repro.core import mle as JMLE
from repro.core import ntt as JNTT
from repro.core import pcs as JPCS
from repro.kernels import ops as KOPS
from repro.kernels import ref as KREF
from repro_torch.core import field as F
from repro_torch.core import merkle as M
from repro_torch.core import mle as MLE
from repro_torch.core import ntt as NTT
from repro_torch.core import pcs as PCS
from repro_torch.kernels import modmatmul as K4
from repro_torch.kernels import ntt_kernel as K2

P = F.P


def _words(seed, shape):
    a = np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.int64)
    flat = a.reshape(-1)
    k = min(4, flat.size)
    flat[:k] = [0, 1, P - 1, P - 2][:k]
    return a.astype(np.uint32)


def _t(a):
    return F.tensor(a, "cpu")


@pytest.mark.parametrize("n", [2, 4, 8, 16, 32, 64, 128, 256, 512, 1024])
def test_k2_plain_matches_ntt(n):
    x = _words(n, (3, n))
    for inverse in (False, True):
        want = np.asarray(JNTT.ntt(jnp.asarray(x), inverse=inverse))
        assert np.array_equal(want, F.to_np(K2.ntt_rows_plain(_t(x), inverse)))
    assert np.array_equal(np.asarray(JNTT.rs_encode(jnp.asarray(x), 4)),
                          F.to_np(NTT.rs_encode(_t(x), 4)))


def test_merkle_roots_and_paths():
    leaves = _words(1, (13, 5))                 # 13 leaves: padded to 16
    jt, tt = JM.commit(jnp.asarray(leaves)), M.commit(_t(leaves))
    assert np.array_equal(np.asarray(jt.root), F.to_np(tt.root))
    for i in (0, 5, 12):
        jp, tp = JM.open_path(jt, i), M.open_path(tt, i)
        assert np.array_equal(jp.siblings, tp.siblings)
        assert M.verify_path(F.to_np(tt.root), leaves[i], tp, "cpu")
    idx = [3, 0, 7, 3, 12]
    jmp = JM.build_multiproof(jt, jnp.asarray(leaves), idx)
    tmp = M.build_multiproof(tt, _t(leaves), idx)
    for f in ("indices", "leaves", "nodes"):
        assert np.array_equal(getattr(jmp, f), getattr(tmp, f))
    ported = M.MerkleMultiProof(indices=jmp.indices, leaves=jmp.leaves,
                                nodes=jmp.nodes, depth=jmp.depth)
    assert M.verify_multiproof(F.to_np(tt.root), ported, "cpu")
    assert not M.verify_multiproof(F.to_np(tt.root), jmp, "cpu")  # foreign type
    bad = M.MerkleMultiProof(indices=jmp.indices, leaves=jmp.leaves,
                             nodes=jmp.nodes[:-1], depth=jmp.depth)
    assert not M.verify_multiproof(F.to_np(tt.root), bad, "cpu")
    batch = _words(2, (3, 8, 4))
    for jtree, ttree in zip(JM.commit_batch(jnp.asarray(batch)),
                            M.commit_batch(_t(batch))):
        assert np.array_equal(np.asarray(jtree.root), F.to_np(ttree.root))


@pytest.fixture(scope="module")
def params():
    return JPCS.PCSParams(blowup=4, queries=8), PCS.PCSParams(blowup=4, queries=8)


def test_pcs_commit_and_commit_batch_roots(params):
    jp, tp = params
    vec = _words(3, (200,))
    assert np.array_equal(JPCS.commit(jnp.asarray(vec), jp).root,
                          PCS.commit(_t(vec), tp).root)
    vecs = [_words(4 + i, (100,)) for i in range(3)]
    for jc, tc in zip(JPCS.commit_batch([jnp.asarray(v) for v in vecs], jp),
                      PCS.commit_batch([_t(v) for v in vecs], tp)):
        assert np.array_equal(jc.root, tc.root)
        assert np.array_equal(np.asarray(jc.enc), F.to_np(tc.enc))


@pytest.mark.parametrize("n_points", [1, 3])
def test_pcs_openings_without_kept_codewords(params, n_points):
    """A commitment that drops its codewords once its tree is built (the
    setup's LogUp helper) has the same root and opens to the same bundle,
    its queried columns encoded again, as one that keeps them; the
    transcripts end in the same state."""
    from repro_torch.core.transcript import Transcript
    _, tp = params
    vec = _t(_words(21, (1000,)))
    kept = PCS.commit(vec, tp)
    lean = PCS.commit(vec, tp, keep_codewords=False)
    assert lean.enc is None and kept.enc is not None
    assert np.array_equal(kept.root, lean.root)
    m = kept.log_r + kept.log_c
    pts = [_t(_words(30 + i, (m, 4))) for i in range(n_points)]
    bundles, states = [], []
    for com in (kept, lean):
        tr = Transcript("open", "cpu")
        bundles.append(PCS.prove_openings(com, pts, tr, tp))
        states.append(F.to_np(tr.state))
    a, b = bundles
    assert np.array_equal(states[0], states[1])
    assert np.array_equal(a.us, b.us) and np.array_equal(a.columns, b.columns)
    assert (a.u_prox is None) == (b.u_prox is None)
    if a.u_prox is not None:
        assert np.array_equal(a.u_prox, b.u_prox)
    assert [p.index for p in a.paths] == [p.index for p in b.paths]
    assert all(np.array_equal(p.siblings, q.siblings)
               for p, q in zip(a.paths, b.paths))


def test_k4_plain_matches_modmatmul_ref():
    a, b = _words(5, (4, 32)), _words(6, (32, 16))
    want = np.asarray(KREF.modmatmul_ref(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(want, F.to_np(K4.modmatmul_plain(_t(a), _t(b))))
    assert np.array_equal(want, F.to_np(K4.modmatmul(_t(a), _t(b))))


def test_k4_partial_eval_rows_mm():
    mat, r = _words(7, (8, 16)), _words(8, (3, 4))
    want = np.asarray(KOPS.partial_eval_rows_mm(jnp.asarray(mat), jnp.asarray(r)))
    assert np.array_equal(want, F.to_np(K4.partial_eval_rows_mm(_t(mat), _t(r))))
    assert np.array_equal(
        np.asarray(JMLE.partial_eval_rows(jnp.asarray(mat), jnp.asarray(r))),
        F.to_np(MLE.partial_eval_rows(_t(mat), _t(r))))


def test_mle_helpers():
    v, r, r4 = _words(9, (32,)), _words(10, (5, 4)), _words(11, (32, 4))
    assert np.array_equal(np.asarray(JMLE.eq_points(jnp.asarray(r))),
                          F.to_np(MLE.eq_points(_t(r))))
    assert np.array_equal(np.asarray(JMLE.mle_eval_base(jnp.asarray(v), jnp.asarray(r))),
                          F.to_np(MLE.mle_eval_base(_t(v), _t(r))))
    assert np.array_equal(np.asarray(JMLE.mle_eval_f4(jnp.asarray(r4), jnp.asarray(r))),
                          F.to_np(MLE.mle_eval_f4(_t(r4), _t(r))))
    rho = _words(12, (5, 4))
    assert np.array_equal(np.asarray(JMLE.eq_eval(jnp.asarray(r), jnp.asarray(rho))),
                          F.to_np(MLE.eq_eval(_t(r), _t(rho))))
    mat = _words(13, (4, 8))
    assert np.array_equal(
        np.asarray(JMLE.partial_eval_cols(jnp.asarray(mat), jnp.asarray(r[:3]))),
        F.to_np(MLE.partial_eval_cols(_t(mat), _t(r[:3]))))


@pytest.mark.parametrize("blowup", [1, 2, 4, 8])
@pytest.mark.parametrize("c", [1, 2, 8, 512])
def test_k2_rs_encode_matches_jax(c, blowup):
    """The RS entry (unpadded rows in) equals the JAX package's pad-then-NTT
    encode, through the wrapper and through core.ntt.rs_encode."""
    x = _words(100 * c + blowup, (2, c))
    want = np.asarray(JNTT.rs_encode(jnp.asarray(x), blowup))
    assert np.array_equal(want, F.to_np(K2.rs_encode_rows(_t(x), blowup)))
    assert np.array_equal(want, F.to_np(NTT.rs_encode(_t(x), blowup)))


def test_k2_stage_table():
    """The kernel's twiddles: row 2^s + j holds w_{2^(s+1)}^j as a plain
    residue (w_m = g^((P - 1) / m) for the generator g) and its Shoup
    quotient floor(w 2^32 / P); the Shoup product x w - floor(x w' / 2^32) P
    reduced once equals the Montgomery product with the JAX package's
    Montgomery twiddles."""
    rng = np.random.default_rng(3)
    for n in (2, 8, 4096):
        for inverse in (False, True):
            W = K2.stage_table(n, inverse)
            assert W.shape == (n, 2) and W.dtype == np.uint32
            for s in range(n.bit_length() - 1):
                w = pow(F.GENERATOR, (P - 1) >> (s + 1), P)
                if inverse:
                    w = pow(w, P - 2, P)
                for j in sorted({0, min(1, (1 << s) - 1), (1 << s) - 1}):
                    wj, wq = int(W[(1 << s) + j, 0]), int(W[(1 << s) + j, 1])
                    assert wj == pow(w, j, P) and wq == (wj << 32) // P
                    for x in [0, 1, P - 1, P - 2, *rng.integers(0, 2**32, 4)]:
                        r = (int(x) * wj - ((int(x) * wq) >> 32) * P) % 2**32
                        assert r < 2 * P
                        r = r - P if r >= P else r
                        assert r == int(x) * wj % P == (
                            int(x) * (wj * 2**32 % P) * F.R_INV % P)


# K2 and K4 calls of one attest of chip_smoke.py's served chain (4 gpt2
# layers at d=128, 16 PCS queries), as its serve phase counts them: K2 by
# (rows, n, c), K4 by (M, K, N).  A copy, not a count.
_ATTEST_K2 = {(1024, 4096, 1024): 4, (256, 2048, 512): 4, (160, 256, 64): 1}
_ATTEST_K4 = {(4, 1024, 1024): 4, (4, 512, 1024): 4, (4, 256, 512): 4,
              (4, 32, 64): 8}
_WEIGHT_K4 = (4, 512, 1024)
_HELPER_K4 = (4, 1024, 1024)


@pytest.mark.parametrize("K", [1, 3, 33, 256, 512, 1024, 1025, 4096])
def test_k4_plan_covers_k(K):
    """A block's walk over K as the kernel makes it (row slot s of the
    block's warps x 16 takes the row pairs s, s + slots, ...; a pair is rows
    2p and 2p + 1, which share one reduction) reaches every k exactly once;
    whole warps, at most 8, none without a pair; at most 8 rows of A a
    block, and a block for every 4 columns and every mt rows."""
    for M, N in ((4, 1024), (4, 512), (4, 64), (1, 3), (11, 70), (64, 4)):
        pl = K4.plan(M, K, N)
        pairs = -(-K // 2)
        slots = pl.threads // 32 * K4.SLOTS_PER_WARP
        seen = np.zeros(K, dtype=np.int64)
        for slot in range(slots):
            for p in range(slot, pairs, slots):
                seen[[k for k in (2 * p, 2 * p + 1) if k < K]] += 1
        assert np.array_equal(seen, np.ones(K, dtype=np.int64))
        assert pl.threads % 32 == 0 and 32 <= pl.threads <= 256
        assert (pl.threads // 32 - 1) * K4.SLOTS_PER_WARP < max(pairs, 1)
        assert pl.mt in (1, 2, 4, 8) and pl.mt >= min(M, 8)
        assert pl.blocks == -(-N // K4.COLS) * -(-M // pl.mt)


def test_k4_plan_fills_the_card_at_the_attest_shapes():
    """At the weight and helper shapes each of the H100's 132 SMs gets a
    block; an attest makes 20 K4 calls and 9 K2 calls, one launch each."""
    assert sum(_ATTEST_K4.values()) == 20 and sum(_ATTEST_K2.values()) == 9
    for shape in (_WEIGHT_K4, _HELPER_K4):
        assert shape in _ATTEST_K4
        assert K4.plan(*shape).blocks >= 132


def test_k2_plan_single_launch_up_to_2_15():
    """Rows up to 2^15 words keep one launch and their packing; the attest
    shapes at d=128 among them."""
    for (rows, n, c) in _ATTEST_K2:
        pl = K2.plan(n, c)
        assert (pl.split, pl.launches) == (0, 1)
        assert pl.rows_per_block == K2.rows_per_block(n)
    for lg in range(1, 16):
        n = 1 << lg
        for c in {n, max(1, n // 4)}:
            pl = K2.plan(n, c)
            assert pl.split == 0 and pl.launches == 1
            assert pl.shared_bytes <= K2.MAX_SHARED_BYTES


@pytest.mark.parametrize("lg", [16, 17, 18, 20])
def test_k2_plan_long_rows(lg):
    """Longer rows: 2^k blocks of 2^15 words and a second launch for the
    top k stages; past 2^20 words, or a message shorter than 2^k, raises."""
    n = 1 << lg
    for c in (n, n // 4, n // 8):
        pl = K2.plan(n, c)
        assert pl.split == lg - 15 and pl.launches == 2
        assert pl.rows_per_block == 1
        assert pl.shared_bytes == 4 * ((1 << 15) + ((c >> pl.split) if c < n else 0))
        assert pl.shared_bytes <= K2.MAX_SHARED_BYTES
    with pytest.raises(ValueError):
        K2.plan(n, (1 << (lg - 15)) // 2)
    with pytest.raises(ValueError):
        K2.plan(1 << 21, 1 << 21)


def _bitrev_t(n):
    return torch.as_tensor(NTT._bitrev(n))


def _dit(x, W, inverse_scale=None):
    """Every DIT stage of a natural-order (rows, m) array with the stage
    table W ((>= m, 2) u32 plain residues): bit-reverse, then stage s pairs
    positions 2^s apart with twiddle W[2^s + j]."""
    rows, m = x.shape
    x = x[:, _bitrev_t(m)]
    Wt = torch.as_tensor(W[:, 0].astype(np.int64))
    for s in range(m.bit_length() - 1):
        h = 1 << s
        xe = x.reshape(rows, m // (2 * h), 2, h)
        lo, hi = xe[:, :, 0, :], xe[:, :, 1, :]
        t = hi * Wt[h:2 * h] % P
        x = torch.stack([(lo + t) % P, (lo - t) % P], dim=2).reshape(rows, m)
    return x


def _long_row_schedule(msg, n, inverse=False):
    """K2's two launches for a long row, transliterated to torch: launch 1
    takes virtual row v = r 2^k + b to be the words b' + j 2^k of row r's
    (zero-padded) message, b' = rev_k(b), transforms it as a 2^15-word row
    with the first 2^15 rows of the n-word stage table (no n^-1 scaling)
    and writes it to words b 2^15 .. of output row r; launch 2 runs stages
    15 .. 14 + k on the words 2^15 apart, then scales an inverse."""
    rows, c = msg.shape
    pl = K2.plan(n, c)
    k, m = pl.split, n >> pl.split
    B = 1 << k
    W = K2.stage_table(n, inverse)
    sub = msg.reshape(rows, c // B, B)[:, :, _bitrev_t(B)]
    sub = sub.transpose(1, 2).reshape(rows * B, c // B)
    sub = torch.nn.functional.pad(sub, (0, m - c // B))      # the encode's copies
    y = _dit(sub, W).reshape(rows, B, m)
    Wt = torch.as_tensor(W[:, 0].astype(np.int64))
    for s in range(k):
        h = 1 << s
        ye = y.reshape(rows, B // (2 * h), 2, h, m)
        lo, hi = ye[:, :, 0], ye[:, :, 1]
        w = Wt[(m << s) + torch.arange(h * m)].reshape(h, m)
        t = hi * w % P
        y = torch.stack([(lo + t) % P, (lo - t) % P], dim=2).reshape(rows, B, m)
    y = y.reshape(rows, n)
    if inverse:
        y = F.fmul(y, F.mont_int(pow(n, P - 2, P)))
    return y


@pytest.mark.parametrize("lg", [16, 17])
def test_k2_long_row_schedule_matches_plain(lg):
    """The long-row schedule equals the plain transform both ways and the
    RS encode at blowups 4 and 8, word for word."""
    n = 1 << lg
    x = _t(_words(lg, (1, n)))
    for inv in (False, True):
        assert torch.equal(_long_row_schedule(x, n, inv),
                           K2.ntt_rows_plain(x, inv))
    for blowup in (4, 8):
        msg = _t(_words(lg + blowup, (2, n // blowup)))
        assert torch.equal(_long_row_schedule(msg, n),
                           K2.rs_encode_rows_plain(msg, blowup))


@pytest.mark.parametrize("batch", [1 << 22, 8])
def test_build_e_vec_matches_jax(monkeypatch, batch):
    """The gamma-folded eq vector of claims on slices of several lengths
    (two on one slice, one on the whole vector) equals the JAX package's,
    batched and, with the batch bound below every bucket, one eq table at
    a time added in place (the path of a TinyLlama-width commitment)."""
    from repro_torch.core import circuit as CC
    monkeypatch.setattr(PCS, "E_VEC_BATCH", batch)
    m = 6
    rng = np.random.default_rng(9)
    pts = []
    for npfx, idx in ((2, 1), (2, 1), (3, 5), (0, 0), (2, 3)):
        suf = _words(int(rng.integers(1 << 20)), (m - npfx, 4))
        pfx = CC._const_bits_point(idx, npfx).astype(np.uint32)
        pts.append(np.concatenate([pfx, suf]).astype(np.uint32))
    gamma = _words(77, (4,))
    want = np.asarray(JPCS._build_e_vec(1 << m, pts, jnp.asarray(gamma)))
    got = F.to_np(PCS._build_e_vec(1 << m, pts, _t(gamma)))
    assert np.array_equal(want, got)
