"""The work the protocol needs, counted from shapes, and the card's peaks.

Every function counts what the algorithm needs for its inputs: modular
products (one Montgomery product of two BabyBear words is one operation)
and bytes, each input word read once and each output word written once at
4 bytes a word (a BabyBear residue is 31 bits; the program keeps its words
in int64, which moves twice these bytes).  Nothing is counted from a
launch configuration, so the counts hold whatever computes them.

Peaks of one NVIDIA H100 SXM at its 700 W limit:
* ``HBM_BYTES_PER_S``: 3.35 TB/s, NVIDIA's H100 data sheet;
* ``INT32_OPS_PER_S``: 132 SMs x 64 INT32 lanes x 1.98 GHz, a peak
  derived from the SM count, the Hopper SM's INT32 lanes and the boost
  clock, not a data-sheet line; one 32-bit multiply a lane a clock.
"""
from __future__ import annotations

from typing import Dict, Tuple

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
WORD_BYTES = 4
# Poseidon2 (width 16, x^7): four products an S-box (8 full rounds x 16
# lanes + 13 partial rounds x 1) and 16 an internal linear layer.
PERM_MULS = 4 * (8 * 16 + 13) + 16 * 13
F4_MULS = 16           # an Fp4 product: the 4 x 4 outer product
WIDTH, RATE, DIGEST = 16, 8, 8

Work = Tuple[float, float]           # (modular products, bytes)


def bound_s(work: Work) -> float:
    """The least time the card could take: the larger of its operation
    and byte terms."""
    ops, nbytes = work
    return max(ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def _perms(perms: float, words_in: float, words_out: float) -> Work:
    return perms * PERM_MULS, (words_in + words_out) * WORD_BYTES


# ---------------------------------------------------------------------------
# K1 (Poseidon2), by entry point.
# ---------------------------------------------------------------------------
def k1_permute(n: int) -> Work:
    return _perms(n, n * WIDTH, n * WIDTH)


def k1_sponge(n: int, seg_len: int, nseg: int, out_width: int,
              has_init: bool) -> Work:
    """n rows of nseg segments of seg_len words, one permutation a
    RATE-word chunk of each segment."""
    perms = n * nseg * -(-seg_len // RATE)
    return _perms(perms, n * nseg * seg_len + (n * WIDTH if has_init else 0),
                  n * out_width)


def k1_squeeze(n: int, nblocks: int) -> Work:
    return _perms(n * nblocks, n * WIDTH, n * WIDTH + n * RATE * nblocks)


def k1_compress(n: int) -> Work:
    return _perms(n, 2 * n * DIGEST, n * DIGEST)


def k1_hash_rows(n: int, length: int) -> Work:
    return k1_sponge(n, length, 1, DIGEST, False)


# ---------------------------------------------------------------------------
# K2 (NTT / Reed-Solomon encode), K3 (sum-check rounds), K4 (modular matmul).
# ---------------------------------------------------------------------------
def k2_encode(rows: int, n: int, c: int) -> Work:
    """Encode rows x c message words into rows x n (c = n: the plain
    transform): read the message and the n-word twiddle table, write the
    codewords; the first log2(n / c) stages only copy, the other log2 c do
    n / 2 butterflies, one product each."""
    stages = c.bit_length() - 1
    return rows * (n // 2) * stages, (rows * c + n + rows * n) * WORD_BYTES


def k3_prove(d: int, n: int, K: int = 1) -> Work:
    """K claims of d Fp4 factors of length n through all log2 n rounds:
    read the factors and the sponge state, write the round polynomials,
    challenges, final evaluations and state; n - 1 pairs, each with
    (d + 1)(d - 1) + d Fp4 products, and the transcript's permutations."""
    m = n.bit_length() - 1
    perms = m * (-(-4 * (d + 1) // RATE) + 1) + -(-4 * d // RATE)
    words = d * n * 4 + WIDTH + m * (d + 1) * 4 + m * 4 + d * 4 + WIDTH
    ops = (n - 1) * ((d + 1) * (d - 1) + d) * F4_MULS + perms * PERM_MULS
    return K * ops, K * words * WORD_BYTES


def k4_modmatmul(M: int, K: int, N: int) -> Work:
    return M * K * N, (M * K + K * N + M * N) * WORD_BYTES


# ---------------------------------------------------------------------------
# One attestation.
# ---------------------------------------------------------------------------
def pow2(n: int) -> int:
    return 1 << max((n - 1).bit_length(), 0) if n > 1 else 1


def log2(n: int) -> int:
    return n.bit_length() - 1


def _limbs(n: int) -> int:
    return 2 * pow2(n)


def _ranged(n: int, bits: int) -> int:
    return ((bits + 7) // 8 + (1 if bits % 8 else 0)) * pow2(n)


def boundary_words(b: Dict) -> int:
    return pow2(_limbs(b["d_pad"] * b["seq"]))


def weight_words(b: Dict) -> int:
    d, qd, kv, ff = b["d_pad"], b["qd_pad"], b["kvd_pad"], b["dff_pad"]
    sizes = [qd * d, kv * d, kv * d, d * qd, ff * d, d * ff, d, d]
    if b["family"] == "gpt2":
        sizes += [qd, kv, kv, d, ff, d, d, d]
    else:
        sizes.append(ff * d)
    return pow2(sum(_limbs(n) for n in sizes))


def aux_words(b: Dict) -> int:
    """The packed words of a layer's witness trace: two 8-bit limbs of
    every 16-bit trace array, the 8-bit digits (and the top digit's
    scaled copy) of every bounded remainder, each padded to a power of
    two, as the layer argument declares them."""
    d, qd, kv, ff, seq = (b["d_pad"], b["qd_pad"], b["kvd_pad"], b["dff_pad"],
                          b["seq"])
    H, dr = b["heads"], b["d"]
    lc = (dr - 1).bit_length()
    bS = 12 + log2(seq)
    odd = dr & (dr - 1) != 0
    n = 0
    for _ in ("ln1", "ln2"):
        if b["family"] == "gpt2":
            n += _limbs(seq) + _ranged(seq, max(lc, 1))
            if odd:
                n += _ranged(seq, lc)
            n += _limbs(d * seq)
        n += _ranged(seq, 4 + lc) + (_ranged(seq, 4 + lc) if odd else 0)
        n += 2 * _ranged(seq, 16) + _limbs(d * seq) + _ranged(d * seq, 11)
        n += _limbs(d * seq) + _ranged(d * seq, 8)
    n += _limbs(qd * seq) + _ranged(qd * seq, 8)
    n += 2 * (_limbs(kv * seq) + _ranged(kv * seq, 8))
    if b["family"] == "llama":
        n += _limbs(qd * seq) + _ranged(qd * seq, 13)
        n += _limbs(kv * seq) + _ranged(kv * seq, 13)
    hs2 = H * seq * seq
    n += _limbs(hs2) + _ranged(hs2, 12) + _ranged(hs2, 12)
    n += _ranged(H * seq, bS) + _ranged(hs2, 9) + 2 * _ranged(hs2, bS + 1)
    n += _limbs(qd * seq) + _ranged(qd * seq, 8)
    n += _limbs(d * seq) + _ranged(d * seq, 8) + _limbs(d * seq)
    n += _limbs(ff * seq) + _ranged(ff * seq, 4) + _limbs(ff * seq)
    if b["family"] == "llama":
        n += 2 * (_limbs(ff * seq) + _ranged(ff * seq, 8))
    n += _ranged(d * seq, 8) + _limbs(d * seq)
    return pow2(n)


def commit_work(n: int, blowup: int) -> Work:
    """Commit an n-word vector: encode its R x C matrix to R x C blowup,
    hash each R-word column, build the Merkle tree over the columns."""
    m = log2(n)
    log_c = (m + 1) // 2
    R, C = 1 << (m - log_c), 1 << log_c
    cols = C * blowup
    return _add(k2_encode(R, cols, C), k1_hash_rows(cols, R),
                k1_compress(cols - 1))


def open_work(n: int) -> Work:
    """Open an n-word commitment at its folded claim: a degree-2
    sum-check over the n words and the row u = eq^T . mat, 4 products a
    word."""
    m = log2(n)
    R, C = 1 << (m - (m + 1) // 2), 1 << ((m + 1) // 2)
    return _add(k3_prove(2, n), k4_modmatmul(4, R, C))


def _add(*works: Work) -> Work:
    return sum(w[0] for w in works), sum(w[1] for w in works)


def attest_work(b: Dict, layers: int, blowup: int) -> Work:
    """The commitments and openings one attestation of every layer needs
    whose sizes the configuration fixes: the L + 1 boundary activations
    committed; each layer's witness trace committed; each layer's weight,
    input boundary, output boundary and trace commitments opened.  The
    LogUp helpers, the lookups' and gadgets' own sum-checks and the
    transcripts are not counted, so this is a lower bound of the
    protocol's modular products."""
    nb, nw, na = boundary_words(b), weight_words(b), aux_words(b)
    per_layer = _add(commit_work(na, blowup), open_work(nw),
                     open_work(nb), open_work(nb), open_work(na))
    ops = (layers + 1) * commit_work(nb, blowup)[0] + layers * per_layer[0]
    nbytes = (layers + 1) * commit_work(nb, blowup)[1] + layers * per_layer[1]
    return ops, nbytes
