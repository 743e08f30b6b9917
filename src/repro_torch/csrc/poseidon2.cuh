// Width-16 Poseidon2 permutation over BabyBear, one state held by 16 lanes
// of a warp, one word per lane (lane j of the half-warp holds s[j]); a warp
// holds two states.  Shared by the K1 (poseidon2.cu) and K3
// (sumcheck_round.cu) kernels.  Round constants and the internal diagonal
// (Montgomery words) live in __constant__ memory; each shared library sets
// its own copy once, from the port's Python constants
// (repro_torch.core.poseidon2), through p2_upload_constants.
//
// Every lane of the warp must call permute() together with the full mask:
// a lane with no state of its own computes on a zero state and its caller
// skips its stores.
//
// Critical path of one permutation (all 21 rounds unrolled, no branch):
//   external layer — M4 inside each group of 4 lanes (four width-4
//     shuffles; lanes 2 and 3 of a group take the words with the pairs
//     swapped, which turns rows 2, 3 of M4 into rows 0, 1, and row 0 is
//     row 1 plus one of its partial sums, so every lane runs the same
//     additions and one mask), then the column sums across the 4 groups
//     with two xor shuffles (4, 8);
//   full round — each lane adds its round constant and runs its S-box;
//   partial round — every lane runs the S-box (only lane 0's is kept), the
//     sum of lanes 1..15 is a 4-step xor reduction that overlaps it, lane
//     0's S-box output joins by one broadcast shuffle, then one diagonal
//     product and one add per lane.
// Each lane keeps its 8 full-round constants, its diagonal word (and that
// word times -P^-1, for bb::mul_pre) and its lane masks in registers
// (Lane::load, once per kernel): indexing __constant__ by lane inside the
// rounds would serialise 16 addresses.  The partial-round constants are
// uniform, a broadcast read.  The lane masks go through bb::opaque: from
// a visible "lane == 0" test the compiler splits the partial rounds into
// two divergent copies, one per side, and the warp runs both.
#pragma once
#include <cuda_runtime.h>
#include "field.cuh"

namespace p2 {

constexpr int WIDTH = 16;
constexpr int RATE = 8;
constexpr int RF = 8;
constexpr int RP = 13;
constexpr unsigned FULL = 0xffffffffu;

__constant__ uint32_t c_rc_full[RF * WIDTH];
__constant__ uint32_t c_rc_part[RP];
__constant__ uint32_t c_diag[WIDTH];

inline cudaError_t upload_constants(const uint32_t* rcf, const uint32_t* rcp,
                                    const uint32_t* diag) {
  cudaError_t e = cudaMemcpyToSymbol(c_rc_full, rcf, sizeof(uint32_t) * RF * WIDTH);
  if (e != cudaSuccess) return e;
  e = cudaMemcpyToSymbol(c_rc_part, rcp, sizeof(uint32_t) * RP);
  if (e != cudaSuccess) return e;
  return cudaMemcpyToSymbol(c_diag, diag, sizeof(uint32_t) * WIDTH);
}

__device__ __forceinline__ uint32_t sbox(uint32_t x) {
  uint32_t x2 = bb::mul(x, x);
  uint32_t x3 = bb::mul(x2, x);
  uint32_t x4 = bb::mul(x2, x2);
  return bb::mul(x4, x3);
}

__device__ __forceinline__ uint32_t dbl(uint32_t x) { return bb::add(x, x); }

// A lane's place in its state and its own constants.
struct Lane {
  int j;                 // 0..15: the state word this lane holds
  uint32_t rc[RF];       // c_rc_full[r][j], r = 0..7
  uint32_t diag;         // c_diag[j]
  uint32_t diag_n;       // diag (-P^-1) mod 2^32, for bb::mul_pre
  uint32_t swap;         // all ones on lanes 2, 3 of a group of 4
  uint32_t row0;         // all ones on lanes 0, 2 of a group (M4 rows 0, 2)
  uint32_t rest;         // all ones except on lane 0
  uint32_t cap;          // all ones on lane RATE (the length tag's lane)

  __device__ __forceinline__ static Lane load() {
    Lane l;
    l.j = threadIdx.x & (WIDTH - 1);
#pragma unroll
    for (int r = 0; r < RF; ++r) l.rc[r] = c_rc_full[r * WIDTH + l.j];
    l.diag = c_diag[l.j];
    l.diag_n = l.diag * bb::NEG_P_INV;
    l.swap = bb::opaque((l.j & 2) ? ~0u : 0u);
    l.row0 = bb::opaque((l.j & 1) ? 0u : ~0u);
    l.rest = bb::opaque(l.j == 0 ? 0u : ~0u);
    l.cap = bb::opaque(l.j == RATE ? ~0u : 0u);
    return l;
  }
};

// x's value in each lane of the state, summed with a 16-lane xor butterfly.
__device__ __forceinline__ uint32_t sum16(uint32_t x) {
#pragma unroll
  for (int o = 1; o < WIDTH; o <<= 1) x = bb::add(x, __shfl_xor_sync(FULL, x, o, WIDTH));
  return x;
}

__device__ __forceinline__ uint32_t pick_mask(uint32_t a, uint32_t b, uint32_t m) {
  return (a & ~m) | (b & m);                   // b where m is set, else a
}

// M4 = [[5,7,1,3],[4,6,1,1],[1,3,5,7],[1,1,4,6]] by additions, then each
// 4-lane group adds the column sums over the 4 groups.  With (a0..a3) the
// group's words, pairs swapped on lanes 2, 3: row 1 = 4 a0 + 6 a1 + a2 + a3
// = t5 and row 0 = t5 + t3 (t3 = a0 + a1 + 2 a3).
__device__ __forceinline__ uint32_t external_linear(uint32_t s, const Lane& l) {
  const uint32_t x0 = __shfl_sync(FULL, s, 0, 4);
  const uint32_t x1 = __shfl_sync(FULL, s, 1, 4);
  const uint32_t x2 = __shfl_sync(FULL, s, 2, 4);
  const uint32_t x3 = __shfl_sync(FULL, s, 3, 4);
  const uint32_t a0 = pick_mask(x0, x2, l.swap), a1 = pick_mask(x1, x3, l.swap);
  const uint32_t a2 = pick_mask(x2, x0, l.swap), a3 = pick_mask(x3, x1, l.swap);
  const uint32_t t0 = bb::add(a0, a1);
  const uint32_t t1 = bb::add(a2, a3);
  const uint32_t t2 = bb::add(dbl(a1), t1);
  const uint32_t t3 = bb::add(dbl(a3), t0);
  const uint32_t t5 = bb::add(dbl(dbl(t0)), t2);
  const uint32_t y = bb::add(t5, t3 & l.row0);
  uint32_t tot = bb::add(y, __shfl_xor_sync(FULL, y, 4, WIDTH));
  tot = bb::add(tot, __shfl_xor_sync(FULL, tot, 8, WIDTH));
  return bb::add(y, tot);
}

__device__ __forceinline__ uint32_t permute(uint32_t s, const Lane& l) {
  s = external_linear(s, l);
#pragma unroll
  for (int r = 0; r < RF / 2; ++r) s = external_linear(sbox(bb::add(s, l.rc[r])), l);
#pragma unroll
  for (int r = 0; r < RP; ++r) {
    const uint32_t sb = sbox(bb::add(s, c_rc_part[r]));
    const uint32_t rest = sum16(s & l.rest);
    const uint32_t s0 = pick_mask(sb, s, l.rest);
    const uint32_t tot = bb::add(rest, __shfl_sync(FULL, sb, 0, WIDTH));
    s = bb::add(bb::mul_pre(s0, l.diag, l.diag_n), tot);
  }
#pragma unroll
  for (int r = RF / 2; r < RF; ++r) s = external_linear(sbox(bb::add(s, l.rc[r])), l);
  return s;
}

// The word words[idx] of a small register array, by a chain of selects (a
// lane-dependent index into registers would otherwise go to local memory).
template <int N>
__device__ __forceinline__ uint32_t pick(const uint32_t (&words)[N], int idx) {
  uint32_t v = 0u;
#pragma unroll
  for (int q = 0; q < N; ++q) v = q == idx ? words[q] : v;
  return v;
}

// Absorb N words that every lane holds (words[0..N)) into the lane's state
// with the schedule of core/transcript.absorb: the length tag (Montgomery
// N) added to lane RATE, then RATE-word chunks, zero-padded, one
// permutation per chunk.
template <int N>
__device__ __forceinline__ uint32_t absorb(uint32_t s, const uint32_t (&words)[N],
                                           uint32_t tag_m, const Lane& l) {
  s = bb::add(s, tag_m & l.cap);
#pragma unroll
  for (int c = 0; c < N; c += RATE) {
    const int idx = l.j < RATE ? c + l.j : N;     // N: no word (zero)
    s = permute(bb::add(s, pick(words, idx)), l);
  }
  return s;
}

}  // namespace p2
