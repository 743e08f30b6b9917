// Width-16 Poseidon2 permutation over BabyBear, one state per thread held
// in 16 registers for all 21 rounds.  Shared by the K1 (poseidon2.cu) and
// K3 (sumcheck_round.cu) kernels.  Round constants and the internal
// diagonal (Montgomery words) live in __constant__ memory; each shared
// library sets its own copy once, from the port's Python constants
// (repro_torch.core.poseidon2), through p2_upload_constants.
#pragma once
#include <cuda_runtime.h>
#include "field.cuh"

namespace p2 {

constexpr int WIDTH = 16;
constexpr int RATE = 8;
constexpr int RF = 8;
constexpr int RP = 13;

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

// M4 = [[5,7,1,3],[4,6,1,1],[1,3,5,7],[1,1,4,6]] by additions only.
__device__ __forceinline__ void m4(uint32_t* x) {
  uint32_t t0 = bb::add(x[0], x[1]);
  uint32_t t1 = bb::add(x[2], x[3]);
  uint32_t t2 = bb::add(dbl(x[1]), t1);
  uint32_t t3 = bb::add(dbl(x[3]), t0);
  uint32_t t4 = bb::add(dbl(dbl(t1)), t3);
  uint32_t t5 = bb::add(dbl(dbl(t0)), t2);
  uint32_t t6 = bb::add(t3, t5);
  uint32_t t7 = bb::add(t2, t4);
  x[0] = t6;
  x[1] = t5;
  x[2] = t7;
  x[3] = t4;
}

__device__ __forceinline__ void external_linear(uint32_t* s) {
#pragma unroll
  for (int b = 0; b < 4; ++b) m4(s + 4 * b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t tot = bb::add(bb::add(s[i], s[4 + i]), bb::add(s[8 + i], s[12 + i]));
#pragma unroll
    for (int b = 0; b < 4; ++b) s[4 * b + i] = bb::add(s[4 * b + i], tot);
  }
}

__device__ __forceinline__ void internal_linear(uint32_t* s) {
  uint32_t tot = s[0];
#pragma unroll
  for (int i = 1; i < WIDTH; ++i) tot = bb::add(tot, s[i]);
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = bb::add(bb::mul(s[i], c_diag[i]), tot);
}

__device__ __forceinline__ void full_round(uint32_t* s, int r) {
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = sbox(bb::add(s[i], c_rc_full[r * WIDTH + i]));
  external_linear(s);
}

__device__ __forceinline__ void permute(uint32_t* s) {
  external_linear(s);
#pragma unroll 1
  for (int r = 0; r < RF / 2; ++r) full_round(s, r);
#pragma unroll 1
  for (int r = 0; r < RP; ++r) {
    s[0] = sbox(bb::add(s[0], c_rc_part[r]));
    internal_linear(s);
  }
#pragma unroll 1
  for (int r = RF / 2; r < RF; ++r) full_round(s, r);
}

}  // namespace p2
