// K3 — fused sum-check rounds for K independent claims.
//
// Replaces the Pallas kernel src/repro/kernels/sumcheck_round.py
// (_round_kernel / _round_math, driven by _launch_round and prove_rounds).
//
// Each round needs g(0..d) = sum over the half-length of prod_t factor_t(X)
// before the Fiat-Shamir challenge exists, and the fold needs that
// challenge.  On the TPU one sequential grid saw the whole reduction; here
// blocks cannot see each other, so a round is three launches on one
// stream, with no host synchronisation between them or between rounds:
//   (a) partial_kernel — grid (nblocks, K): each block sums its share of
//       the g(e) products and writes one partial per block;
//   (b) absorb_kernel — one block per claim: reduces the partials, stores
//       g, absorbs it into the claim's sponge row with the schedule of
//       core/transcript.absorb (length tag, RATE chunks, one permutation
//       per chunk), squeezes the Fp4 challenge with one more permutation;
//   (c) fold_kernel — grid (half/256, K): f_t <- lo + c (hi - lo).
// Bound on this card: bytes.  A round reads 8*4*d*n bytes of int64 factors
// and writes half of that, against about 4 (d + 1) Fp4 products per pair;
// the launches of (b), and the per-round launch latency, dominate for the
// short claims of the main path.
#include <cuda_runtime.h>
#include <cstdint>

#include "field.cuh"
#include "poseidon2.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxD = 3;

// f layout: (d, K, n, 4) int64.
template <int D>
__global__ void partial_kernel(const int64_t* __restrict__ f, long K, long n,
                               int nblocks, int64_t* __restrict__ partial) {
  __shared__ uint32_t sh[kThreads * (kMaxD + 1) * 4];
  const long k = blockIdx.y;
  const long half = n / 2;
  bb::f4 acc[D + 1];
#pragma unroll
  for (int e = 0; e <= D; ++e) acc[e] = bb::f4_zero();
  for (long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x; i < half;
       i += static_cast<long>(nblocks) * blockDim.x) {
    bb::f4 cur[D], df[D];
#pragma unroll
    for (int t = 0; t < D; ++t) {
      const int64_t* base = f + ((t * K + k) * n) * 4;
      cur[t] = bb::f4_load(base + i * 4);
      df[t] = bb::f4_sub(bb::f4_load(base + (i + half) * 4), cur[t]);
    }
#pragma unroll
    for (int e = 0; e <= D; ++e) {
      if (e > 0) {
#pragma unroll
        for (int t = 0; t < D; ++t) cur[t] = bb::f4_add(cur[t], df[t]);
      }
      bb::f4 prod = cur[0];
#pragma unroll
      for (int t = 1; t < D; ++t) prod = bb::f4_mul(prod, cur[t]);
      acc[e] = bb::f4_add(acc[e], prod);
    }
  }
  const int w = (D + 1) * 4;
#pragma unroll
  for (int e = 0; e <= D; ++e)
#pragma unroll
    for (int c = 0; c < 4; ++c) sh[threadIdx.x * w + e * 4 + c] = acc[e].c[c];
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s)
      for (int j = 0; j < w; ++j)
        sh[threadIdx.x * w + j] = bb::add(sh[threadIdx.x * w + j], sh[(threadIdx.x + s) * w + j]);
    __syncthreads();
  }
  if (threadIdx.x < w)
    partial[(k * nblocks + blockIdx.x) * w + threadIdx.x] = sh[threadIdx.x];
}

template <int D>
__global__ void absorb_kernel(const int64_t* __restrict__ partial, int nblocks,
                              int64_t* __restrict__ states,
                              int64_t* __restrict__ rp, int64_t* __restrict__ cs,
                              int round, int m, uint32_t tag_m) {
  if (threadIdx.x != 0) return;
  const long k = blockIdx.x;
  constexpr int w = (D + 1) * 4;
  uint32_t g[w];
#pragma unroll
  for (int j = 0; j < w; ++j) g[j] = 0u;
  for (int b = 0; b < nblocks; ++b)
#pragma unroll
    for (int j = 0; j < w; ++j)
      g[j] = bb::add(g[j], static_cast<uint32_t>(partial[(k * nblocks + b) * w + j]));
  int64_t* rp_row = rp + ((k * m + round) * w);
#pragma unroll
  for (int j = 0; j < w; ++j) rp_row[j] = g[j];
  uint32_t s[p2::WIDTH];
#pragma unroll
  for (int i = 0; i < p2::WIDTH; ++i) s[i] = static_cast<uint32_t>(states[k * p2::WIDTH + i]);
  s[p2::RATE] = bb::add(s[p2::RATE], tag_m);
#pragma unroll
  for (int c = 0; c < w; c += p2::RATE) {
#pragma unroll
    for (int j = 0; j < p2::RATE; ++j)
      if (c + j < w) s[j] = bb::add(s[j], g[c + j]);
    p2::permute(s);
  }
  p2::permute(s);                               // challenge squeeze
#pragma unroll
  for (int j = 0; j < 4; ++j) cs[(k * m + round) * 4 + j] = s[j];
#pragma unroll
  for (int i = 0; i < p2::WIDTH; ++i) states[k * p2::WIDTH + i] = s[i];
}

template <int D>
__global__ void fold_kernel(const int64_t* __restrict__ f, long K, long n,
                            const int64_t* __restrict__ cs, int round, int m,
                            int64_t* __restrict__ out) {
  const long k = blockIdx.y;
  const long half = n / 2;
  const long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
  if (i >= half) return;
  const bb::f4 c = bb::f4_load(cs + (k * m + round) * 4);
#pragma unroll
  for (int t = 0; t < D; ++t) {
    const int64_t* base = f + ((t * K + k) * n) * 4;
    bb::f4 lo = bb::f4_load(base + i * 4);
    bb::f4 hi = bb::f4_load(base + (i + half) * 4);
    bb::f4 r = bb::f4_add(lo, bb::f4_mul(c, bb::f4_sub(hi, lo)));
    bb::f4_store(out + ((t * K + k) * half + i) * 4, r);
  }
}

template <int D>
int launch_round(const int64_t* f, long K, long n, int64_t* partial,
                 int nblocks, int64_t* states, int64_t* rp, int64_t* cs,
                 int round, int m, uint32_t tag_m, int64_t* out,
                 cudaStream_t st) {
  const long half = n / 2;
  partial_kernel<D><<<dim3(nblocks, static_cast<unsigned>(K)), kThreads, 0, st>>>(
      f, K, n, nblocks, partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  absorb_kernel<D><<<static_cast<unsigned>(K), 32, 0, st>>>(
      partial, nblocks, states, rp, cs, round, m, tag_m);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  unsigned gx = static_cast<unsigned>((half + kThreads - 1) / kThreads);
  fold_kernel<D><<<dim3(gx, static_cast<unsigned>(K)), kThreads, 0, st>>>(
      f, K, n, cs, round, m, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int sc_set_constants(const uint32_t* rcf, const uint32_t* rcp,
                     const uint32_t* diag) {
  return static_cast<int>(p2::upload_constants(rcf, rcp, diag));
}

// One round for K claims of d factors of length n (three launches).
int sc_round(const int64_t* f, long K, long n, int d, int64_t* partial,
             int nblocks, int64_t* states, int64_t* rp, int64_t* cs, int round,
             int m, uint32_t tag_m, int64_t* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return launch_round<1>(f, K, n, partial, nblocks, states, rp, cs, round, m, tag_m, out, st);
    case 2: return launch_round<2>(f, K, n, partial, nblocks, states, rp, cs, round, m, tag_m, out, st);
    case 3: return launch_round<3>(f, K, n, partial, nblocks, states, rp, cs, round, m, tag_m, out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
