// K5 — one sum-check round for one claim with a known challenge:
// g(0..d) together with the fold f_t <- lo + c (hi - lo).
//
// Replaces the Pallas kernel src/repro/kernels/sumcheck_fold.py (_kernel,
// driven by fold_round).  The TPU kernel walked 2048-row blocks on a
// sequential grid and left the per-block partial sums of g to the host
// wrapper.  Here:
//   (a) fold_kernel — grid-stride threads over the pair index i < n/2.
//       Each thread reads lo and hi of every factor once (the point of the
//       fused form), adds its products into g(0..d) in registers and writes
//       the folded words.  A shared-memory tree reduces g within the block
//       and one partial per block goes to device memory.
//   (b) reduce_kernel — one block sums the per-block partials into g.
// c stays on the device; nothing is read back.  Field sums are order-free,
// so any reduction order gives the same words as the plain version.
// Bound on this card: bytes.  A round reads 2 d n words and writes d n
// words (as u32: 12 d n bytes) against (d + 1)(d - 1) + d Fp4 products per
// pair; this kernel moves the int64 words the port stores, twice that.
#include <cuda_runtime.h>
#include <cstdint>

#include "field.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxD = 3;

struct Factors {
  const int64_t* f[kMaxD];
  int64_t* out[kMaxD];
};

template <int D>
__device__ void block_reduce_store(bb::f4 (&acc)[D + 1], uint32_t* sh,
                                   int64_t* dst) {
  constexpr int w = (D + 1) * 4;
#pragma unroll
  for (int e = 0; e <= D; ++e)
#pragma unroll
    for (int c = 0; c < 4; ++c) sh[threadIdx.x * w + e * 4 + c] = acc[e].c[c];
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s)
#pragma unroll
      for (int j = 0; j < w; ++j)
        sh[threadIdx.x * w + j] = bb::add(sh[threadIdx.x * w + j], sh[(threadIdx.x + s) * w + j]);
    __syncthreads();
  }
  if (threadIdx.x < w) dst[threadIdx.x] = sh[threadIdx.x];
}

template <int D>
__global__ void fold_kernel(Factors fs, long half, const int64_t* __restrict__ c_ptr,
                            int64_t* __restrict__ partial) {
  __shared__ uint32_t sh[kThreads * (kMaxD + 1) * 4];
  const bb::f4 c = bb::f4_load(c_ptr);
  bb::f4 acc[D + 1];
#pragma unroll
  for (int e = 0; e <= D; ++e) acc[e] = bb::f4_zero();
  for (long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x; i < half;
       i += static_cast<long>(gridDim.x) * blockDim.x) {
    bb::f4 cur[D], df[D];
#pragma unroll
    for (int t = 0; t < D; ++t) {
      cur[t] = bb::f4_load(fs.f[t] + i * 4);
      df[t] = bb::f4_sub(bb::f4_load(fs.f[t] + (i + half) * 4), cur[t]);
      bb::f4_store(fs.out[t] + i * 4, bb::f4_add(cur[t], bb::f4_mul(c, df[t])));
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
  block_reduce_store<D>(acc, sh, partial + blockIdx.x * (D + 1) * 4);
}

template <int D>
__global__ void reduce_kernel(const int64_t* __restrict__ partial, int nblocks,
                              int64_t* __restrict__ g) {
  __shared__ uint32_t sh[kThreads * (kMaxD + 1) * 4];
  constexpr int w = (D + 1) * 4;
  bb::f4 acc[D + 1];
#pragma unroll
  for (int e = 0; e <= D; ++e) acc[e] = bb::f4_zero();
  for (int b = threadIdx.x; b < nblocks; b += blockDim.x)
#pragma unroll
    for (int e = 0; e <= D; ++e)
      acc[e] = bb::f4_add(acc[e], bb::f4_load(partial + b * w + e * 4));
  block_reduce_store<D>(acc, sh, g);
}

template <int D>
int launch(const Factors& fs, long half, const int64_t* c, int64_t* partial,
           int nblocks, int64_t* g, cudaStream_t st) {
  fold_kernel<D><<<nblocks, kThreads, 0, st>>>(fs, half, c, partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_kernel<D><<<1, kThreads, 0, st>>>(partial, nblocks, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// d factors f0..f{d-1} of n = 2 half Fp4 words each (unused pointers may be
// null); c (4,); partial (nblocks, d+1, 4) scratch; g (d+1, 4); folded
// outputs o0..o{d-1} of half words each.  Two launches.
int sf_fold_round(const int64_t* f0, const int64_t* f1, const int64_t* f2,
                  int d, long half, const int64_t* c, int64_t* partial,
                  int nblocks, int64_t* g, int64_t* o0, int64_t* o1,
                  int64_t* o2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Factors fs{{f0, f1, f2}, {o0, o1, o2}};
  switch (d) {
    case 1: return launch<1>(fs, half, c, partial, nblocks, g, st);
    case 2: return launch<2>(fs, half, c, partial, nblocks, g, st);
    case 3: return launch<3>(fs, half, c, partial, nblocks, g, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
