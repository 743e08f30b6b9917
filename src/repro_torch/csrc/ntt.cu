// K2 — batched radix-2 NTT along rows (Reed-Solomon row encoding).
//
// Replaces the Pallas kernel src/repro/kernels/ntt_kernel.py
// (_kernel / ntt_rows), whose wrapper bit-reversed each row on the host.
//
// Bound on this card: bytes for long rows, launch latency for the short
// rows of the main path.  An n-point transform does (n/2) log2 n Montgomery
// products on 8n bytes of int64 input and output, about 1.3 products per
// byte moved, far below what the integer pipes sustain per byte of HBM
// bandwidth.  So the design reads each row once, bit-reversing on the
// load, keeps the row in shared memory through all log2 n stages (one
// __syncthreads between stages), and writes it once.  Short rows (the
// commitments of the main path are 4 * 2^k wide) are packed several to a
// block so that a block still has work for all its threads.
#include <cuda_runtime.h>
#include <cstdint>

#include "field.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void ntt_kernel(const int64_t* __restrict__ in,
                           int64_t* __restrict__ out,
                           const int64_t* __restrict__ tw, long rows, int n,
                           int log_n, int rows_per_block, int inverse,
                           uint32_t n_inv_m) {
  extern __shared__ uint32_t sh[];
  const long row0 = static_cast<long>(blockIdx.x) * rows_per_block;
  const long rem = rows - row0;
  const int nrows = rem < rows_per_block ? static_cast<int>(rem) : rows_per_block;
  const int total = nrows * n;
  // load, bit-reversed within each row: sh[r][rev(i)] = in[r][i]
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    int r = t / n;
    int i = t - r * n;
    int j = static_cast<int>(__brev(static_cast<unsigned>(i)) >> (32 - log_n));
    sh[r * n + j] = static_cast<uint32_t>(in[(row0 + r) * n + i]);
  }
  __syncthreads();
  const int half_total = total / 2;
  for (int s = 0; s < log_n; ++s) {
    const int half = 1 << s;
    const int stride = n >> (s + 1);
    for (int t = threadIdx.x; t < half_total; t += blockDim.x) {
      int r = t / (n / 2);
      int b = t - r * (n / 2);
      int grp = b >> s;
      int j = b & (half - 1);
      int lo = r * n + grp * 2 * half + j;
      int hi = lo + half;
      uint32_t w = static_cast<uint32_t>(tw[j * stride]);
      uint32_t x = sh[lo];
      uint32_t y = bb::mul(sh[hi], w);
      sh[lo] = bb::add(x, y);
      sh[hi] = bb::sub(x, y);
    }
    __syncthreads();
  }
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    uint32_t v = sh[t];
    if (inverse) v = bb::mul(v, n_inv_m);
    out[row0 * n + t] = v;
  }
}

}  // namespace

extern "C" {

// Largest dynamic shared memory a block may use on sm_90.
int ntt_max_shared_bytes() { return 232448; }

int ntt_rows(const int64_t* in, int64_t* out, const int64_t* tw, long rows,
             int n, int log_n, int rows_per_block, int inverse,
             uint32_t n_inv_m, void* stream) {
  if (rows == 0) return 0;
  size_t shmem = sizeof(uint32_t) * static_cast<size_t>(n) * rows_per_block;
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ntt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  unsigned grid = static_cast<unsigned>((rows + rows_per_block - 1) / rows_per_block);
  ntt_kernel<<<grid, kThreads, shmem, static_cast<cudaStream_t>(stream)>>>(
      in, out, tw, rows, n, log_n, rows_per_block, inverse, n_inv_m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
