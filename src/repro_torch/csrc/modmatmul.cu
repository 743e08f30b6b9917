// K4 — skinny modular matmul C = A @ B mod P on Montgomery operands.
//
// Replaces the Pallas kernel src/repro/kernels/modmatmul.py
// (_kernel / modmatmul), used through kernels/ops.partial_eval_rows_mm for
// the PCS opening row u = eq^T . mat (M = 4: the Fp4 coefficient rows of
// eq^T; K = R and N = C of the commitment matrix).
//
// Bound on this card: bytes.  Each element of B (the commitment matrix) is
// read once and takes part in M = 4 products, far too few operations per
// byte to keep the integer pipes busy.  A block covers 32 output columns
// with 16 lanes along K: each lane walks a contiguous chunk of K rows of
// its column (the 32 threads of a warp read 32 neighbouring words, so each
// load is coalesced), keeps its M partial sums in registers, and the lanes
// are summed through shared memory at the end.  The tensor cores do not
// take mod-p uint32 products.
//
// Reduction: a product of two residues is < P^2 ~ 4.05e18, and REDC needs
// its input below P * 2^32 ~ 8.65e18, so exactly two products can share
// one Montgomery reduction (2 P^2 < P 2^32 < 3 P^2).  Each pair is reduced
// to a residue and added mod P: the sum of Montgomery products of the JAX
// reduction tree, reduced in another order, which mod P changes nothing.
#include <cuda_runtime.h>
#include <cstdint>

#include "field.cuh"

namespace {

constexpr int kCols = 32;    // output columns per block (threadIdx.x)
constexpr int kLanes = 16;   // lanes along K per column (threadIdx.y)
constexpr int kMaxM = 8;     // rows of A per block (grid.y covers more)

__global__ void modmatmul_kernel(const int64_t* __restrict__ a,
                                 const int64_t* __restrict__ b,
                                 int64_t* __restrict__ c, int M, long K,
                                 long N) {
  __shared__ uint32_t part[kLanes][kMaxM][kCols];
  const long j = blockIdx.x * static_cast<long>(kCols) + threadIdx.x;
  const int lane = threadIdx.y;
  const int i0 = blockIdx.y * kMaxM;
  const int mi = M - i0 < kMaxM ? M - i0 : kMaxM;
  uint32_t acc[kMaxM];
#pragma unroll
  for (int i = 0; i < kMaxM; ++i) acc[i] = 0u;
  if (j < N) {
    long chunk = (K + kLanes - 1) / kLanes;
    chunk += chunk & 1;                       // even: pairs never straddle
    const long k0 = lane * chunk;
    const long k1 = k0 + chunk < K ? k0 + chunk : K;
    long k = k0;
    for (; k + 1 < k1; k += 2) {
      uint64_t b0 = static_cast<uint32_t>(b[k * N + j]);
      uint64_t b1 = static_cast<uint32_t>(b[(k + 1) * N + j]);
#pragma unroll
      for (int i = 0; i < kMaxM; ++i) {
        if (i < mi) {
          const int64_t* arow = a + (i0 + i) * K;
          uint64_t t = static_cast<uint32_t>(arow[k]) * b0 +
                       static_cast<uint32_t>(arow[k + 1]) * b1;   // < 2 P^2
          acc[i] = bb::add(acc[i], bb::redc(t));
        }
      }
    }
    if (k < k1) {
      uint32_t b0 = static_cast<uint32_t>(b[k * N + j]);
#pragma unroll
      for (int i = 0; i < kMaxM; ++i)
        if (i < mi) acc[i] = bb::add(acc[i], bb::mul(static_cast<uint32_t>(a[(i0 + i) * K + k]), b0));
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxM; ++i) part[lane][i][threadIdx.x] = acc[i];
  __syncthreads();
  if (lane == 0 && j < N) {
#pragma unroll
    for (int i = 0; i < kMaxM; ++i) {
      if (i < mi) {
        uint32_t s = part[0][i][threadIdx.x];
        for (int l = 1; l < kLanes; ++l) s = bb::add(s, part[l][i][threadIdx.x]);
        c[(i0 + i) * N + j] = s;
      }
    }
  }
}

}  // namespace

extern "C" {

int modmatmul(const int64_t* a, const int64_t* b, int64_t* c, int M, long K,
              long N, void* stream) {
  if (M == 0 || N == 0) return 0;
  dim3 grid(static_cast<unsigned>((N + kCols - 1) / kCols),
            static_cast<unsigned>((M + kMaxM - 1) / kMaxM));
  modmatmul_kernel<<<grid, dim3(kCols, kLanes), 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, c, M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
