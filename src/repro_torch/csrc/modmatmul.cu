// K4 — skinny modular matmul C = A @ B mod P on Montgomery operands.
//
// Replaces the Pallas kernel src/repro/kernels/modmatmul.py
// (_kernel / modmatmul), used through kernels/ops.partial_eval_rows_mm for
// the PCS opening row u = eq^T . mat (M = 4: the Fp4 coefficient rows of
// eq^T; K = R and N = C of the commitment matrix).
//
// Bound on this card: bytes.  At M = 4 each word of B (the commitment
// matrix, int64) takes part in 4 products, far too few operations per byte
// to keep the integer pipes busy, so the design is about reading B at the
// memory's rate:
// - A block covers a tile of kCols = 4 output columns (32 bytes of a B
//   row, one sector) and all of K: at N = 512 and 1024 that is 128 and 256
//   blocks (kernels/modmatmul.plan chooses the rows of A and the threads
//   per block).
// - Lane l of a warp loads columns 2 (l & 1), +1 of one row pair with two
//   16-byte loads; a warp covers 16 row pairs, a block of w warps 16 w.
//   Each thread issues the loads of kDepth row pairs before it uses any,
//   so several 16-byte loads per thread are in flight.
// - A (M x K, a few KB, at most 8 rows per block) is read where it is used,
//   from L1 and L2: staging the block's rows of A in shared memory put a
//   trip to L2 and a barrier before the first product, and was slower.
// - Each thread keeps MT x 2 residue sums in registers; the 16 row slots of
//   a warp are summed by shuffles, the warps through shared memory.
// The tensor cores do not take mod-p uint32 products.
//
// Reduction: a product of two residues is < P^2 ~ 4.05e18, and REDC needs
// its input below P * 2^32 ~ 8.65e18, so exactly two products (rows k and
// k + 1 of one pair) share one Montgomery reduction (2 P^2 < P 2^32 <
// 3 P^2).  Each pair is reduced to a residue and added mod P: the sum of
// Montgomery products of the JAX reduction tree, reduced in another order,
// which mod P changes nothing.  An odd K pads its last pair with a zero
// row.
#include <cuda_runtime.h>
#include <cstdint>

#include "field.cuh"

namespace {

constexpr int kCols = 4;           // output columns per block
constexpr int kSlotsPerWarp = 16;  // row pairs per warp per step
constexpr int kMaxWarps = 8;
constexpr int kDepth = 4;          // row pairs per thread loaded ahead

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
  // the 16 row slots of a warp share a column pair when lanes agree in bit 0
#pragma unroll
  for (int o = 2; o < 32; o <<= 1) v = bb::add(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One block: columns [j0, j0 + 4), A rows [i0, i0 + MT), all K rows of B.
// VEC: B rows are 16-byte aligned (N even, base aligned), so a lane's two
// columns are one 16-byte load.
template <int MT, bool VEC>
__global__ void __launch_bounds__(kMaxWarps * 32)
modmatmul_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
                 int64_t* __restrict__ c, int M, long K, long N) {
  __shared__ uint32_t red[kMaxWarps][MT][kCols];
  const long j0 = static_cast<long>(blockIdx.x) * kCols;
  const int i0 = blockIdx.y * MT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;

  const long j = j0 + 2 * (lane & 1);
  const bool j_in = j < N, j1_in = j + 1 < N;
  const int slot = warp * kSlotsPerWarp + (lane >> 1);
  const int slots = warps * kSlotsPerWarp;
  const long pairs = (K + 1) >> 1;
  const long step = static_cast<long>(kDepth) * slots;
  uint32_t bv[kDepth][2][2];                 // [pair][row][column]
  auto load = [&](long p0) {
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const long p = p0 + static_cast<long>(d) * slots;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long kk = 2 * p + r;
        bv[d][r][0] = bv[d][r][1] = 0u;
        if (p < pairs && kk < K) {
          const int64_t* row = b + kk * N + j;
          if (VEC) {
            if (j_in) {
              const longlong2 w = __ldg(reinterpret_cast<const longlong2*>(row));
              bv[d][r][0] = static_cast<uint32_t>(w.x);
              bv[d][r][1] = static_cast<uint32_t>(w.y);
            }
          } else {
            if (j_in) bv[d][r][0] = static_cast<uint32_t>(__ldg(row));
            if (j1_in) bv[d][r][1] = static_cast<uint32_t>(__ldg(row + 1));
          }
        }
      }
    }
  };
  load(slot);

  uint32_t acc[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i][0] = acc[i][1] = 0u;
  for (long p0 = slot; p0 < pairs; p0 += step) {
    if (p0 != slot) load(p0);
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const long p = p0 + static_cast<long>(d) * slots;
      if (p < pairs) {
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          // A is a few KB that every block reads: L1 and L2 serve it
          const int64_t* ar = a + (i0 + i) * K + 2 * p;
          const bool row_in = i0 + i < M;
          const uint64_t x0 = row_in ? static_cast<uint32_t>(__ldg(ar)) : 0u;
          const uint64_t x1 = row_in && 2 * p + 1 < K ? static_cast<uint32_t>(__ldg(ar + 1)) : 0u;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint64_t t = x0 * bv[d][0][e] + x1 * bv[d][1][e];   // < 2 P^2
            acc[i][e] = bb::add(acc[i][e], bb::redc(t));
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint32_t s = warp_sum(acc[i][e]);
      if (lane < 2) red[warp][i][2 * lane + e] = s;
    }
  }
  __syncthreads();
  if (threadIdx.x < MT * kCols) {
    const int i = threadIdx.x / kCols, e = threadIdx.x % kCols;
    uint32_t s = red[0][i][e];
    for (int w = 1; w < warps; ++w) s = bb::add(s, red[w][i][e]);
    const long jj = j0 + e;
    if (i0 + i < M && jj < N) c[static_cast<long>(i0 + i) * N + jj] = s;
  }
}

template <int MT, bool VEC>
cudaError_t launch(const int64_t* a, const int64_t* b, int64_t* c, int M,
                   long K, long N, int threads, cudaStream_t st) {
  dim3 grid(static_cast<unsigned>((N + kCols - 1) / kCols),
            static_cast<unsigned>((M + MT - 1) / MT));
  modmatmul_kernel<MT, VEC><<<grid, threads, 0, st>>>(a, b, c, M, K, N);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_mt(int mt, const int64_t* a, const int64_t* b, int64_t* c,
                      int M, long K, long N, int threads, cudaStream_t st) {
  switch (mt) {
    case 1: return launch<1, VEC>(a, b, c, M, K, N, threads, st);
    case 2: return launch<2, VEC>(a, b, c, M, K, N, threads, st);
    case 4: return launch<4, VEC>(a, b, c, M, K, N, threads, st);
    case 8: return launch<8, VEC>(a, b, c, M, K, N, threads, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One modmatmul call as planned by kernels/modmatmul.plan: mt rows of A and
// `threads` threads per block, one kernel.
int modmatmul(const int64_t* a, const int64_t* b, int64_t* c, int M, long K,
              long N, int mt, int threads, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (threads < 32 || threads > kMaxWarps * 32 || (threads & 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = (N % 2 == 0) && (reinterpret_cast<uintptr_t>(b) % 16 == 0);
  return static_cast<int>(vec ? launch_mt<true>(mt, a, b, c, M, K, N, threads, st)
                              : launch_mt<false>(mt, a, b, c, M, K, N, threads, st));
}

}  // extern "C"
