// K5 — one sum-check round for one claim with a known challenge:
// g(0..d) together with the fold f_t <- lo + c (hi - lo).
//
// Replaces the Pallas kernel src/repro/kernels/sumcheck_fold.py (_kernel,
// driven by fold_round).  The TPU kernel walked 2048-row blocks on a
// sequential grid and left the per-block partial sums of g to the host
// wrapper.  Here one launch does all of it:
//   * A persistent grid (no more blocks than the card holds at once) walks
//     tiles of kThreads pairs: block b takes tiles b, b + grid, ...; thread
//     j takes pair j of each tile.  It reads lo and hi of every factor once,
//     adds its products into g(0..d) in registers and writes the folded
//     words with 16-byte streaming stores (nothing reads them in this call).
//   * The pairs come in by 16-byte read-only loads straight into registers,
//     two tiles' pairs a thread in flight.  A ring of shared-memory stages
//     fed by 1-D bulk copies (cp.async.bulk on one mbarrier a stage, one
//     thread issuing them) was timed against these loads on the H100 and
//     lost at every shape (PERF.md, K5's row): its start-up is not paid
//     back at a few tiles a block, and where it is, both meet the same
//     DRAM rate.
//   * g: a shuffle reduction within each warp, one row per warp in shared
//     memory, one warp finishes.  Each block writes its partial row to the
//     call's scratch; after a grid-wide sync (a cooperative launch) block
//     0 sums the rows into g.  A grid of one block writes g itself, from an
//     ordinary launch.
// No state outlives a call: the partials live in the call's scratch and
// the grid barrier is the runtime's, so concurrent callers cannot race.
// c stays on the device; nothing is read back.  Field sums are order-free,
// so any reduction order gives the same words as the plain version.
//
// Bound on this card: bytes.  A round reads 2 d n words and writes d n
// words (as u32: 12 d n bytes) against (d + 1)(d - 1) + d Fp4 products per
// pair; this kernel moves the int64 words the port stores, twice that.
// No tensor cores: Fp4 products over the 31-bit BabyBear field have no
// tensor-core form (the products are exact 32 x 32 -> 64-bit integer
// multiplies followed by Montgomery reduction).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "field.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;              // = the pairs of a full tile
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 3;
constexpr unsigned kFull = 0xffffffffu;
// Blocks kept on one SM: the plan's grid assumes as many, and the launch
// bounds hold the registers to them.
constexpr int kBlocks = 2;

struct Args {
  const int64_t* f[kMaxD];
  int64_t* out[kMaxD];
  const int64_t* c;
  int64_t* g;            // (d + 1, 4)
  int64_t* partial;      // (grid, d + 1, 4) when grid > 1
  long half;             // pairs
  long tiles;            // ceil(half / kThreads)
};

// ---- words ----------------------------------------------------------------
__device__ __forceinline__ bb::f4 f4_of(longlong2 x, longlong2 y) {
  return bb::f4{{static_cast<uint32_t>(x.x), static_cast<uint32_t>(x.y),
                 static_cast<uint32_t>(y.x), static_cast<uint32_t>(y.y)}};
}

__device__ __forceinline__ bb::f4 load_ldg(const int64_t* p) {
  const longlong2* q = reinterpret_cast<const longlong2*>(p);
  return f4_of(__ldg(q), __ldg(q + 1));
}

__device__ __forceinline__ bb::f4 load_cg(const int64_t* p) {
  const longlong2* q = reinterpret_cast<const longlong2*>(p);
  return f4_of(__ldcg(q), __ldcg(q + 1));
}

__device__ __forceinline__ void store_cs(int64_t* p, const bb::f4& v) {
  longlong2* q = reinterpret_cast<longlong2*>(p);
  __stcs(q, make_longlong2(v.c[0], v.c[1]));
  __stcs(q + 1, make_longlong2(v.c[2], v.c[3]));
}

// ---- one pair -------------------------------------------------------------
// Writes the folded words of pair i and adds prod_t (lo_t + e (hi_t - lo_t))
// into acc[e] for e = 0..D.
template <int D>
__device__ __forceinline__ void fold_pair(const bb::f4 (&lo)[D], const bb::f4 (&hi)[D],
                                          const bb::f4& c, bb::f4 (&acc)[D + 1],
                                          const Args& a, long i) {
  bb::f4 cur[D], df[D];
#pragma unroll
  for (int t = 0; t < D; ++t) {
    cur[t] = lo[t];
    df[t] = bb::f4_sub(hi[t], lo[t]);
    store_cs(a.out[t] + i * 4, bb::f4_add(lo[t], bb::f4_mul(c, df[t])));
  }
#pragma unroll
  for (int e = 0; e <= D; ++e) {
    if (e > 0) {
#pragma unroll
      for (int t = 0; t < D; ++t) cur[t] = e == 1 ? hi[t] : bb::f4_add(cur[t], df[t]);
    }
    bb::f4 prod = cur[0];
#pragma unroll
    for (int t = 1; t < D; ++t) prod = bb::f4_mul(prod, cur[t]);
    acc[e] = bb::f4_add(acc[e], prod);
  }
}

// ---- g --------------------------------------------------------------------
// v summed over lanes 0..L-1 into lane 0.
template <int L, int W>
__device__ __forceinline__ void warp_sum(uint32_t (&v)[W]) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] = bb::add(v[w], __shfl_down_sync(kFull, v[w], off));
}

// The block's sum of acc into dst ((D + 1) x 4 words), written by thread 0.
// red: kWarps rows of (D + 1) 4 words.  Every thread of the block calls it.
template <int D>
__device__ void block_sum(const bb::f4 (&acc)[D + 1], uint32_t* red, int64_t* dst) {
  constexpr int W = (D + 1) * 4;
  uint32_t v[W];
#pragma unroll
  for (int e = 0; e <= D; ++e)
#pragma unroll
    for (int k = 0; k < 4; ++k) v[e * 4 + k] = acc[e].c[k];
  warp_sum<32>(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0)
#pragma unroll
    for (int w = 0; w < W; ++w) red[warp * W + w] = v[w];
  __syncthreads();
  if (warp == 0) {
    // lanes past kWarps read a copy of a row; lane 0 sums lanes 0..kWarps-1
    const int row = lane & (kWarps - 1);
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] = red[row * W + w];
    warp_sum<kWarps>(v);
    if (lane == 0)
#pragma unroll
      for (int w = 0; w < W; ++w) dst[w] = v[w];
  }
}

// The grid's sum of acc into g: directly for one block, else through the
// partial rows, a grid-wide sync and block 0.
template <int D>
__device__ void finish(const bb::f4 (&acc)[D + 1], uint32_t* red, const Args& a) {
  constexpr int W = (D + 1) * 4;
  if (gridDim.x == 1) {
    block_sum<D>(acc, red, a.g);
    return;
  }
  block_sum<D>(acc, red, a.partial + static_cast<long>(blockIdx.x) * W);
  cg::this_grid().sync();
  if (blockIdx.x != 0) return;
  bb::f4 tot[D + 1];
#pragma unroll
  for (int e = 0; e <= D; ++e) tot[e] = bb::f4_zero();
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += kThreads)
#pragma unroll
    for (int e = 0; e <= D; ++e)
      tot[e] = bb::f4_add(tot[e], load_cg(a.partial + static_cast<long>(b) * W + e * 4));
  __syncthreads();
  block_sum<D>(tot, red, a.g);
}

// ---- the kernel ----------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads, kBlocks) fold(const Args a) {
  __shared__ uint32_t red[kWarps * (D + 1) * 4];
  const int j = threadIdx.x;
  const long pairs = a.half < kThreads ? a.half : kThreads;
  const long mine = (a.tiles - 1 - blockIdx.x) / gridDim.x + 1;
  const long step = static_cast<long>(gridDim.x) * kThreads;
  const bb::f4 c = load_ldg(a.c);
  bb::f4 acc[D + 1];
#pragma unroll
  for (int e = 0; e <= D; ++e) acc[e] = bb::f4_zero();
  if (j < pairs) {
    for (long k = 0; k < mine; k += 2) {
      const long i0 = (blockIdx.x + k * gridDim.x) * kThreads + j;
      const bool two = k + 1 < mine;       // uniform over the block
      bb::f4 lo[2][D], hi[2][D];
#pragma unroll
      for (int t = 0; t < D; ++t) {
        lo[0][t] = load_ldg(a.f[t] + i0 * 4);
        hi[0][t] = load_ldg(a.f[t] + (i0 + a.half) * 4);
      }
      if (two) {
#pragma unroll
        for (int t = 0; t < D; ++t) {
          lo[1][t] = load_ldg(a.f[t] + (i0 + step) * 4);
          hi[1][t] = load_ldg(a.f[t] + (i0 + step + a.half) * 4);
        }
      }
      fold_pair<D>(lo[0], hi[0], c, acc, a, i0);
      if (two) fold_pair<D>(lo[1], hi[1], c, acc, a, i0 + step);
    }
  }
  finish<D>(acc, red, a);
}

template <int D>
cudaError_t launch(const Args& a, int grid, cudaStream_t st) {
  if (grid == 1) {
    fold<D><<<1, kThreads, 0, st>>>(a);
    return cudaGetLastError();
  }
  void* params[] = {const_cast<Args*>(&a)};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fold<D>), grid, kThreads,
                                     params, 0, st);
}

}  // namespace

extern "C" {

// One call, its operands packed as int64 words (one ctypes argument instead
// of a dozen: the wrapper's host time per call is part of the kernel's):
//   args[0..2]  f0, f1, f2: d factors of n = 2 half Fp4 words each, 16-byte
//               aligned (unused pointers 0);
//   args[3]     c (4,), 16-byte aligned;
//   args[4]     out: the folded factors (d, half, 4), then g (d + 1, 4),
//               then, when grid > 1, the partial rows (grid, d + 1, 4);
//   args[5..7]  half, d, grid.
// One launch, cooperative when grid > 1; grid must not exceed the tiles
// nor what the card holds at once.
int sf_fold_round(const int64_t* args, void* stream) {
  const long half = args[5];
  const int d = static_cast<int>(args[6]), grid = static_cast<int>(args[7]);
  const long tiles = (half + kThreads - 1) / kThreads;
  if (half < 1 || d < 1 || d > kMaxD || grid < 1 || grid > tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  auto in = [&](int k) { return reinterpret_cast<const int64_t*>(args[k]); };
  int64_t* out = reinterpret_cast<int64_t*>(args[4]);
  int64_t* g = out + static_cast<long>(d) * half * 4;
  Args a{{in(0), in(1), in(2)}, {}, in(3), g, g + (d + 1) * 4, half, tiles};
  for (int t = 0; t < d; ++t) a.out[t] = out + t * half * 4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return static_cast<int>(launch<1>(a, grid, st));
    case 2: return static_cast<int>(launch<2>(a, grid, st));
    default: return static_cast<int>(launch<3>(a, grid, st));
  }
}

}  // extern "C"
