// K3 — fused sum-check rounds for K independent claims.
//
// Replaces the Pallas kernel src/repro/kernels/sumcheck_round.py
// (_round_kernel / _round_math, driven by _launch_round and prove_rounds).
//
// Each round needs g(0..d) = sum over the half-length of prod_t factor_t(X)
// before the Fiat-Shamir challenge exists, and the fold needs that
// challenge.  On the TPU one sequential grid saw the whole reduction; here
// blocks cannot see each other.  Once a claim's live factors fit in shared
// memory (d n 16 B <= 196,608 B: n_tail = 8192 for d = 1, 4096 for d = 2,
// 3) one block per claim runs every remaining round; above that, head
// rounds take two launches each.  All launches of a prove_rounds call are
// queued on one stream by sc_prove, with no host synchronisation:
//
//   head (n > n_tail; h = log2(n / n_tail) rounds):
//     partial_kernel   — grid (nb, K): round 0's g partials, one per block;
//     absorb_kernel    — one warp per claim: reduces the block partials with
//                        shuffles, stores g, absorbs it (length tag, RATE
//                        chunks) and squeezes the Fp4 challenge c_r with the
//                        16-lane permutation;
//     fold_kernel      — grid (nb, K): folds round r by c_r and accumulates
//                        round r+1's g partials in the same pass.  A thread
//                        takes the pairs at j and j + half/2, so it reads
//                        each factor word once and writes half of them, as
//                        u32 words to a ping-pong scratch buffer;
//     ... absorb and fold alternate; the fold of the last head round is
//     left to the tail, which applies it while loading.
//   tail_kernel        — grid K, one block per claim: loads the factors (at
//                        2 n_tail with the pending fold, else at n) into
//                        shared memory as u32 Fp4 words, then per round
//                        accumulates g(0..d) (fused with the previous fold),
//                        reduces it with shuffles and one shared-memory pass,
//                        and warp 0 absorbs g and squeezes c; after the last
//                        round it absorbs the final evaluations and writes
//                        them and the new sponge state.
//
// Launches per call: 1 for n <= n_tail, else 2 h + 1.
// Bound on this card: bytes for the large claims (the head reads every
// factor word once per round and writes half, against about 4 (d + 1) Fp4
// products per pair); latency for the short claims of the main path (a
// chain of 2-3 permutations per round, one warp's work), which the tail
// keeps inside one launch with the factors in shared memory.
#include <cuda_runtime.h>
#include <cstdint>

#include "field.cuh"
#include "poseidon2.cuh"

namespace {

constexpr int kThreads = 256;        // head kernels
constexpr int kTailThreads = 512;    // tail kernel, at most
constexpr int kMaxD = 3;

// d factor arrays, claim k's row at p[t] + k * len * 4 (T = int64_t for the
// caller's tensors, uint32_t for the scratch buffers).
template <typename T>
struct Src {
  const T* p[kMaxD];
};

__device__ __forceinline__ bb::f4 ld4(const int64_t* p) { return bb::f4_load(p); }

__device__ __forceinline__ bb::f4 ld4(const uint32_t* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  return bb::f4{{v.x, v.y, v.z, v.w}};
}

__device__ __forceinline__ void st4(uint32_t* p, const bb::f4& a) {
  *reinterpret_cast<uint4*>(p) = make_uint4(a.c[0], a.c[1], a.c[2], a.c[3]);
}

__device__ __forceinline__ bb::f4 fold1(const bb::f4& lo, const bb::f4& hi,
                                        const bb::f4& c) {
  return bb::f4_add(lo, bb::f4_mul(c, bb::f4_sub(hi, lo)));
}

// acc[e] += prod_t (cur[t] + e df[t]), e = 0..D.
template <int D>
__device__ __forceinline__ void accumulate(bb::f4 (&cur)[D], const bb::f4 (&df)[D],
                                           bb::f4 (&acc)[D + 1]) {
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

template <int W>
__device__ __forceinline__ void warp_sum(uint32_t (&g)[W]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int q = 0; q < W; ++q) g[q] = bb::add(g[q], __shfl_xor_sync(p2::FULL, g[q], o));
}

// Sum acc over the block: every lane of warp 0 returns with the total in g.
// red: 32 x 16 words of shared memory.  Ends with a barrier.
template <int D>
__device__ __forceinline__ void block_sum(const bb::f4 (&acc)[D + 1],
                                          uint32_t (*red)[16],
                                          uint32_t (&g)[4 * (D + 1)]) {
  constexpr int W = 4 * (D + 1);
#pragma unroll
  for (int e = 0; e <= D; ++e)
#pragma unroll
    for (int c = 0; c < 4; ++c) g[4 * e + c] = acc[e].c[c];
  warp_sum(g);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0)
#pragma unroll
    for (int q = 0; q < W; ++q) red[warp][q] = g[q];
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
#pragma unroll
    for (int q = 0; q < W; ++q) g[q] = lane < nwarps ? red[lane][q] : 0u;
    warp_sum(g);
  }
}

// Warp-level round step, every lane of one warp: store g, absorb it into
// the state (lanes 0..15 hold the claim's state, lanes 16..31 a dummy),
// squeeze c.  Returns the new state word; c is in lanes 0..3.
template <int D>
__device__ __forceinline__ uint32_t absorb_squeeze(uint32_t s, const uint32_t (&g)[4 * (D + 1)],
                                                   uint32_t tag_m, const p2::Lane& l,
                                                   int64_t* rp_row, int64_t* c_row) {
  constexpr int W = 4 * (D + 1);
  const bool mine = threadIdx.x < p2::WIDTH;     // the claim's half-warp
  if (mine && l.j < W) rp_row[l.j] = p2::pick(g, l.j);
  s = p2::absorb(s, g, tag_m, l);
  s = p2::permute(s, l);                         // challenge squeeze
  if (mine && l.j < 4) c_row[l.j] = s;
  return s;
}

// Round 0's g partials over the caller's factors (length n).
template <int D>
__global__ void __launch_bounds__(kThreads) partial_kernel(Src<int64_t> f, long n,
                                                           uint32_t* __restrict__ partial) {
  __shared__ uint32_t red[32][16];
  constexpr int W = 4 * (D + 1);
  const long k = blockIdx.y;
  const long half = n / 2;
  bb::f4 acc[D + 1];
#pragma unroll
  for (int e = 0; e <= D; ++e) acc[e] = bb::f4_zero();
  for (long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x; i < half;
       i += static_cast<long>(gridDim.x) * blockDim.x) {
    bb::f4 cur[D], df[D];
#pragma unroll
    for (int t = 0; t < D; ++t) {
      const int64_t* row = f.p[t] + k * n * 4;
      cur[t] = ld4(row + i * 4);
      df[t] = bb::f4_sub(ld4(row + (i + half) * 4), cur[t]);
    }
    accumulate<D>(cur, df, acc);
  }
  uint32_t g[W];
  block_sum<D>(acc, red, g);
  if (threadIdx.x < W)
    partial[(k * gridDim.x + blockIdx.x) * W + threadIdx.x] = p2::pick(g, threadIdx.x);
}

// One warp per claim: g = sum of the nb block partials; store it, absorb
// it, squeeze c_r.
template <int D>
__global__ void __launch_bounds__(32) absorb_kernel(
    const uint32_t* __restrict__ partial, int nb, const int64_t* st_in,
    int64_t* st_out, int64_t* __restrict__ rp, int64_t* __restrict__ cs, int round,
    int m, uint32_t tag_m) {
  constexpr int W = 4 * (D + 1);
  const long k = blockIdx.x;
  const p2::Lane l = p2::Lane::load();
  uint32_t g[W];
#pragma unroll
  for (int q = 0; q < W; ++q) g[q] = 0u;
  for (int b = threadIdx.x; b < nb; b += 32)
#pragma unroll
    for (int q = 0; q < W; ++q) g[q] = bb::add(g[q], partial[(k * nb + b) * W + q]);
  warp_sum(g);
  const bool mine = threadIdx.x < p2::WIDTH;
  uint32_t s = mine ? static_cast<uint32_t>(st_in[k * p2::WIDTH + l.j]) : 0u;
  s = absorb_squeeze<D>(s, g, tag_m, l, rp + (k * m + round) * W,
                        cs + (k * m + round) * 4);
  if (mine) st_out[k * p2::WIDTH + l.j] = s;
}

// Fold round r (length len) by c_r into out (length len / 2, u32) and
// accumulate round r+1's g partials over the folded values: thread j takes
// the output pairs (j, j + q), q = len / 4.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads) fold_kernel(
    Src<T> f, long len, const int64_t* __restrict__ cs, int round, int m,
    uint32_t* __restrict__ out, long K, uint32_t* __restrict__ partial) {
  __shared__ uint32_t red[32][16];
  constexpr int W = 4 * (D + 1);
  const long k = blockIdx.y;
  const long half = len / 2, q = len / 4;
  const bb::f4 c = bb::f4_load(cs + (k * m + round) * 4);
  bb::f4 acc[D + 1];
#pragma unroll
  for (int e = 0; e <= D; ++e) acc[e] = bb::f4_zero();
  for (long j = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x; j < q;
       j += static_cast<long>(gridDim.x) * blockDim.x) {
    bb::f4 cur[D], df[D];
#pragma unroll
    for (int t = 0; t < D; ++t) {
      const T* row = f.p[t] + k * len * 4;
      uint32_t* orow = out + (t * K + k) * half * 4;
      const bb::f4 a = fold1(ld4(row + j * 4), ld4(row + (j + half) * 4), c);
      const bb::f4 b = fold1(ld4(row + (j + q) * 4), ld4(row + (j + q + half) * 4), c);
      st4(orow + j * 4, a);
      st4(orow + (j + q) * 4, b);
      cur[t] = a;
      df[t] = bb::f4_sub(b, a);
    }
    accumulate<D>(cur, df, acc);
  }
  uint32_t g[W];
  block_sum<D>(acc, red, g);
  if (threadIdx.x < W)
    partial[(k * gridDim.x + blockIdx.x) * W + threadIdx.x] = p2::pick(g, threadIdx.x);
}

// Where the tail block's factors come from: the caller's int64 tensors at
// length nt, the same at length 2 nt with round r0-1's fold by c_{r0-1}
// pending (one head round), or the head's u32 scratch at length 2 nt with
// that fold pending.
enum class TailFrom : int { kInput, kInputFold, kScratchFold };

template <int D, typename T>
__device__ __forceinline__ void tail_load(const Src<T>& f, long k, long nt, bool fold,
                                          const bb::f4& c, uint32_t* sm) {
  const long len_in = fold ? 2 * nt : nt;
  for (long i = threadIdx.x; i < nt; i += blockDim.x)
#pragma unroll
    for (int t = 0; t < D; ++t) {
      const T* row = f.p[t] + k * len_in * 4;
      bb::f4 v = ld4(row + i * 4);
      if (fold) v = fold1(v, ld4(row + (i + nt) * 4), c);
      st4(sm + (t * nt + i) * 4, v);
    }
}

// One block per claim: rounds r0..m-1 in shared memory, then the final
// evaluations.  The source is a runtime choice, not a template argument, so
// the permutation is unrolled once per D only.
template <int D>
__global__ void __launch_bounds__(kTailThreads) tail_kernel(
    Src<int64_t> in, Src<uint32_t> scratch, TailFrom from, long nt, int r0, int m,
    const int64_t* st_in, int64_t* st_out, int64_t* __restrict__ rp,
    int64_t* __restrict__ cs, int64_t* __restrict__ finals, uint32_t tag_round,
    uint32_t tag_final) {
  extern __shared__ uint4 sm_raw[];
  __shared__ uint32_t red[32][16];
  __shared__ uint32_t shc[4];
  constexpr int W = 4 * (D + 1);
  uint32_t* sm = reinterpret_cast<uint32_t*>(sm_raw);   // D regions of nt Fp4
  const long k = blockIdx.x;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const bool warp0 = tid < 32;

  {
    const bool fold = from != TailFrom::kInput;
    bb::f4 c = bb::f4_zero();
    if (fold) c = bb::f4_load(cs + (k * m + r0 - 1) * 4);
    if (from == TailFrom::kScratchFold)
      tail_load<D>(scratch, k, nt, true, c, sm);
    else
      tail_load<D>(in, k, nt, fold, c, sm);
  }
  p2::Lane l;
  uint32_t s = 0u;
  if (warp0) {
    l = p2::Lane::load();
    if (tid < p2::WIDTH) s = static_cast<uint32_t>(st_in[k * p2::WIDTH + l.j]);
  }
  __syncthreads();

  long len = nt;             // live length of the current round
  bool pending = false;      // round r-1's fold (by shc) not yet applied
  for (int r = r0; r < m; ++r) {
    const long half = len / 2;
    bb::f4 acc[D + 1];
#pragma unroll
    for (int e = 0; e <= D; ++e) acc[e] = bb::f4_zero();
    if (!pending) {
      for (long i = tid; i < half; i += nthr) {
        bb::f4 cur[D], df[D];
#pragma unroll
        for (int t = 0; t < D; ++t) {
          cur[t] = ld4(sm + (t * nt + i) * 4);
          df[t] = bb::f4_sub(ld4(sm + (t * nt + i + half) * 4), cur[t]);
        }
        accumulate<D>(cur, df, acc);
      }
    } else {
      // the stored data has length 2 len: fold it into [0, len) in place
      const bb::f4 c{{shc[0], shc[1], shc[2], shc[3]}};
      for (long j = tid; j < half; j += nthr) {
        bb::f4 cur[D], df[D];
#pragma unroll
        for (int t = 0; t < D; ++t) {
          uint32_t* reg = sm + t * nt * 4;
          const bb::f4 a = fold1(ld4(reg + j * 4), ld4(reg + (j + len) * 4), c);
          const bb::f4 b = fold1(ld4(reg + (j + half) * 4),
                                 ld4(reg + (j + half + len) * 4), c);
          st4(reg + j * 4, a);
          st4(reg + (j + half) * 4, b);
          cur[t] = a;
          df[t] = bb::f4_sub(b, a);
        }
        accumulate<D>(cur, df, acc);
      }
    }
    uint32_t g[W];
    block_sum<D>(acc, red, g);
    if (warp0) {
      s = absorb_squeeze<D>(s, g, tag_round, l, rp + (k * m + r) * W,
                            cs + (k * m + r) * 4);
      if (tid < 4) shc[tid] = s;
    }
    __syncthreads();
    pending = true;
    len = half;
  }

  // Final evaluations: the pending fold at index 0 of each factor.
  if (warp0) {
    const bb::f4 c{{shc[0], shc[1], shc[2], shc[3]}};
    uint32_t fin[4 * D];
#pragma unroll
    for (int t = 0; t < D; ++t) {
      const uint32_t* reg = sm + t * nt * 4;
      const bb::f4 v = fold1(ld4(reg), ld4(reg + 4), c);
#pragma unroll
      for (int q = 0; q < 4; ++q) fin[4 * t + q] = v.c[q];
    }
    if (tid < 4 * D) finals[k * 4 * D + tid] = p2::pick(fin, tid);
    s = p2::absorb(s, fin, tag_final, l);
    if (tid < p2::WIDTH) st_out[k * p2::WIDTH + l.j] = s;
  }
}

template <typename T>
Src<T> src_of(const T* f0, const T* f1, const T* f2) {
  return Src<T>{{f0, f1, f2}};
}

// The dynamic shared memory is d nt 16 B; the kernels' ceiling above the
// default 48 KB is set once per device by sc_set_tail_smem, never per call,
// so concurrent callers cannot change it under each other's launches.
template <int D>
cudaError_t launch_tail(Src<int64_t> in, Src<uint32_t> scratch, TailFrom from, long K,
                        long nt, int threads, int r0, int m, const int64_t* st_in,
                        int64_t* st_out, int64_t* rp, int64_t* cs, int64_t* finals,
                        uint32_t tag_round, uint32_t tag_final, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(D) * nt * 16;
  tail_kernel<D><<<static_cast<unsigned>(K), threads, smem, st>>>(
      in, scratch, from, nt, r0, m, st_in, st_out, rp, cs, finals, tag_round, tag_final);
  return cudaGetLastError();
}

// The whole of one prove_rounds call; see the plan in
// kernels/sumcheck_round.py.  f0..f2: the caller's factors, (K, n, 4)
// int64 each; scratch: u32 words, K nb W partials then, for h >= 2, the
// ping-pong buffers of d K n/2 and d K n/4 Fp4 words.
template <int D>
int prove(const int64_t* f0, const int64_t* f1, const int64_t* f2, long K,
          long n, int m, int h, long nt, int nb, int tail_threads,
          uint32_t* scratch, const int64_t* st_in, int64_t* st_out,
          int64_t* rp, int64_t* cs, int64_t* finals, uint32_t tag_round,
          uint32_t tag_final, int* launched, cudaStream_t st) {
  constexpr int W = 4 * (D + 1);
  const Src<int64_t> in = src_of(f0, f1, f2);
  cudaError_t e;
  *launched = 0;
  if (h == 0)
    e = launch_tail<D>(in, Src<uint32_t>{}, TailFrom::kInput, K, n, tail_threads, 0, m,
                       st_in, st_out, rp, cs, finals, tag_round, tag_final, st);
  else {
    uint32_t* partial = scratch;
    uint32_t* buf[2] = {scratch + K * nb * W, scratch + K * nb * W + D * K * (n / 2) * 4};
    partial_kernel<D><<<dim3(nb, static_cast<unsigned>(K)), kThreads, 0, st>>>(in, n, partial);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    ++*launched;
    for (int r = 0; r < h; ++r) {
      absorb_kernel<D><<<static_cast<unsigned>(K), 32, 0, st>>>(
          partial, nb, r == 0 ? st_in : st_out, st_out, rp, cs, r, m, tag_round);
      if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
      ++*launched;
      if (r == h - 1) break;
      const long len = n >> r;
      uint32_t* out = buf[r & 1];
      if (r == 0) {
        fold_kernel<D, int64_t><<<dim3(nb, static_cast<unsigned>(K)), kThreads, 0, st>>>(
            in, len, cs, r, m, out, K, partial);
      } else {
        const uint32_t* prev = buf[(r - 1) & 1];
        const long pl = len * 4 * K;
        const Src<uint32_t> src = src_of<uint32_t>(prev, prev + pl, prev + 2 * pl);
        fold_kernel<D, uint32_t><<<dim3(nb, static_cast<unsigned>(K)), kThreads, 0, st>>>(
            src, len, cs, r, m, out, K, partial);
      }
      if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
      ++*launched;
    }
    if (h == 1) {
      e = launch_tail<D>(in, Src<uint32_t>{}, TailFrom::kInputFold, K, nt, tail_threads,
                         h, m, st_out, st_out, rp, cs, finals, tag_round, tag_final, st);
    } else {
      const uint32_t* prev = buf[(h - 2) & 1];
      const long pl = 2 * nt * 4 * K;
      const Src<uint32_t> src = src_of<uint32_t>(prev, prev + pl, prev + 2 * pl);
      e = launch_tail<D>(in, src, TailFrom::kScratchFold, K, nt, tail_threads, h, m,
                         st_out, st_out, rp, cs, finals, tag_round, tag_final, st);
    }
  }
  if (e == cudaSuccess) ++*launched;
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

int sc_set_constants(const uint32_t* rcf, const uint32_t* rcp,
                     const uint32_t* diag) {
  return static_cast<int>(p2::upload_constants(rcf, rcp, diag));
}

// The tail kernels' dynamic shared-memory ceiling on the current device:
// the most any launch asks for (d n_tail 16 B).  Called once per device.
int sc_set_tail_smem(int bytes) {
  const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(tail_kernel<1>, a, bytes)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaFuncSetAttribute(tail_kernel<2>, a, bytes)) != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaFuncSetAttribute(tail_kernel<3>, a, bytes));
}

// Every round of K claims of d factors of length n, and the final
// evaluations: 1 launch for h = 0, else 2 h + 1.  *launched gets the count.
int sc_prove(const int64_t* f0, const int64_t* f1, const int64_t* f2, int d,
             long K, long n, int m, int h, long nt, int nb, int tail_threads,
             uint32_t* scratch, const int64_t* st_in, int64_t* st_out,
             int64_t* rp, int64_t* cs, int64_t* finals, uint32_t tag_round,
             uint32_t tag_final, int* launched, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return prove<1>(f0, f1, f2, K, n, m, h, nt, nb, tail_threads, scratch, st_in,
                            st_out, rp, cs, finals, tag_round, tag_final, launched, st);
    case 2: return prove<2>(f0, f1, f2, K, n, m, h, nt, nb, tail_threads, scratch, st_in,
                            st_out, rp, cs, finals, tag_round, tag_final, launched, st);
    case 3: return prove<3>(f0, f1, f2, K, n, m, h, nt, nb, tail_threads, scratch, st_in,
                            st_out, rp, cs, finals, tag_round, tag_final, launched, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
