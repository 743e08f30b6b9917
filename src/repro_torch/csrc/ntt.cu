// K2 — batched radix-2 NTT along rows, and the Reed-Solomon encoding of
// unpadded rows that the PCS commits.
//
// Replaces the Pallas kernel src/repro/kernels/ntt_kernel.py
// (_kernel / ntt_rows), whose wrapper bit-reversed each row on the host,
// and the zero padding that src/repro/core/pcs.py and core/ntt.py apply
// before it.
//
// Bound on this card: bytes, with the butterflies close behind.  An RS
// encode of an (r, c) message at rate 1/B reads 8 r c bytes and writes
// 8 r c B (int64 words); each of its r (c B / 2) log2 c butterflies costs a
// product by a twiddle and two modular sums, 8 integer instructions, and
// every word of a pass an index and a shared-memory load and store, so at
// the main path's shapes the instructions take about as long as the
// memory: the data must move once and the index work must fold away.
// The design:
// - One source for both entries.  The iterative radix-2 DIT on a
//   bit-reversed row: on a zero-padded row (RS encode) the first L =
//   log2 B stages only copy each message word to B places, so the kernel
//   reads the c message words, takes position p's word to be
//   msg[rev(p >> L)], and starts at stage L.  The plain NTT is L = 0: its
//   rows are staged bit-reversed straight into the buffer the passes use,
//   so a row takes 4 n bytes of shared memory (4 (n + c) for an encode,
//   whose message is staged apart) and n = 2^15 fits either way.
// - Stages in registers.  A pass runs up to four stages on 16 words a
//   thread (positions that differ in the pass's four bits), with no
//   barrier; shared memory carries only the exchange between passes, in a
//   layout swizzled so that a warp's 32 words fall in distinct banks
//   (checked for the shapes of the main path).  At n = 4096, L = 2: 3
//   passes and 2 barriers where the previous kernel had 12.
// - The message rows are staged in shared memory with 16-byte loads
//   (coalesced for an encode; for the plain transform a warp's lanes take
//   pairs n / 32 words apart, so that the bit-reversed stores fall in 32
//   banks); the last pass writes the output rows from registers, 32 lanes
//   on 32 consecutive words.  Blocks are persistent (as many as the card
//   holds at once) and load the next row group's message into registers
//   while they transform the current one, so loads, butterflies and
//   stores of different groups overlap.
// - Twiddles come from a stage-major table ({w, w'} at 2^s + j, w =
//   w_{2^(s+1)}^j), so a warp's twiddle loads hit consecutive or equal
//   entries; the product by a twiddle is Shoup's (w' = floor(w 2^32 / P):
//   four 32-bit instructions, no 64-bit product); no division by n.
// - Short rows are packed several to a group, so that a block of 256
//   threads has 16 words per thread.
// - Every row length the card takes (n = 2^1 .. 2^15) runs an instance
//   with log2 n and L fixed at compile time, for the plain transform (L =
//   0) and for the RS encode at the PCS's rate 1/4 (L = 2, the default
//   PCSParams.blowup): with every pass's first stage known, each word's
//   index is one xor and each store offset an immediate (see `pass`).
//   Other blowups run the instance that reads both at run time.
// - Rows longer than 2^15 words (up to 2^20) take two launches.  On a
//   bit-reversed row of n = 2^(15 + k) words, the first 15 DIT stages are
//   2^k independent 2^15-point transforms on contiguous blocks, block b
//   transforming the words at stride 2^k from offset rev_k(b) (for an
//   encode: of the message, an encode of c / 2^k words at the same
//   blowup), with the stage table's first 2^15 rows.  The first launch runs
//   them as 2^k "virtual rows" a row through the 2^15 instances
//   (SPLIT = true: the message is gathered at that stride), writing each
//   block where it lies in the output row; the second (`top_kernel`) runs
//   the top k stages over global memory, a thread holding the 2^k words
//   2^15 apart, and scales an inverse transform by n^-1.
#include <cuda_runtime.h>
#include <cstdint>
#include <initializer_list>
#include <utility>

#include "field.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxR = 4;                 // stages per pass: 16 words a thread
constexpr int kMaxLogN = 15;             // 4 n bytes a row: 2^15 words fit a block
constexpr int kRsL = 2;                  // log2 of the PCS's default blowup
constexpr int kMaxSplit = 5;             // long rows: 2^kMaxSplit blocks of 2^15 words

// Shared-memory layouts: XOR the low five bits (the bank) with higher bits
// of the index, inside each aligned run of 32 words.
__device__ __forceinline__ int swz_main(int a) { return a ^ ((a >> 4) & 31); }
__device__ __forceinline__ int swz_src(int a) { return a ^ ((a >> 5) & 31); }

__device__ __forceinline__ int rev_bits(int q, int bits) {
  return static_cast<int>(__brev(static_cast<unsigned>(q)) >> (32 - bits));
}

// x * w mod P for a twiddle w < P given with w' = floor(w 2^32 / P)
// (Shoup): q = floor(x w' / 2^32) leaves x w - q P in [0, 2P), computed
// exactly in 32 bits since 2P < 2^32.  The twiddles are plain residues, so
// a Montgomery-form x stays in Montgomery form: the words equal bb::mul(x,
// w R) of the JAX package's Montgomery twiddles.
__device__ __forceinline__ uint32_t mul_shoup(uint32_t x, uint2 w) {
  const uint32_t q = __umulhi(x, w.y);
  return bb::reduce2p(x * w.x - q * bb::P);
}

struct Row {
  int64_t* out;           // the row group's first output row (n words a row)
  const uint2* tw;        // {w, w'} at 2^s + j, n entries
  uint32_t* src;          // shared: staged message rows, c words each (L > 0)
  uint32_t* buf;          // shared: the rows between passes, n words each
  int nrows;
  bool inverse;
  uint32_t n_inv_m;
};

// One pass: stages s0 .. s0 + R - 1 on every group of 2^R positions of the
// group's rows.  A virtual thread v of a row holds the positions
// pb | (b << s0), b < 2^R, where pb spreads v's bits over the bits outside
// the pass.  FIRST reads an encode's message, LAST writes the output.
// Every map from a position to a shared-memory word (bit reversal, the
// swizzles) is linear over GF(2) and pb, b << s0 have no bit in common, so
// a word's index is the index of pb xor a per-b constant: with s0, log_n
// and L known at compile time, one xor per word.
template <int R, bool FIRST, bool LAST>
__device__ __forceinline__ void pass(const Row rw, const int s0, const int log_n,
                                     const int L) {
  constexpr int T = 1 << R;
  const int lc = log_n - L;               // log2 c
  const int vshift = log_n - R;           // virtual threads per row: 2^vshift
  const int nv = rw.nrows << vshift;
  const int lowmask = (1 << s0) - 1;
  for (int vt = threadIdx.x; vt < nv; vt += blockDim.x) {
    const int row = vt >> vshift;
    const int v = vt & ((1 << vshift) - 1);
    const int pb = (v & lowmask) | ((v >> s0) << (s0 + R));
    uint32_t x[T];
    if (FIRST) {
      const uint32_t* s = rw.src + (row << lc);
      const int ib = swz_src(rev_bits(pb >> L, lc));
#pragma unroll
      for (int b = 0; b < T; ++b) x[b] = s[ib ^ swz_src(rev_bits((b << s0) >> L, lc))];
    } else {
      const uint32_t* s = rw.buf + (row << log_n);
      const int ib = swz_main(pb);
#pragma unroll
      for (int b = 0; b < T; ++b) x[b] = s[ib ^ swz_main(b << s0)];
    }
    const int jlow = pb & lowmask;
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const uint2* tws = rw.tw + (1 << (s0 + t)) + jlow;
#pragma unroll
      for (int bl = 0; bl < (1 << t); ++bl) {
        const uint2 w = __ldg(tws + (bl << s0));
#pragma unroll
        for (int bh = 0; bh < (T >> (t + 1)); ++bh) {
          const int b = bl | (bh << (t + 1));
          const uint32_t lo = x[b];
          const uint32_t y = mul_shoup(x[b | (1 << t)], w);
          x[b] = bb::add(lo, y);
          x[b | (1 << t)] = bb::sub(lo, y);
        }
      }
    }
    if (LAST) {
      int64_t* o = rw.out + (static_cast<long>(row) << log_n) + pb;
#pragma unroll
      for (int b = 0; b < T; ++b) {
        const uint32_t y = rw.inverse ? bb::mul(x[b], rw.n_inv_m) : x[b];
        o[b << s0] = static_cast<int64_t>(y);
      }
    } else {
      uint32_t* d = rw.buf + (row << log_n);
      const int ib = swz_main(pb);
#pragma unroll
      for (int b = 0; b < T; ++b) d[ib ^ swz_main(b << s0)] = x[b];
    }
  }
}

template <bool FIRST, bool LAST>
__device__ __forceinline__ void pass_r(const Row rw, const int s0, const int r,
                                       const int log_n, const int L) {
  switch (r) {
    case 1: pass<1, FIRST, LAST>(rw, s0, log_n, L); break;
    case 2: pass<2, FIRST, LAST>(rw, s0, log_n, L); break;
    case 3: pass<3, FIRST, LAST>(rw, s0, log_n, L); break;
    default: pass<4, FIRST, LAST>(rw, s0, log_n, L); break;
  }
}

// The k = log_n - L stages after the copies, in passes of nearly equal
// length (at most kMaxR stages each); pass q starts at stage
// L + q base + min(q, extra).
template <int LOG_N, int LL, int Q>
__device__ __forceinline__ void passes_fixed(const Row rw) {
  constexpr int k = LOG_N - LL;
  constexpr int np = (k + kMaxR - 1) / kMaxR;
  constexpr int base = k / np, extra = k % np;
  if constexpr (Q < np) {
    constexpr int r = base + (Q < extra ? 1 : 0);
    constexpr int s0 = LL + Q * base + (Q < extra ? Q : extra);
    pass<r, (Q == 0 && LL > 0), (Q == np - 1)>(rw, s0, LOG_N, LL);
    if constexpr (Q < np - 1) {
      __syncthreads();
      passes_fixed<LOG_N, LL, Q + 1>(rw);
    }
  }
}

__device__ __forceinline__ void passes_any(const Row rw, const int log_n, const int L) {
  const int k = log_n - L;
  const int np = (k + kMaxR - 1) / kMaxR;
  const int base = k / np, extra = k % np;
  int s0 = L;
  for (int q = 0; q < np; ++q) {
    const int r = base + (q < extra ? 1 : 0);
    const bool first = q == 0, last = q == np - 1;
    if (first && last) pass_r<true, true>(rw, s0, r, log_n, L);
    else if (first) pass_r<true, false>(rw, s0, r, log_n, L);
    else if (last) pass_r<false, true>(rw, s0, r, log_n, L);
    else pass_r<false, false>(rw, s0, r, log_n, L);
    s0 += r;
    if (!last) __syncthreads();
  }
}

constexpr int kPrefetch = 2;   // 16-byte message loads a thread keeps in flight (pre0, pre1)

// rows x c message words in, rows x n words out, n = c << L.  L = 0 with
// inverse = 1 is the inverse transform (scaled by n^-1).  LOG_N > 0 fixes
// log_n = LOG_N and L = LL at compile time; 0 takes them from the
// arguments and serves only encodes (L > 0): every plain transform has a
// fixed instance.  Blocks are persistent: block b takes row
// groups b, b + gridDim.x, ... of rows_per_block rows each, and loads the
// next group's message (its first kPrefetch x 16 bytes a thread) into
// registers while it transforms the current one.
//
// SPLIT: the first launch of a long row (log_n = 15 here).  "rows" are then
// the virtual rows, 2^split per row of 2^(15 + split) words: virtual row
// v = r 2^split + b reads the message words b' + j 2^split of row r (b' =
// rev_split(b)) and writes words b 2^15 .. (b + 1) 2^15 - 1 of output row r,
// which is the v-th run of 2^15 words of the output.
template <int LOG_N, int LL, bool SPLIT = false>
__global__ void __launch_bounds__(kThreads, 4)
ntt_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
           const uint2* __restrict__ tw, long rows, int log_n_arg, int L_arg,
           int rows_per_block, int inverse, uint32_t n_inv_m, int split) {
  extern __shared__ uint32_t sh[];
  const int log_n = LOG_N ? LOG_N : log_n_arg;
  const int L = LOG_N ? LL : L_arg;
  constexpr bool plain = LOG_N > 0 && LL == 0;
  const int lc = log_n - L;
  const int c = 1 << lc;
  const long groups = (rows + rows_per_block - 1) / rows_per_block;
  Row rw;
  rw.tw = tw;
  rw.src = sh;
  rw.buf = plain ? sh : sh + (static_cast<long>(rows_per_block) << lc);
  rw.inverse = inverse != 0;
  rw.n_inv_m = n_inv_m;
  // 16-byte loads when every group's run of words is 16-byte aligned (then
  // a pair never crosses a row of >= 2 words); else one word at a time
  const bool vec = !SPLIT && c >= 2 && (reinterpret_cast<uintptr_t>(in) & 15) == 0;
  // The group's word e of the thread's t-th pair of message words.  The
  // plain transform stores word i of a row at position rev(i): there lane l
  // of a warp takes a pair whose top five index bits are l, so that the
  // reversed positions differ in their low five bits, which swz_main keeps
  // in 32 distinct banks.
  constexpr bool spread = plain && LOG_N >= 6;
  constexpr int qb = spread ? LOG_N - 1 : 0, hs = spread ? LOG_N - 6 : 0;  // 2^qb pairs a row
  auto pair_at = [&](int t) -> int {
    if (!spread) return 2 * t;
    const int u = t & ((1 << qb) - 1);
    return ((t >> qb) << log_n) + 2 * (((u & 31) << hs) | (u >> 5));
  };
  auto put = [&](int e, uint32_t w) {
    const int r = e >> lc, i = e & (c - 1);
    if (plain) rw.buf[(r << log_n) + swz_main(rev_bits(i, log_n))] = w;
    else rw.src[(r << lc) + swz_src(i)] = w;
  };

  longlong2 pre0 = make_longlong2(0, 0), pre1 = make_longlong2(0, 0);
  auto prefetch = [&](long g) {           // the first kPrefetch pairs a thread of group g
    const long rem = rows - g * rows_per_block;
    const long total = (rem < rows_per_block ? rem : rows_per_block) << lc;
    const int64_t* gin = in + ((g * rows_per_block) << lc);
    if (2 * threadIdx.x + 1 < total)
      pre0 = __ldg(reinterpret_cast<const longlong2*>(gin + pair_at(threadIdx.x)));
    if (2 * (threadIdx.x + kThreads) + 1 < total)
      pre1 = __ldg(reinterpret_cast<const longlong2*>(gin + pair_at(threadIdx.x + kThreads)));
  };
  if (vec && blockIdx.x < groups) prefetch(blockIdx.x);
  for (long g = blockIdx.x; g < groups; g += gridDim.x) {
    const long row0 = g * rows_per_block;
    const long rem = rows - row0;
    const int nrows = rem < rows_per_block ? static_cast<int>(rem) : rows_per_block;
    const int total = nrows << lc;
    const int64_t* gin = in + (row0 << lc);
    rw.out = out + (row0 << log_n);
    rw.nrows = nrows;
    // stage the message: the prefetched pairs, then the rest
    int done = 0;
    if (vec) {
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        const int t = threadIdx.x + u * kThreads;
        if (2 * t + 1 < total) {
          const longlong2 w = u == 0 ? pre0 : pre1;
          const int e = pair_at(t);
          put(e, static_cast<uint32_t>(w.x));
          put(e + 1, static_cast<uint32_t>(w.y));
        }
      }
      for (int t = threadIdx.x + kPrefetch * kThreads; 2 * t + 1 < total; t += kThreads) {
        const int e = pair_at(t);
        const longlong2 w = __ldg(reinterpret_cast<const longlong2*>(gin + e));
        put(e, static_cast<uint32_t>(w.x));
        put(e + 1, static_cast<uint32_t>(w.y));
      }
      done = total & ~1;
    }
    if constexpr (SPLIT) {               // the message at stride 2^split
      const int bmask = (1 << split) - 1;
      for (int e = threadIdx.x; e < total; e += kThreads) {
        const long v = row0 + (e >> lc);
        const int64_t* rin = in + ((v >> split) << (lc + split))
                             + rev_bits(static_cast<int>(v & bmask), split);
        put(e, static_cast<uint32_t>(__ldg(rin + (static_cast<long>(e & (c - 1)) << split))));
      }
    } else {
      for (int e = done + threadIdx.x; e < total; e += kThreads)
        put(e, static_cast<uint32_t>(__ldg(gin + e)));
    }
    __syncthreads();
    if (vec && g + gridDim.x < groups) prefetch(g + gridDim.x);   // in flight during the passes

    if (lc == 0) {                         // c = 1 (L = log_n): every word is the message word
      for (int e = threadIdx.x; e < (nrows << log_n); e += kThreads)
        rw.out[e] = static_cast<int64_t>(rw.src[e >> log_n]);
    } else {
      if constexpr (LOG_N > 0) passes_fixed<LOG_N, LL, 0>(rw);
      else passes_any(rw, log_n, L);
    }
    __syncthreads();                       // src and buf are free for the next group
  }
}

// The top K stages of a long row (second launch), in place: thread (r, i)
// holds words i + t 2^15 of row r, t < 2^K, and runs stages 15 .. 14 + K on
// them in registers (stage 15 + s pairs t and t | 2^s with the twiddle
// row 2^(15 + s) + i + (t mod 2^s) 2^15); an inverse is scaled by n^-1.
// Consecutive threads take consecutive i: every load and store coalesces.
template <int K>
__global__ void __launch_bounds__(kThreads)
top_kernel(int64_t* __restrict__ x, const uint2* __restrict__ tw, long rows,
           int inverse, uint32_t n_inv_m) {
  constexpr int T = 1 << K;
  constexpr int S = kMaxLogN;
  const long total = rows << S;
  for (long t = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x; t < total;
       t += static_cast<long>(gridDim.x) * blockDim.x) {
    const int i = static_cast<int>(t & ((1 << S) - 1));
    int64_t* p = x + ((t >> S) << (S + K)) + i;
    uint32_t v[T];
#pragma unroll
    for (int b = 0; b < T; ++b) v[b] = static_cast<uint32_t>(p[static_cast<long>(b) << S]);
#pragma unroll
    for (int s = 0; s < K; ++s) {
#pragma unroll
      for (int bl = 0; bl < (1 << s); ++bl) {
        const uint2 w = __ldg(tw + (1 << (S + s)) + (bl << S) + i);
#pragma unroll
        for (int bh = 0; bh < (T >> (s + 1)); ++bh) {
          const int b = bl | (bh << (s + 1));
          const uint32_t lo = v[b];
          const uint32_t y = mul_shoup(v[b | (1 << s)], w);
          v[b] = bb::add(lo, y);
          v[b | (1 << s)] = bb::sub(lo, y);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < T; ++b)
      p[static_cast<long>(b) << S] = static_cast<int64_t>(inverse ? bb::mul(v[b], n_inv_m) : v[b]);
  }
}

using Kern = void (*)(const int64_t*, int64_t*, const uint2*, long, int, int,
                     int, int, uint32_t, int);
using TopKern = void (*)(int64_t*, const uint2*, long, int, uint32_t);

// t[log_n] = the instance with (log_n, LL) fixed, for every log_n in
// (LL, kMaxLogN]; the run-time instance elsewhere.
template <int LL, int... I>
void fill(Kern* t, std::integer_sequence<int, I...>) {
  ((t[I] = ntt_kernel<(I > LL ? I : 0), (I > LL ? LL : 0)>), ...);
}

template <int... I>
void fill_top(TopKern* t, std::integer_sequence<int, I...>) {
  ((t[I] = top_kernel<(I > 0 ? I : 1)>), ...);
}

struct Instances {
  Kern plain[kMaxLogN + 1], rs[kMaxLogN + 1];
  TopKern top[kMaxSplit + 1];                  // top[k], 1 <= k <= kMaxSplit
  Instances() {
    fill<0>(plain, std::make_integer_sequence<int, kMaxLogN + 1>());
    fill<kRsL>(rs, std::make_integer_sequence<int, kMaxLogN + 1>());
    fill_top(top, std::make_integer_sequence<int, kMaxSplit + 1>());
  }
  Kern pick(int log_n, int L) const {          // 1 <= log_n <= kMaxLogN
    return L == 0 ? plain[log_n] : L == kRsL ? rs[log_n] : ntt_kernel<0, 0>;
  }
  // the first launch of a long row: a 2^15 instance that gathers
  Kern pick_split(int L) const {
    return L == 0 ? ntt_kernel<kMaxLogN, 0, true>
         : L == kRsL ? ntt_kernel<kMaxLogN, kRsL, true> : ntt_kernel<0, 0, true>;
  }
};

const Instances& instances() {
  static const Instances t;
  return t;
}

}  // namespace

extern "C" {

// Largest dynamic shared memory a block may use on sm_90.
int ntt_max_shared_bytes() { return 232448; }

// Raise the kernel's dynamic shared-memory ceiling to the card's maximum,
// once per device (never per launch, so concurrent callers cannot change
// it under each other).
int ntt_set_max_smem() {
  const cudaFuncAttribute a = cudaFuncAttributeMaxDynamicSharedMemorySize;
  const int bytes = ntt_max_shared_bytes();
  const Instances& t = instances();
  cudaError_t e = cudaFuncSetAttribute(ntt_kernel<0, 0>, a, bytes);
  for (int L : {0, kRsL, 1})                  // 1: any other, the run-time instance
    if (e == cudaSuccess) e = cudaFuncSetAttribute(t.pick_split(L), a, bytes);
  for (int i = 0; i <= kMaxLogN && e == cudaSuccess; ++i) {
    e = cudaFuncSetAttribute(t.plain[i], a, bytes);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(t.rs[i], a, bytes);
  }
  return static_cast<int>(e);
}

// rows x (n >> L) int64 words in, rows x n out (n = 2^log_n).  tw: the
// stage-major table of n {w, w'} pairs.  L = 0 is the plain transform
// (inverse: 0 or 1), L > 0 the RS encode of unpadded rows at blowup 2^L.
// The grid is as many persistent blocks as the card holds at once.
int ntt_rows(const int64_t* in, int64_t* out, const uint32_t* tw, long rows,
             int log_n, int L, int rows_per_block, int inverse,
             uint32_t n_inv_m, void* stream) {
  if (rows == 0) return 0;
  if (log_n < 1 || log_n > kMaxLogN || L < 0 || L > log_n || rows_per_block < 1 ||
      (inverse && L))
    return static_cast<int>(cudaErrorInvalidValue);
  // the plain transform stages its rows in the passes' buffer, an encode
  // its message apart
  const size_t n = static_cast<size_t>(1) << log_n;
  const size_t words = n + (L ? n >> L : 0);
  const size_t shmem = sizeof(uint32_t) * words * rows_per_block;
  if (shmem > static_cast<size_t>(ntt_max_shared_bytes()))
    return static_cast<int>(cudaErrorInvalidValue);
  const Kern kern = instances().pick(log_n, L);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, shmem)) != cudaSuccess)
    return static_cast<int>(e);
  const long groups = (rows + rows_per_block - 1) / rows_per_block;
  long grid = static_cast<long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (grid > groups) grid = groups;
  kern<<<static_cast<unsigned>(grid), kThreads, shmem, static_cast<cudaStream_t>(stream)>>>(
      in, out, reinterpret_cast<const uint2*>(tw), rows, log_n, L, rows_per_block, inverse, n_inv_m,
      0);
  return static_cast<int>(cudaGetLastError());
}

// Long rows, 2^15 < n = 2^log_n <= 2^(15 + kMaxSplit): rows x (n >> L)
// words in, rows x n out, in two launches (see the header).  tw: the
// stage-major table of n {w, w'} pairs; the first launch reads its first
// 2^15 rows.  An encode's message must hold at least 2^(log_n - 15) words.
int ntt_rows_long(const int64_t* in, int64_t* out, const uint32_t* tw, long rows,
                  int log_n, int L, int inverse, uint32_t n_inv_m, void* stream) {
  if (rows == 0) return 0;
  const int k = log_n - kMaxLogN;
  if (k < 1 || k > kMaxSplit || L < 0 || L > kMaxLogN || (inverse && L))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t m = static_cast<size_t>(1) << kMaxLogN;
  const size_t shmem = sizeof(uint32_t) * (m + (L ? m >> L : 0));
  if (shmem > static_cast<size_t>(ntt_max_shared_bytes()))
    return static_cast<int>(cudaErrorInvalidValue);
  const Instances& t = instances();
  const Kern kern = t.pick_split(L);
  const TopKern top = t.top[k];
  int dev = 0, sms = 0, per_sm = 0, top_per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, shmem)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&top_per_sm, top, kThreads, 0)) != cudaSuccess)
    return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long vrows = rows << k;
  long grid = static_cast<long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (grid > vrows) grid = vrows;
  kern<<<static_cast<unsigned>(grid), kThreads, shmem, st>>>(
      in, out, reinterpret_cast<const uint2*>(tw), vrows, kMaxLogN, L, 1, 0, n_inv_m, k);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const long blocks = ((rows << kMaxLogN) + kThreads - 1) / kThreads;
  long tgrid = static_cast<long>(sms) * (top_per_sm > 0 ? top_per_sm : 1);
  if (tgrid > blocks) tgrid = blocks;
  top<<<static_cast<unsigned>(tgrid), kThreads, 0, st>>>(
      out, reinterpret_cast<const uint2*>(tw), rows, inverse, n_inv_m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
