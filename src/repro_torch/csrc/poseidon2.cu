// K1 — batched Poseidon2 over BabyBear.
//
// Replaces the Pallas kernel src/repro/kernels/poseidon2_kernel.py
// (_kernel / permute_batch, with compress_pairs and hash_rows on top).
//
// Layout: 16 lanes (half a warp) per row, one state word per lane, with the
// warp-cooperative permutation of poseidon2.cuh; blocks of 128 threads
// hold 8 rows.  A row past n computes on a zero state and skips its loads
// and stores: every lane must reach every shuffle.
//
// Bound on this card: operations for the batched calls (one permutation
// is ~2.3k 32-bit integer instructions, 112 Montgomery products, for 128
// bytes read and at most 128 written), latency for the single-row sponges
// of the transcript, whose chunks are a chain of permutations.  Spreading
// a state over 16 lanes shortens that chain (each lane runs its own S-box
// and the linear layers are shuffles) and gives the Merkle leaf hashing
// 16 threads per column.  A whole sponge — all ceil(L/8) absorptions of a
// row, several length-tagged segments back to back — runs inside one
// launch; lanes 0..7 load one chunk (a 64-byte read per row) while the
// previous chunk is permuted.  One launch per Merkle level (compress) and
// one per leaf set (sponge).
#include <cuda_runtime.h>
#include <cstdint>

#include "field.cuh"
#include "poseidon2.cuh"

namespace {

constexpr int kThreads = 128;

// The row this lane works on, and whether it exists.
__device__ __forceinline__ long row_of_lane() {
  return (blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x) / p2::WIDTH;
}

__global__ void permute_kernel(const int64_t* __restrict__ in,
                               int64_t* __restrict__ out, long n) {
  const p2::Lane l = p2::Lane::load();
  const long r = row_of_lane();
  const bool live = r < n;
  uint32_t s = live ? static_cast<uint32_t>(in[r * p2::WIDTH + l.j]) : 0u;
  s = p2::permute(s, l);
  if (live) out[r * p2::WIDTH + l.j] = s;
}

// Row r: start from init[r] (or zeros), then for each of nseg segments of
// L elements add tag_m to the capacity lane RATE and absorb the segment in
// RATE-sized chunks (zero-padded), one permutation per chunk.  Writes the
// first out_width lanes.
__global__ void sponge_kernel(const int64_t* __restrict__ init,
                              const int64_t* __restrict__ elems, long L,
                              long nseg, uint32_t tag_m,
                              int64_t* __restrict__ out, int out_width,
                              long n) {
  const p2::Lane l = p2::Lane::load();
  const long r = row_of_lane();
  const bool live = r < n;
  const bool loads = live && l.j < p2::RATE;
  uint32_t s = (live && init) ? static_cast<uint32_t>(init[r * p2::WIDTH + l.j]) : 0u;
  const int64_t* row = elems + r * L * nseg;
  // chunk (g, c): word c + j of segment g, prefetched one chunk ahead
  long g = 0, c = 0;
  auto fetch = [&](long gg, long cc) -> uint32_t {
    return (loads && gg < nseg && cc + l.j < L)
               ? static_cast<uint32_t>(row[gg * L + cc + l.j]) : 0u;
  };
  if (L == 0) {                         // tags only: no chunk, no permutation
    for (long q = 0; q < nseg; ++q) s = bb::add(s, tag_m & l.cap);
    g = nseg;
  }
  uint32_t next = fetch(0, 0);
  while (g < nseg) {
    const uint32_t v = next;
    const bool first = c == 0;
    long ng = g, nc = c + p2::RATE;
    if (nc >= L) { ng = g + 1; nc = 0; }
    next = fetch(ng, nc);
    if (first) s = bb::add(s, tag_m & l.cap);
    s = p2::permute(bb::add(s, v), l);
    g = ng;
    c = nc;
  }
  if (live && l.j < out_width) out[r * out_width + l.j] = s;
}

// nblocks squeezes: permute, emit the RATE lanes; the final state too.
__global__ void squeeze_kernel(const int64_t* __restrict__ in,
                               int64_t* __restrict__ st_out,
                               int64_t* __restrict__ lanes, int nblocks,
                               long n) {
  const p2::Lane l = p2::Lane::load();
  const long r = row_of_lane();
  const bool live = r < n;
  uint32_t s = live ? static_cast<uint32_t>(in[r * p2::WIDTH + l.j]) : 0u;
  for (int b = 0; b < nblocks; ++b) {
    s = p2::permute(s, l);
    if (live && l.j < p2::RATE) lanes[(r * nblocks + b) * p2::RATE + l.j] = s;
  }
  if (live) st_out[r * p2::WIDTH + l.j] = s;
}

// 2-to-1 compression: permute([left, right])[:8] + left.
__global__ void compress_kernel(const int64_t* __restrict__ left,
                                const int64_t* __restrict__ right,
                                int64_t* __restrict__ out, long n) {
  const p2::Lane l = p2::Lane::load();
  const long r = row_of_lane();
  const bool live = r < n;
  const bool lo = l.j < p2::RATE;
  uint32_t s = 0u;
  if (live)
    s = static_cast<uint32_t>(lo ? left[r * p2::RATE + l.j]
                                 : right[r * p2::RATE + l.j - p2::RATE]);
  const uint32_t feed = s;
  s = p2::permute(s, l);
  if (live && lo) out[r * p2::RATE + l.j] = bb::add(s, feed);
}

}  // namespace

extern "C" {

int p2_set_constants(const uint32_t* rcf, const uint32_t* rcp,
                     const uint32_t* diag) {
  return static_cast<int>(p2::upload_constants(rcf, rcp, diag));
}

// Each launcher takes its grid from the wrapper (poseidon2_kernel.blocks):
// 16 lanes a row, kThreads a block.
int p2_permute(const int64_t* in, int64_t* out, long n, int blocks, void* stream) {
  if (n > 0)
    permute_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        in, out, n);
  return static_cast<int>(cudaGetLastError());
}

int p2_sponge(const int64_t* init, const int64_t* elems, long L, long nseg,
              uint32_t tag_m, int64_t* out, int out_width, long n,
              int blocks, void* stream) {
  if (n > 0)
    sponge_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        init, elems, L, nseg, tag_m, out, out_width, n);
  return static_cast<int>(cudaGetLastError());
}

int p2_squeeze(const int64_t* in, int64_t* st_out, int64_t* lanes, int nblocks,
               long n, int blocks, void* stream) {
  if (n > 0)
    squeeze_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        in, st_out, lanes, nblocks, n);
  return static_cast<int>(cudaGetLastError());
}

int p2_compress(const int64_t* left, const int64_t* right, int64_t* out,
                long n, int blocks, void* stream) {
  if (n > 0)
    compress_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        left, right, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
