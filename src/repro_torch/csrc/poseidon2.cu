// K1 — batched Poseidon2 over BabyBear.
//
// Replaces the Pallas kernel src/repro/kernels/poseidon2_kernel.py
// (_kernel / permute_batch, with compress_pairs and hash_rows on top).
//
// Bound on this card: operations.  One permutation is ~2.3k 32-bit integer
// instructions (21 rounds; 112 Montgomery products) for 128 bytes read and
// at most 128 written, so the integer pipes, not HBM, set the pace.  The
// design keeps each state in 16 registers for all 21 rounds (no shared or
// device memory traffic mid-permutation), takes the round constants from
// __constant__ memory (every thread of a warp reads the same word, the
// broadcast case), and runs a whole sponge — all ceil(L/8) absorptions of a
// row, several length-tagged segments back to back — inside one launch,
// where the Pallas wrapper launched one permutation per chunk from a host
// loop.  One launch per Merkle level (compress) and one per leaf set
// (sponge).
#include <cuda_runtime.h>
#include <cstdint>

#include "field.cuh"
#include "poseidon2.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void permute_kernel(const int64_t* __restrict__ in,
                               int64_t* __restrict__ out, long n) {
  long r = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
  if (r >= n) return;
  uint32_t s[p2::WIDTH];
#pragma unroll
  for (int i = 0; i < p2::WIDTH; ++i) s[i] = static_cast<uint32_t>(in[r * p2::WIDTH + i]);
  p2::permute(s);
#pragma unroll
  for (int i = 0; i < p2::WIDTH; ++i) out[r * p2::WIDTH + i] = s[i];
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
  long r = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
  if (r >= n) return;
  uint32_t s[p2::WIDTH];
#pragma unroll
  for (int i = 0; i < p2::WIDTH; ++i)
    s[i] = init ? static_cast<uint32_t>(init[r * p2::WIDTH + i]) : 0u;
  const int64_t* row = elems + r * L * nseg;
  for (long g = 0; g < nseg; ++g) {
    const int64_t* seg = row + g * L;
    s[p2::RATE] = bb::add(s[p2::RATE], tag_m);
    for (long c = 0; c < L; c += p2::RATE) {
#pragma unroll
      for (int j = 0; j < p2::RATE; ++j) {
        uint32_t v = (c + j < L) ? static_cast<uint32_t>(seg[c + j]) : 0u;
        s[j] = bb::add(s[j], v);
      }
      p2::permute(s);
    }
  }
#pragma unroll
  for (int i = 0; i < p2::WIDTH; ++i)
    if (i < out_width) out[r * out_width + i] = s[i];
}

// nblocks squeezes: permute, emit the RATE lanes; the final state too.
__global__ void squeeze_kernel(const int64_t* __restrict__ in,
                               int64_t* __restrict__ st_out,
                               int64_t* __restrict__ lanes, int nblocks,
                               long n) {
  long r = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
  if (r >= n) return;
  uint32_t s[p2::WIDTH];
#pragma unroll
  for (int i = 0; i < p2::WIDTH; ++i) s[i] = static_cast<uint32_t>(in[r * p2::WIDTH + i]);
  for (int b = 0; b < nblocks; ++b) {
    p2::permute(s);
#pragma unroll
    for (int j = 0; j < p2::RATE; ++j)
      lanes[(r * nblocks + b) * p2::RATE + j] = s[j];
  }
#pragma unroll
  for (int i = 0; i < p2::WIDTH; ++i) st_out[r * p2::WIDTH + i] = s[i];
}

// 2-to-1 compression: permute([left, right])[:8] + left.
__global__ void compress_kernel(const int64_t* __restrict__ left,
                                const int64_t* __restrict__ right,
                                int64_t* __restrict__ out, long n) {
  long r = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
  if (r >= n) return;
  uint32_t s[p2::WIDTH];
  uint32_t l[p2::RATE];
#pragma unroll
  for (int i = 0; i < p2::RATE; ++i) {
    l[i] = static_cast<uint32_t>(left[r * p2::RATE + i]);
    s[i] = l[i];
    s[p2::RATE + i] = static_cast<uint32_t>(right[r * p2::RATE + i]);
  }
  p2::permute(s);
#pragma unroll
  for (int i = 0; i < p2::RATE; ++i) out[r * p2::RATE + i] = bb::add(s[i], l[i]);
}

inline unsigned grid_for(long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int p2_set_constants(const uint32_t* rcf, const uint32_t* rcp,
                     const uint32_t* diag) {
  return static_cast<int>(p2::upload_constants(rcf, rcp, diag));
}

int p2_permute(const int64_t* in, int64_t* out, long n, void* stream) {
  if (n > 0)
    permute_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        in, out, n);
  return static_cast<int>(cudaGetLastError());
}

int p2_sponge(const int64_t* init, const int64_t* elems, long L, long nseg,
              uint32_t tag_m, int64_t* out, int out_width, long n,
              void* stream) {
  if (n > 0)
    sponge_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        init, elems, L, nseg, tag_m, out, out_width, n);
  return static_cast<int>(cudaGetLastError());
}

int p2_squeeze(const int64_t* in, int64_t* st_out, int64_t* lanes, int nblocks,
               long n, void* stream) {
  if (n > 0)
    squeeze_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        in, st_out, lanes, nblocks, n);
  return static_cast<int>(cudaGetLastError());
}

int p2_compress(const int64_t* left, const int64_t* right, int64_t* out,
                long n, void* stream) {
  if (n > 0)
    compress_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        left, right, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
