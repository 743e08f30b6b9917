// BabyBear (P = 15 * 2^27 + 1) Montgomery arithmetic on 32-bit words,
// R = 2^32.  Shared by every kernel of the port.  Operands are canonical
// residues in [0, P); every function returns a canonical residue, so the
// words equal those of the JAX package bit for bit.
//
// Tensors cross the C interface as int64 (the port's dtype); kernels load
// them into uint32 registers and store them back widened.
#pragma once
#include <cstdint>

namespace bb {

constexpr uint32_t P = 2013265921u;
constexpr uint32_t NEG_P_INV = 2013265919u;   // -P^-1 mod 2^32
constexpr uint32_t R_MOD_P = 268435454u;      // 2^32 mod P  (Montgomery one)

// Conditional subtractions as unsigned minimums: for x < 2P, x - P wraps
// above x exactly when x < P, so min(x, x - P) is x mod P (one VIADDMNMX).
__device__ __forceinline__ uint32_t reduce2p(uint32_t x) { return min(x, x - P); }

// A value the compiler may not fold into its consumers (an empty move).
// Lane masks go through it: from a visible lane test the compiler would
// split code into divergent copies.
__device__ __forceinline__ uint32_t opaque(uint32_t v) {
  uint32_t r;
  asm volatile("mov.b32 %0, %1;" : "=r"(r) : "r"(v));
  return r;
}

// REDC of t < P * 2^32: returns t * 2^-32 mod P.
__device__ __forceinline__ uint32_t redc(uint64_t t) {
  uint32_t m = static_cast<uint32_t>(t) * NEG_P_INV;
  // t + m P < P 2^32 + 2^32 P < 2^64; the low word cancels exactly
  uint32_t u = static_cast<uint32_t>((t + static_cast<uint64_t>(m) * P) >> 32);
  return reduce2p(u);
}

__device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
  return redc(static_cast<uint64_t>(a) * b);   // a b < P^2 < P 2^32
}

// mul(a, b) for a b whose bn = b (-P^-1) mod 2^32 is known ahead: the
// REDC factor m = a bn no longer waits for the product a b.
__device__ __forceinline__ uint32_t mul_pre(uint32_t a, uint32_t b, uint32_t bn) {
  const uint64_t t = static_cast<uint64_t>(a) * b;
  const uint32_t m = a * bn;
  return reduce2p(static_cast<uint32_t>((t + static_cast<uint64_t>(m) * P) >> 32));
}

__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  return reduce2p(a + b);                      // a + b < 2P < 2^32
}

__device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) {
  const uint32_t d = a - b;                    // wraps iff a < b
  return min(d, d + P);
}

// Fp4 = Fp[x] / (x^4 - 11); W4M is 11 in Montgomery form.
constexpr uint32_t W4M = 939524073u;           // 11 * 2^32 mod P

struct f4 {
  uint32_t c[4];
};

__device__ __forceinline__ f4 f4_add(const f4& a, const f4& b) {
  f4 r;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.c[i] = add(a.c[i], b.c[i]);
  return r;
}

__device__ __forceinline__ f4 f4_sub(const f4& a, const f4& b) {
  f4 r;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.c[i] = sub(a.c[i], b.c[i]);
  return r;
}

__device__ __forceinline__ f4 f4_mul(const f4& a, const f4& b) {
  // c_k = sum_{i+j=k} a_i b_j + W4 sum_{i+j=k+4} a_i b_j.  Two products
  // (< 2 P^2 < P 2^32) share one REDC.
  const uint32_t* x = a.c;
  const uint32_t* y = b.c;
  auto m2 = [](uint32_t p, uint32_t q, uint32_t r, uint32_t s) {
    return redc(static_cast<uint64_t>(p) * q + static_cast<uint64_t>(r) * s);
  };
  uint32_t hi0 = add(m2(x[1], y[3], x[2], y[2]), mul(x[3], y[1]));
  uint32_t hi1 = m2(x[2], y[3], x[3], y[2]);
  uint32_t hi2 = mul(x[3], y[3]);
  f4 r;
  r.c[0] = add(mul(x[0], y[0]), mul(W4M, hi0));
  r.c[1] = add(m2(x[0], y[1], x[1], y[0]), mul(W4M, hi1));
  r.c[2] = add(add(m2(x[0], y[2], x[1], y[1]), mul(x[2], y[0])),
               mul(W4M, hi2));
  r.c[3] = add(m2(x[0], y[3], x[1], y[2]), m2(x[2], y[1], x[3], y[0]));
  return r;
}

__device__ __forceinline__ f4 f4_load(const int64_t* p) {
  f4 r;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.c[i] = static_cast<uint32_t>(p[i]);
  return r;
}

__device__ __forceinline__ void f4_store(int64_t* p, const f4& a) {
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = static_cast<int64_t>(a.c[i]);
}

__device__ __forceinline__ f4 f4_zero() {
  f4 r;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.c[i] = 0u;
  return r;
}

}  // namespace bb
