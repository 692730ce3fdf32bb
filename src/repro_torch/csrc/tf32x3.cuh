// The 3xTF32 arithmetic on Hopper's tensor cores and the cp.async copies
// that feed it, shared by the float32 tensor-core kernels
// (flash_attention.cu: flash_tf32_kernel; decode_attention.cu:
// decode_tf32_kernel). Both sources include this header; kernels/_build.py
// hashes it into each library's name, so an edit rebuilds both.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The TF32 value nearest a finite x, ties away from zero, as
// cvt.rna.tf32.f32 rounds it, with its 13 low bits cleared: half a TF32
// ulp added to the magnitude bits, then the low bits masked. Two integer
// instructions; cvt.rna.tf32.f32 compiles to four on sm_90a (its NaN check
// among them), for each of the six roundings of a product's operands.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x ~ hi + lo: hi the TF32 rounding of x, lo that of the rest (exact in
// float32 before its own rounding).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a b, m16n8k8, TF32 operands, float32 accumulator.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: a_lo b_hi, a_hi b_lo, then a_hi b_hi, into a zeroed
// temporary that is then added to d in float32 (rounded to nearest). The
// tensor cores round each product step toward zero, relative to the
// accumulator it adds to: fed into d, every step of a long sum would cut
// it short by up to an ulp of d (into O, 3 x Sk / 8 steps: 5x the
// CUDA-core kernel's error at S = 2048); here each step is cut relative to
// the block's own sum of 8 products.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma(t, al, bh0, bh1);
  mma(t, ah, bl0, bl1);
  mma(t, ah, bh0, bh1);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// 16 bytes global -> shared, asynchronously; `bytes` 0 fills zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace tf32
