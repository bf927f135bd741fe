// mma.sync building blocks shared by the fp32 flash kernels
// (flash_attention.cu, the forward; flash_attention_bwd_tf32.cu, the
// backward's dK/dV and dQ passes) and the WKV6 backward
// (kernels/rwkv6/csrc/wkv6_bwd.cu): cp.async copies into shared memory,
// ldmatrix, the tf32 mma.sync.m16n8k8, 2^x, the split of an fp32 value
// into the two tf32 values of a 3xTF32 product, and the vector loads of B
// fragments.
//
// Every inline PTX statement of those kernels is here, between the
// `PTX helpers` and `end PTX helpers` marks, so that a host build
// (tools/sm90_emu.py --fp32, --wkv6) can swap the block for its own versions.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- PTX helpers
// 16 bytes from global to shared memory, asynchronously; the bytes past
// src_bytes (0 or 16) are filled with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

// 4 bytes likewise (src_bytes 0 or 4), for vectors whose rows need not
// start on 16 bytes
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the 128-byte line at p into the L2 cache, ahead of its loads
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p));
}

// Four 8 x 4 fp32 matrices (8 x 8 as b16); lane l gives the address of row
// l % 8 of matrix l / 8 (16 contiguous bytes). Lane l receives in x[i] the
// element (row l / 4, column l % 4) of matrix i.
__device__ __forceinline__ void ldsm_x4(const void* row, uint32_t (&x)[4]) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3]) : "r"(a));
}

// d += a b, a 16 x 8 (row), b 8 x 8 (col), tf32 in (the low 13 bits of each
// register are not read), fp32 accumulate. With g = lane / 4, t = lane % 4:
// a holds (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); b holds rows t
// (b0) and t + 4 (b1) of column g; d holds rows g (d[0], d[1]) and g + 8
// (d[2], d[3]) at columns 2t, 2t + 1.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (x <= 0 here; underflow gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// ---- end PTX helpers

// x = hi + lo, lo = x - hi (exact), hi = tf32(x) rounded as cvt.rna.tf32.f32
// rounds (to nearest, ties away from zero; 13 low bits 0) for finite x, by
// an integer add and a mask: cvt.rna's own checks for inf and NaN cost two
// more instructions a value, and these kernels split ~600 values a tile
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// G consecutive floats of one 16- or 8-byte shared-memory load, and the
// i-th of them: a B fragment's values for G n-tiles
template <int G>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  __device__ static float at(const float4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
};
template <>
struct Vec<2> {
  using T = float2;
  __device__ static float at(const float2& v, int i) { return i == 0 ? v.x : v.y; }
};

}  // namespace
