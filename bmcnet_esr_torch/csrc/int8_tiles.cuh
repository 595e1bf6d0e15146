// Building blocks shared by the int8 tensor-core kernels (qconv.cu, qmm.cu):
// mbarrier and bulk-copy wrappers, cp.async, ldmatrix, the s8 mma, and the
// activation quantization with its loads.  Device code only; every rounding
// step is an explicit intrinsic so the results stay bit-equal to the plain
// PyTorch versions.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace int8_tiles {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarrier, bulk copy, cp.async, ldmatrix, mma ---------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Waits for the phase of the given parity to complete.  A wait that never
// ends is a fault of the barrier protocol: it traps (the launch then fails
// with an error) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- quantization -----------------------------------------------------------

// clip(round_half_even(v / s), -127, 127) as a byte: the defining arithmetic,
// an IEEE division, a round-half-even conversion and a clip.  The zero test
// is exact: +-0 / s rounds to 0 for every s the division would not turn into
// NaN, and a zero numerator takes __fdiv_rn off its fast path.
__device__ __forceinline__ uint32_t q8(float v, float s) {
  if (v == 0.0f) return 0u;
  const int q = __float2int_rn(__fdiv_rn(v, s));
  return (uint32_t)min(max(q, -127), 127) & 0xffu;
}

// A lane's scale with what the shortcut below needs: the correctly rounded
// reciprocal, and whether the scale is in the range where the shortcut's
// error bound holds (2^-100 <= |s| <= 2^100, so 1 / s is a normal number).
struct QScale {
  float s, r;
  bool sane;
};
__device__ __forceinline__ QScale make_qscale(float s) {
  QScale q;
  q.s = s;
  q.r = __frcp_rn(s);
  q.sane = fabsf(s) >= 0x1p-100f && fabsf(s) <= 0x1p100f;
  return q;
}

// The shortcut that spares the division (each __fdiv_rn carries a branch to
// its slow path, which keeps the compiler from overlapping the divisions of
// a load).  With t = v / s exact and f its float32 rounding, q0 = v * (1 / s)
// rounded twice lies within 2^-15.3 of t, and f within 2^-17, for |t| <= 201;
// past +-127 both clip to +-127.  So when q0, clamped to +-127, is farther
// than 2^-14 from every half-integer, f lies in the same integer cell and
// rounds to the same integer, which is the low byte of q0 + 1.5 * 2^23 (an
// exact round-half-even: floats there are the integers).  The caller keeps
// the largest distance `dmax` to the rounded integer and a sum `nan` that
// turns NaN when some q0 is NaN or infinite, and takes q8 where
// shortcut_unsure says so.  A zero input gives q0 = 0: sure, and no division.
constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23
__device__ __forceinline__ uint32_t q8_shortcut(float v, const QScale& qs, float& dmax,
                                                float& nan) {
  const float q0 = __fmul_rn(v, qs.r);
  const float qc = fminf(fmaxf(q0, -127.0f), 127.0f);
  const float t = __fadd_rn(qc, kMagic);
  dmax = fmaxf(dmax, fabsf(__fsub_rn(qc, __fsub_rn(t, kMagic))));
  nan = __fmaf_rn(q0, 0.0f, nan);
  return __float_as_uint(t);  // the low byte is the result
}
__device__ __forceinline__ bool shortcut_unsure(const QScale& qs, float dmax, float nan) {
  return !qs.sane || !(dmax < 0.5f - 0x1p-14f) || nan != nan;
}

__device__ __forceinline__ uint32_t q8(float v, const QScale& qs) {
  float dmax = 0.0f, nan = 0.0f;
  const uint32_t b = q8_shortcut(v, qs, dmax, nan) & 0xffu;
  return shortcut_unsure(qs, dmax, nan) ? q8(v, qs.s) : b;
}

// Eight consecutive input values, as loaded.
template <typename T>
struct Vec8;

template <>
struct Vec8<__nv_bfloat16> {
  uint32_t w[4];
  __device__ __forceinline__ void zero() { w[0] = w[1] = w[2] = w[3] = 0u; }
  __device__ __forceinline__ void load16(const __nv_bfloat16* p) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  }
  __device__ __forceinline__ void load_scalar(const __nv_bfloat16* p, int n) {
    const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
    zero();
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < n) w[j >> 1] |= (uint32_t)u[j] << (16 * (j & 1));
  }
  __device__ __forceinline__ float at(int j) const {
    return __uint_as_float((j & 1) ? (w[j >> 1] & 0xffff0000u) : (w[j >> 1] << 16));
  }
};

template <>
struct Vec8<float> {
  float v[8];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = 0.0f;
  }
  __device__ __forceinline__ void load16(const float* p) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  }
  __device__ __forceinline__ void load_scalar(const float* p, int n) {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = j < n ? p[j] : 0.0f;
  }
  __device__ __forceinline__ float at(int j) const { return v[j]; }
};

// Eight loaded values as eight int8 bytes at the scale qs.
template <typename T>
__device__ __forceinline__ uint2 quantize8(const Vec8<T>& raw, const QScale& qs) {
  uint32_t b[8];
  float dmax = 0.0f, nan = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) b[j] = q8_shortcut(raw.at(j), qs, dmax, nan);
  if (shortcut_unsure(qs, dmax, nan)) {
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = q8(raw.at(j), qs.s);
  }
  // the low bytes of four words into one
  return make_uint2(
      __byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3], 0x0040), 0x5410),
      __byte_perm(__byte_perm(b[4], b[5], 0x0040), __byte_perm(b[6], b[7], 0x0040), 0x5410));
}

// ---- the epilogue's stores: two adjacent channels of one pixel --------------

__device__ __forceinline__ void store2(__nv_bfloat16* o, float y0, float y1, const QScale&,
                                       int, bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(o) =
        __halves2bfloat162(__float2bfloat16_rn(y0), __float2bfloat16_rn(y1));
  } else {
    o[0] = __float2bfloat16_rn(y0);
    if (second) o[1] = __float2bfloat16_rn(y1);
  }
}
__device__ __forceinline__ void store2(float* o, float y0, float y1, const QScale&, int,
                                       bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<float2*>(o) = make_float2(y0, y1);
  } else {
    o[0] = y0;
    if (second) o[1] = y1;
  }
}
__device__ __forceinline__ void store2(int8_t* o, float y0, float y1, const QScale& se,
                                       int relu, bool pair, bool second) {
  if (relu) y0 = fmaxf(y0, 0.0f), y1 = fmaxf(y1, 0.0f);
  const uint32_t q0 = q8(y0, se), q1 = q8(y1, se);
  if (pair) {
    *reinterpret_cast<unsigned short*>(o) = (unsigned short)(q0 | (q1 << 8));
  } else {
    o[0] = (int8_t)q0;
    if (second) o[1] = (int8_t)q1;
  }
}

}  // namespace int8_tiles
