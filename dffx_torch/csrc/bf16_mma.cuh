// Building blocks of the bf16 conv kernels (fm_conv.cu, rb2d.cu): input tiles
// staged as bf16, shared-memory fragment loads for mma.sync m16n8k16 bf16, and
// the hi/lo words of an fp32 value.
//
// The bf16 designs keep bf16 in shared memory and run every product on the
// bf16 tensor cores: an activation that is bf16 already is exact there, and
// an fp32 weight or intermediate v goes in as two bf16, v = hi + lo with hi =
// bf16(v) and lo = bf16(v - hi) (2^-16 of |v| off), so a product is x.hi +
// x.lo, or hi.hi + hi.lo + lo.hi for two split operands.  Sums stay fp32 in
// the accumulators and bf16 rounds only the output.  The wrappers pack each
// conv's weights as B fragments of m16n8k16, [k-step][n-tile][lane] as four
// words {hi b0, hi b1, lo b0, lo b1} (kernels.py::_bf16_fragments): one
// 16-byte load a lane and k-step.
#pragma once

#include "mma.cuh"

namespace dffx {

// copies 8 bytes, or writes 8 bytes of 0 when src_bytes is 0
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// Four 8 x 8 b16 matrices: lanes 8i..8i+7 give the row addresses of matrix i,
// and each lane gets of matrix i the word (row lane / 4, columns 2 (lane % 4),
// + 1) in a[i]: with matrices (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15),
// (8-15, 8-15), an m16n8k16 A fragment.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// Two matrices, rows from lanes 0-15: an m16n8k8 A fragment.
__device__ __forceinline__ void ldmatrix_x2(uint32_t& a0, uint32_t& a1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(a0), "=r"(a1)
               : "r"(addr));
}

// the bf16 pair (lo, hi) as one word, lo in the low half, each rounded to nearest
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_low(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_high(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// v0 and v1 as the words hi = bf16(v), lo = bf16(v - hi), v0 in the low halves
__device__ __forceinline__ void split_bf16x2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  hi = bf16x2(v0, v1);
  lo = bf16x2(v0 - bf16_low(hi), v1 - bf16_high(hi));
}

// One part of a split B operand, a.b_hi (LO = 0) or a.b_lo (LO = 1), for the
// warp's first nvalid m-tiles and NB n-tiles; b[nb] = {hi b0, hi b1, lo b0,
// lo b1}.  k8: an m16n8k8 step, whose A is a[j][0..1] and B b.x or b.z.  Two
// MMAs into one accumulator are nvalid * NB MMAs apart.
template <int LO, int MG, int NB>
__device__ __forceinline__ void mma_bf16_part(const uint32_t (&a)[MG][4], const uint4 (&b)[NB],
                                              int nvalid, bool k8, float (&acc)[MG][NB][4]) {
#pragma unroll
  for (int j = 0; j < MG; ++j) {
    if (j >= nvalid) continue;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      if (k8) {
        mma_bf16_k8(acc[j][nb], a[j][0], a[j][1], LO ? b[nb].z : b[nb].x);
      } else {
        mma_bf16(acc[j][nb], a[j], LO ? b[nb].z : b[nb].x, LO ? b[nb].w : b[nb].y);
      }
    }
  }
}

// a.b_hi + a.b_lo: an exact bf16 A against a split B
template <int MG, int NB>
__device__ __forceinline__ void mma_bf16_split_b(const uint32_t (&a)[MG][4], const uint4 (&b)[NB],
                                                 int nvalid, bool k8, float (&acc)[MG][NB][4]) {
  mma_bf16_part<0>(a, b, nvalid, k8, acc);
  mma_bf16_part<1>(a, b, nvalid, k8, acc);
}

// The bf16 tile [CI][IH][IW] (rows IW apart) of slice base, (0, 0) at image
// pixel (gh0, gw0), 0 outside the image.  vec: by cp.async of VE values (8 or
// 16 bytes), which needs gw0 and W multiples of VE and x aligned to them (a
// group is then inside the image or outside it as a whole); else value by
// value through registers.
template <int CI, int IH, int IW, int NT, int VE>
__device__ __forceinline__ void stage_bf16(const __nv_bfloat16* __restrict__ x, int64_t base,
                                           int64_t cstride, __nv_bfloat16* __restrict__ dst,
                                           int gh0, int gw0, int H, int W, bool vec) {
  static_assert((VE == 4 || VE == 8) && IW % VE == 0, "8- or 16-byte groups");
  if (vec) {
    for (int i = threadIdx.x; i < CI * IH * (IW / VE); i += NT) {
      const int c = i / (IH * (IW / VE)), r = i % (IH * (IW / VE));
      const int row = r / (IW / VE), col = r % (IW / VE) * VE;
      const int gh = gh0 + row, gw = gw0 + col;
      const bool inside = in_image(gh, gw, H, W);
      const __nv_bfloat16* src = inside ? x + base + c * cstride + (int64_t)gh * W + gw : x;
      if constexpr (VE == 8) {
        cp_async16(reinterpret_cast<float*>(dst + (c * IH + row) * IW + col),
                   reinterpret_cast<const float*>(src), inside ? 16 : 0);
      } else {
        cp_async8(dst + (c * IH + row) * IW + col, src, inside ? 8 : 0);
      }
    }
  } else {
    const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
    unsigned short* ds = reinterpret_cast<unsigned short*>(dst);
#pragma unroll 4
    for (int i = threadIdx.x; i < CI * IH * IW; i += NT) {
      const int c = i / (IH * IW), r = i % (IH * IW);
      const int gh = gh0 + r / IW, gw = gw0 + r % IW;
      ds[i] = in_image(gh, gw, H, W) ? xs[base + c * cstride + (int64_t)gh * W + gw] : 0;
    }
  }
}

// whether x takes stage_bf16's copies of VE values
inline bool vec_ok_bf16(const void* x, int W, int ve) {
  return W % ve == 0 && reinterpret_cast<uintptr_t>(x) % (2 * ve) == 0;
}

}  // namespace dffx
