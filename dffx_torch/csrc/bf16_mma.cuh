// Building blocks of the bf16 conv kernels (fm_conv.cu, rb2d.cu, rb_of.cu,
// motion_head.cu and bf16_res_block.cuh): input tiles staged as bf16,
// shared-memory fragment loads for mma.sync m16n8k16 bf16, the hi/lo words of
// an fp32 value, and convs over a region of a tile from pixel-major planes.
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
//
// A pixel-major tile holds a pixel's C channels (C = 8, 16 or 32) as C / 8
// 16-byte chunks, so that an A register is two channels of one pixel and
// ldmatrix loads a fragment; a (1,3,3) conv over it has K = 9C in the order
// (tap, channel), k-steps of 16 (at C = 8 two taps, the ninth as an m16n8k8
// step).  An intermediate goes there once as two such planes, the hi and lo
// parts of its fp32 values.
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

// Where chunk q (channels 8q .. 8q + 7) of pixel pix of a [pixels][C] bf16
// tile sits, in 16-byte chunks: XOR-swizzled by the pixel, so that chunk q of
// 8 consecutive pixels lies in 8 distinct bank groups.  A tile whose rows are
// RS pixels apart, RS = RW (mod 8) for the reader's region rows of RW
// positions, keeps any 8 consecutive positions on 8 distinct pixels (mod 8).
template <int NCH>
__device__ __forceinline__ int chunk_at(int pix, int q) {
  return pix * NCH + (q ^ (pix / (8 / NCH) % NCH));
}

// The A fragment of k-step s (k = tap * C + channel, tap = 3 dy + dx) of a conv
// over a [pixels][C] bf16 tile at shared-memory address base whose rows are RS
// pixels apart; pix: the pixel that this lane's ldmatrix row (m-tile pixel
// lane % 16) reads at tap (0, 0).  k8: the last k-step at C = 8, a[0..1].
template <int C, int RS>
__device__ __forceinline__ void conv_a(uint32_t base, int pix, int lane, int s, bool k8,
                                       uint32_t (&a)[4]) {
  const int k = 16 * s + (k8 ? 0 : 8 * (lane / 16));
  const int tap = k / C;
  const uint32_t addr = base + 16u * chunk_at<C / 8>(pix + tap / 3 * RS + tap % 3, k % C / 8);
  if (k8) {
    ldmatrix_x2(a[0], a[1], addr);
  } else {
    ldmatrix_x4(a, addr);
  }
}

// k-step s's B fragments of NB n-tiles, {hi b0, hi b1, lo b0, lo b1} a lane
template <int NB>
__device__ __forceinline__ void conv_b(const float* frag, int s, int lane, uint4 (&b)[NB]) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    b[nb] = reinterpret_cast<const uint4*>(frag)[(s * NB + nb) * 32 + lane];
  }
}

// acc += the (1,3,3) conv of a C-channel intermediate (K = 9C) from its hi
// and lo planes ([pixels][C] at hi_at and lo_at, rows RS pixels apart):
// hi.w_hi + hi.w_lo + lo.w_hi for the first nvalid m-tiles, pix[j] their
// lanes' ldmatrix pixels at tap (0, 0) (conv_a); frag: the conv's fragments.
template <int C, int RS, int MG, int NB>
__device__ __forceinline__ void conv3x3_hilo(uint32_t hi_at, uint32_t lo_at, const int (&pix)[MG],
                                             int nvalid, const float* frag, int lane,
                                             float (&acc)[MG][NB][4]) {
  constexpr int KS = (9 * C + 15) / 16;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const bool k8 = 16 * s + 8 >= 9 * C;
    uint4 b[NB];
    conv_b<NB>(frag, s, lane, b);
    uint32_t ah[MG][4], al[MG][4];
#pragma unroll
    for (int j = 0; j < MG; ++j) {
      if (j < nvalid) {
        conv_a<C, RS>(hi_at, pix[j], lane, s, k8, ah[j]);
        conv_a<C, RS>(lo_at, pix[j], lane, s, k8, al[j]);
      }
    }
    mma_bf16_split_b(ah, b, nvalid, k8, acc);
    mma_bf16_part<0>(al, b, nvalid, k8, acc);
  }
}

// One conv stage of a block of NW warps over a region of NPOS positions, in
// m-tiles of 16 consecutive positions: the warp's are warp, warp + NW, ...,
// MG of them a round.  body(m0, nvalid, acc) runs the round's k-steps into
// acc[MG][NB][4] (zero at entry), m0[j] the first position of m-tile j (a
// lane reads position min(m0[j] + row, NPOS - 1)); epi(p, co, v0, v1) takes
// the sums of channels co and co + 1 (co = 8 nb + 2 t) at position p.
template <int NW, int MG, int NB, int NPOS, typename Body, typename Epi>
__device__ __forceinline__ void region_mma_bf16(int warp, int lane, Body body, Epi epi) {
  constexpr int M = (NPOS + 15) / 16;
  const int g = lane / 4, t = lane % 4;
  const int mine = (M - warp + NW - 1) / NW;
#pragma unroll 1
  for (int i0 = 0; i0 < mine; i0 += MG) {
    int m0[MG];
#pragma unroll
    for (int j = 0; j < MG; ++j) m0[j] = (warp + (i0 + j) * NW) * 16;
    const int nvalid = min(mine - i0, MG);
    float acc[MG][NB][4] = {};
    // a full round gets its count as a constant: no branch around an m-tile
    if (nvalid == MG) {
      body(m0, MG, acc);
    } else {
      body(m0, nvalid, acc);
    }
#pragma unroll
    for (int j = 0; j < MG; ++j) {
      if (j >= nvalid) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = m0[j] + g + 8 * h;
        if (p >= NPOS) continue;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          epi(p, nb * 8 + 2 * t, acc[j][nb][2 * h], acc[j][nb][2 * h + 1]);
        }
      }
    }
  }
}

// v0, v1 (channels co, co + 1 = 8 nb + 2t, + 1 of pixel pix) into the hi and
// lo planes of a [pixels][C] tile, as the words that conv_a reads
template <int C>
__device__ __forceinline__ void store_hilo(uint32_t* hi, uint32_t* lo, int pix, int co, float v0,
                                           float v1) {
  uint32_t h, l;
  split_bf16x2(v0, v1, h, l);
  const int w = chunk_at<C / 8>(pix, co / 8) * 4 + co % 8 / 2;
  hi[w] = h;
  lo[w] = l;
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
