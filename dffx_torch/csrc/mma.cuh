// Tensor-core building blocks of the implicit-GEMM conv kernels (fm_conv.cu,
// motion_head.cu, rb_of.cu, and res_block.cuh for rb_of.cu and rb2d.cu):
// mma.sync m16n8k8 with TF32 operands and fp32 accumulators, in the 3xTF32
// split; srd_attention.cu takes the MMAs, the split and cp.async from here,
// and the bf16 MMAs (m16n8k16, m16n8k8) too.
//
// A conv is a GEMM with M = pixels (m-tiles of 16), N = output channels
// (n-tiles of 8) and K = taps x input channels (k-steps of 8).  Plain TF32
// keeps 10 mantissa bits and misses the kernels' fp32 bound, so each operand
// is split into two TF32 parts, v = hi + lo, and a product is hi.hi + hi.lo +
// lo.hi.  The tensor cores truncate each sum they accumulate, so the two small
// terms go to an accumulator of their own: acc[..][0] takes hi.hi, acc[..][1]
// the rest, and the kernel adds the two at the end.
//
// Fragments of one warp, thread (g, t) = (lane / 4, lane % 4):
//   A (16 x 8):  a0 = (pixel g, k t)   a1 = (pixel g + 8, k t)
//                a2 = (pixel g, k t + 4)  a3 = (pixel g + 8, k t + 4)
//   B (8 x 8):   b0 = (k t, channel g)  b1 = (k t + 4, channel g)
//   C (16 x 8):  c0, c1 = (pixel g, channels 2t, 2t + 1), c2, c3 = pixel g + 8
// The wrappers pack each conv's weights as B fragments, [k-step][n-tile][lane]
// [2] (kernels.py::mma_conv_layout and its relatives), so a block copies them
// into shared memory as they come and a lane reads its two values as one
// 8-byte load.  Activations sit in shared memory as channel planes whose
// stride is 8 (mod 32) floats (plane()): the 8 pixels x 4 channels of an
// A-fragment load hit 32 distinct banks.
#pragma once

#include "common.cuh"

namespace dffx {

// the smallest plane stride >= n that is 8 (mod 32) floats
__host__ __device__ constexpr int plane(int n) { return n + ((8 - n % 32) + 32) % 32; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// copies 16 bytes, or writes 16 bytes of 0 when src_bytes is 0
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// copies 4 bytes, or writes 0 when src_bytes is 0
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_older() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// v = hi + lo exactly, with no conversion instruction: hi is v with its 13 low
// mantissa bits cleared, lo = v - hi stays in fp32, and the tensor cores read
// only a TF32's bits of it (they drop its 13 low mantissa bits, a relative
// 2^-20 of v).  cvt.rna.tf32.f32 runs at a fraction of the FMA pipe's rate and
// bounded the k-loops that used it: on the H100 (700 W) the motion head took
// 4.51 ms with it and 3.74 ms with the mask, at an fp32 error of 1.4e-5
// against 9.5e-6.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d += a b, m16n8k8, TF32 in, fp32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b, m16n8k16, bf16 in (two to a register, the lower k in the low
// half), fp32 accumulator.  A: a0 = (row g, k 2t..2t+1), a1 = (g + 8, 2t..),
// a2 = (g, 2t+8..), a3 = (g + 8, 2t+8..); B: b0 = (k 2t..2t+1, column g),
// b1 = (k 2t+8.., g); C as m16n8k8's.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b, m16n8k8, bf16 in: a0 = (row g, k 2t..2t+1), a1 = (g + 8, 2t..),
// b = (k 2t..2t+1, column g)
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], uint32_t a0, uint32_t a1,
                                            uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// ---------------------------------------------------------------------------
// The k-step: the warp's m-tiles together
// ---------------------------------------------------------------------------

// this k-step's B fragments (NB x 32 lanes x 2), split
template <int NB>
__device__ __forceinline__ void load_b_split(const float2* __restrict__ bfrag, int lane,
                                             uint32_t (&bh)[NB][2], uint32_t (&bl)[NB][2]) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const float2 v = bfrag[nb * 32 + lane];
    split_tf32(v.x, bh[nb][0], bl[nb][0]);
    split_tf32(v.y, bh[nb][1], bl[nb][1]);
  }
}

// the two parts of an A value
__device__ __forceinline__ void load_a(const float* __restrict__ p, uint32_t& hi, uint32_t& lo) {
  split_tf32(p[0], hi, lo);
}

// The three products of one k-step for the warp's first nvalid m-tiles:
// acc[j][nb][0] += A_hi B_hi and acc[j][nb][1] += A_lo B_hi + A_hi B_lo, term
// by term over all m-tiles and n-tiles: two MMAs into one accumulator are
// MG * NB MMAs apart, so none waits for the one before it.
template <int MG, int NB>
__device__ __forceinline__ void mma_3xtf32(const uint32_t (&ah)[MG][4],
                                           const uint32_t (&al)[MG][4],
                                           const uint32_t (&bh)[NB][2],
                                           const uint32_t (&bl)[NB][2], int nvalid,
                                           float (&acc)[MG][NB][2][4]) {
#pragma unroll
  for (int j = 0; j < MG; ++j) {
    if (j < nvalid) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) mma_tf32(acc[j][nb][1], al[j], bh[nb][0], bh[nb][1]);
    }
  }
#pragma unroll
  for (int j = 0; j < MG; ++j) {
    if (j < nvalid) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) mma_tf32(acc[j][nb][0], ah[j], bh[nb][0], bh[nb][1]);
    }
  }
#pragma unroll
  for (int j = 0; j < MG; ++j) {
    if (j < nvalid) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) mma_tf32(acc[j][nb][1], ah[j], bl[nb][0], bl[nb][1]);
    }
  }
}

// One k-step whose A operand thread (g, t) finds at src[pa[j] + o0] (pixel g),
// src[pb[j] + o0] (pixel g + 8) and, for its second k value, at + o1; pa and
// pb already hold the thread's own channel plane t.
template <int MG, int NB>
__device__ __forceinline__ void mma_kstep_at(const float* __restrict__ src, const int (&pa)[MG],
                                             const int (&pb)[MG], int o0, int o1, int nvalid,
                                             const float2* __restrict__ bfrag, int lane,
                                             float (&acc)[MG][NB][2][4]) {
  uint32_t bh[NB][2], bl[NB][2], ah[MG][4], al[MG][4];
  load_b_split<NB>(bfrag, lane, bh, bl);
#pragma unroll
  for (int j = 0; j < MG; ++j) {
    if (j < nvalid) {
      load_a(src + pa[j] + o0, ah[j][0], al[j][0]);
      load_a(src + pb[j] + o0, ah[j][1], al[j][1]);
      load_a(src + pa[j] + o1, ah[j][2], al[j][2]);
      load_a(src + pb[j] + o1, ah[j][3], al[j][3]);
    }
  }
  mma_3xtf32<MG, NB>(ah, al, bh, bl, nvalid, acc);
}

// acc += the (1,3,3) conv of src ([CIN][.] planes P floats apart, rows SW
// wide, CIN a multiple of 8) at the warp's m-tiles; w: the conv's packed
// fragments, [tap][CIN / 8][NB][lane][2]
template <int CIN, int MG, int NB, int P, int SW>
__device__ __forceinline__ void conv3x3_mma(const float* __restrict__ src, const int (&pa)[MG],
                                            const int (&pb)[MG], int nvalid,
                                            const float* __restrict__ w, int lane,
                                            float (&acc)[MG][NB][2][4]) {
  const float2* frag = reinterpret_cast<const float2*>(w);
  auto row = [&](int ky) {
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
      for (int kc = 0; kc < CIN / 8; ++kc) {
        const int o = kc * 8 * P + kx;
        mma_kstep_at<MG, NB>(src + ky * SW, pa, pb, o, o + 4 * P, nvalid,
                             frag + ((ky * 3 + kx) * (CIN / 8) + kc) * NB * 32, lane, acc);
      }
    }
  };
  // At CIN = 8 a tap is one k-step, and the nine of them go into one basic
  // block: loads and MMAs of neighbouring rows overlap (on the H100, 700 W,
  // rb2d_residual 0.532 against 0.548 ms and rb_of_chain's pair 1.07 against
  // 1.14 at 10 x 608 x 1088).  Wider convs keep the row loop: unrolled, the
  // 32-channel block of rb_of_chain took 0.50 ms against 0.38.
  if constexpr (CIN == 8) {
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) row(ky);
  } else {
#pragma unroll 1
    for (int ky = 0; ky < 3; ++ky) row(ky);
  }
}

// ---------------------------------------------------------------------------
// A conv over a region of a tile
// ---------------------------------------------------------------------------

// Where the region positions p (rows RW wide) sit in planes whose rows are SW
// wide, from base: the A-operand offsets of a round's m-tiles.
template <int RW, int SW, int MG>
__device__ __forceinline__ void region_offsets(const int (&p)[MG], int base, int (&o)[MG]) {
#pragma unroll
  for (int j = 0; j < MG; ++j) o[j] = base + p[j] / RW * SW + p[j] % RW;
}

// One conv stage of a block of NW warps over a region of NPOS output
// positions, in m-tiles of 16 consecutive positions: the warp's are warp,
// warp + NW, ..., MG of them per round.  body(p0, p1, nvalid, acc) runs the
// round's k-steps into acc[MG][NB][2][4] (zero at entry), where p0[j] and p1[j]
// are the positions of m-tile j's pixels g and g + 8, clamped to the region;
// epi(p, co, sum) takes each result, co = 8 nb + 2 t + {0, 1}.
template <int NW, int MG, int NB, int NPOS, typename Body, typename Epi>
__device__ __forceinline__ void region_mma(int warp, int lane, Body body, Epi epi) {
  constexpr int M = (NPOS + 15) / 16;
  const int g = lane / 4, t = lane % 4;
  const int mine = (M - warp + NW - 1) / NW;
#pragma unroll 1
  for (int i0 = 0; i0 < mine; i0 += MG) {
    int p0[MG], p1[MG];
#pragma unroll
    for (int j = 0; j < MG; ++j) {
      p0[j] = min((warp + (i0 + j) * NW) * 16 + g, NPOS - 1);
      p1[j] = min(p0[j] + 8, NPOS - 1);
    }
    const int nvalid = min(mine - i0, MG);
    float acc[MG][NB][2][4] = {};
    // a full round gets its count as a constant: its k-loop has no branch
    // around any m-tile, so loads and MMAs of neighbouring k-steps overlap
    if (nvalid == MG) {
      body(p0, p1, MG, acc);
    } else {
      body(p0, p1, nvalid, acc);
    }
#pragma unroll
    for (int j = 0; j < MG; ++j) {
      if (j >= nvalid) continue;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int p = (warp + (i0 + j) * NW) * 16 + g + 8 * (k / 2);
          if (p < NPOS) epi(p, nb * 8 + 2 * t + k % 2, acc[j][nb][0][k] + acc[j][nb][1][k]);
        }
      }
    }
  }
}

// m-tiles a warp takes together in a region_mma stage of NPOS positions: its
// share, in rounds of equal size of at most CAP
__host__ __device__ constexpr int region_mg(int npos, int nw, int cap) {
  const int mt = ((npos + 15) / 16 + nw - 1) / nw;
  const int rounds = (mt + cap - 1) / cap;
  return (mt + rounds - 1) / rounds;
}

// ---------------------------------------------------------------------------
// Input tiles
// ---------------------------------------------------------------------------

// The input tile [CI][IH][IW] (planes P apart, rows SW apart) of slice base,
// (0, 0) at image pixel (gh0, gw0), 0 outside the image, by cp.async.
template <int CI, int IH, int IW, int P, int NT, int SW = IW>
__device__ __forceinline__ void stage_tile(const float* __restrict__ x, int64_t base,
                                           int64_t cstride, float* __restrict__ dst, int gh0,
                                           int gw0, int H, int W) {
  for (int i = threadIdx.x; i < CI * IH * IW; i += NT) {
    const int c = i / (IH * IW), r = i % (IH * IW);
    const int row = r / IW, col = r % IW;
    const int gh = gh0 + row, gw = gw0 + col;
    const bool inside = in_image(gh, gw, H, W);
    const float* src = inside ? x + base + c * cstride + (int64_t)gh * W + gw : x;
    cp_async4(dst + c * P + row * SW + col, src, inside ? 4 : 0);
  }
}

// The same tile by 16-byte cp.async, for a tile whose first column gw0, width
// IW, row stride SW and plane stride P are multiples of 4 floats, of an image
// whose W is one too and whose x is 16-byte aligned: a group of 4 pixels is
// then inside the image or outside it as a whole.
template <int CI, int IH, int IW, int P, int NT, int SW = IW>
__device__ __forceinline__ void stage_tile_vec(const float* __restrict__ x, int64_t base,
                                               int64_t cstride, float* __restrict__ dst,
                                               int gh0, int gw0, int H, int W) {
  static_assert(IW % 4 == 0 && SW % 4 == 0 && P % 4 == 0, "16-byte copies");
  for (int i = threadIdx.x; i < CI * IH * (IW / 4); i += NT) {
    const int c = i / (IH * (IW / 4)), r = i % (IH * (IW / 4));
    const int row = r / (IW / 4), col = r % (IW / 4) * 4;
    const int gh = gh0 + row, gw = gw0 + col;
    const bool inside = in_image(gh, gw, H, W);
    const float* src = inside ? x + base + c * cstride + (int64_t)gh * W + gw : x;
    cp_async16(dst + c * P + row * SW + col, src, inside ? 16 : 0);
  }
}

// The tile by the widest copies x allows.  vec: x is 16-byte aligned and W a
// multiple of 4 (vec_ok).
template <int CI, int IH, int IW, int P, int NT, int SW = IW>
__device__ __forceinline__ void stage_tile_any(const float* __restrict__ x, int64_t base,
                                               int64_t cstride, float* __restrict__ dst,
                                               int gh0, int gw0, int H, int W, bool vec) {
  if (vec) {
    stage_tile_vec<CI, IH, IW, P, NT, SW>(x, base, cstride, dst, gh0, gw0, H, W);
  } else {
    stage_tile<CI, IH, IW, P, NT, SW>(x, base, cstride, dst, gh0, gw0, H, W);
  }
}

inline bool vec_ok(const void* x, int W) {
  return W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

// The launch geometry of a persistent kernel: one block per tile up to as many
// as the card holds at once (SMs x blocks per SM, from the occupancy API).
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, int smem_bytes, int64_t ntiles,
                            int* grid) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem_bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if (ntiles < 1 || ntiles > 0x7fffffff) return cudaErrorInvalidValue;
  *grid = static_cast<int>(ntiles < (int64_t)sms * per_sm ? ntiles : sms * per_sm);
  return cudaSuccess;
}

}  // namespace dffx
