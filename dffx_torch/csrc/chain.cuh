// Building blocks of the chained (1,3,3)-conv kernels (rb_of.cu, motion_head.cu).
//
// A chained kernel owns one output tile of one focal slice.  Its input tile,
// with one pixel of halo per conv of the chain, sits in shared memory, and
// every conv of the chain reads a shared-memory region and writes the region
// one pixel smaller on each side, until the last conv writes the tile itself.
// A region is [C][RH][RW] floats; its (0, 0) is image pixel (gh0, gw0), which
// may lie outside the image.  Positions outside the image hold 0 in every
// region a later conv reads: that is the next conv's zero padding.
//
// Weights sit in shared memory as [cin][tap][cout] and are read as warp-wide
// broadcasts, four output channels per 16-byte load; every section of the
// weight area starts on a 16-byte boundary (padded with round4).  The wrapper
// packs each conv in that order already, so a block copies it contiguously
// (load_vector): neighbouring threads write neighbouring banks.
#pragma once

#include "common.cuh"

namespace dffx {

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

__device__ __forceinline__ bool in_image(int gh, int gw, int H, int W) {
  return gh >= 0 && gh < H && gw >= 0 && gw < W;
}

template <int NT>
__device__ __forceinline__ void load_vector(const float* __restrict__ g,
                                            float* __restrict__ s, int n) {
  for (int i = threadIdx.x; i < n; i += NT) s[i] = g[i];
}

// acc[co] += v * w[co], the weights read four at a time when CO allows
template <int CO>
__device__ __forceinline__ void fma_row(float v, const float* __restrict__ w,
                                        float (&acc)[CO]) {
  if constexpr (CO % 4 == 0) {
    const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
    for (int q = 0; q < CO / 4; ++q) {
      const float4 k = w4[q];
      acc[4 * q] = fmaf(v, k.x, acc[4 * q]);
      acc[4 * q + 1] = fmaf(v, k.y, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(v, k.z, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(v, k.w, acc[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int co = 0; co < CO; ++co) acc[co] = fmaf(v, w[co], acc[co]);
  }
}

// acc = the (1,3,3) conv of region src ([CI][SH][SW]) at output position (y, x)
// of the region one pixel smaller on each side
template <int CI, int CO, int SH, int SW>
__device__ __forceinline__ void conv3x3_at(const float* __restrict__ src, int y, int x,
                                           const float* __restrict__ w, float (&acc)[CO]) {
  // The weights do not change from one position to the next, so without this
  // barrier the compiler hoists their reads out of the callers' position loops
  // into registers and spills (255 registers and 360 bytes of spills for the
  // 16-channel rb_of_chain, measured on the H100).
  asm volatile("" ::: "memory");
#pragma unroll
  for (int co = 0; co < CO; ++co) acc[co] = 0.f;
  for (int ci = 0; ci < CI; ++ci) {
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        fma_row<CO>(src[(ci * SH + y + ky) * SW + x + kx], &w[(ci * 9 + ky * 3 + kx) * CO],
                    acc);
      }
    }
  }
}

// dst = relu(scale * conv3x3(src) + shift) over the (SH-2) x (SW-2) region whose
// (0, 0) is image pixel (gh0, gw0); 0 outside the image
template <int CI, int CO, int SH, int SW, int NT>
__device__ __forceinline__ void conv_bn_relu_stage(const float* __restrict__ src,
                                                   float* __restrict__ dst,
                                                   const float* __restrict__ w,
                                                   const float* __restrict__ scale,
                                                   const float* __restrict__ shift, int gh0,
                                                   int gw0, int H, int W) {
  constexpr int RH = SH - 2, RW = SW - 2;
  for (int p = threadIdx.x; p < RH * RW; p += NT) {
    const int ry = p / RW, rx = p % RW;
    float acc[CO];
    conv3x3_at<CI, CO, SH, SW>(src, ry, rx, w, acc);
    const bool inside = in_image(gh0 + ry, gw0 + rx, H, W);
#pragma unroll
    for (int co = 0; co < CO; ++co) {
      dst[(co * RH + ry) * RW + rx] = inside ? fmaxf(fmaf(acc[co], scale[co], shift[co]), 0.f) : 0.f;
    }
  }
}

// The input tile [C][RH][RW] of slice base (channel planes cstride apart),
// (0, 0) at image pixel (gh0, gw0), as fp32; 0 outside the image
template <typename T, int C, int RH, int RW, int NT>
__device__ __forceinline__ void load_tile(const T* __restrict__ x, int64_t base,
                                          int64_t cstride, float* __restrict__ dst,
                                          int gh0, int gw0, int H, int W) {
  for (int i = threadIdx.x; i < C * RH * RW; i += NT) {
    const int c = i / (RH * RW), r = i % (RH * RW);
    const int gh = gh0 + r / RW, gw = gw0 + r % RW;
    dst[i] = in_image(gh, gw, H, W) ? load(x, base + c * cstride + (int64_t)gh * W + gw) : 0.f;
  }
}

}  // namespace dffx
