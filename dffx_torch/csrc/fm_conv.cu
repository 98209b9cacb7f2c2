// fm_conv_bn_relu: the full-resolution focus-measure conv of DFFNet.
//
// Replaces the TPU kernel dffx/ops/pallas_kernels.py::fm_conv_bn_relu_cf
// (body _fm_conv_kernel).  Computes, per focal slice,
//   Conv3d(3 -> 8, k=(1,9,9), pad=(0,8,8), dil=(1,2,2)) -> eval BN -> ReLU
// on (B, 3, N, H, W) -> (B, 8, N, H, W), with eval BN folded into an fp32
// per-channel (scale, shift).
//
// What bounds it on the card: 243 taps x 8 outputs = 1,944 FMAs (3.9 kFLOP)
// per output pixel against 44 bytes of fp32 traffic (12 read, 32 written),
// about 88 FLOP/byte.  The H100's fp32 ridge without tensor cores is about
// 67 TFLOP/s / 3.35 TB/s = 20 FLOP/byte, so the kernel is bound by fp32 FMA
// issue and by the shared-memory reads that feed the FMAs, not by HBM.
//
// What the design does about it: one thread per output pixel keeps all 8
// output channels in registers, so every input value read from shared memory
// feeds 8 FMAs.  A block stages its 32 x 8 output tile's input plus the
// dilated conv's 8-pixel halo in shared memory once, with zeros outside the
// image (that is the conv's zero padding, and it masks ragged H and W edges),
// so device memory sees each input about 4.5 times, mostly from L2.  The 1,944
// weights sit in shared memory ordered [cin][ky][kx][cout]: each tap is two
// float4 broadcasts shared by the warp.  BN and ReLU are applied in registers.
// Tensor cores (an implicit GEMM with K = 243, N = 8) are later work.
#include "common.cuh"

namespace {

constexpr int TW = 32, TH = 8, HALO = 8;
constexpr int SW = TW + 2 * HALO, SH = TH + 2 * HALO;
constexpr int CIN = 3, COUT = 8, K = 9, TAPS = CIN * K * K;

// at most 128 registers, so two blocks fit on an SM: unrolling all 243 taps
// let the compiler hoist weight loads into 255 registers (with spills) and
// left room for one block
template <typename T>
__global__ void __launch_bounds__(TW * TH, 2)
fm_conv_bn_relu_kernel(const T* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ scale,
                       const float* __restrict__ shift, T* __restrict__ y,
                       int N, int H, int W) {
  __shared__ float tile[CIN][SH][SW];
  __shared__ __align__(16) float ws[TAPS * COUT];

  const int tid = threadIdx.y * TW + threadIdx.x;
  const int b = blockIdx.z / N, n = blockIdx.z % N;
  const int64_t hw = (int64_t)H * W;
  const int64_t cstride = (int64_t)N * hw;
  const T* xs = x + ((int64_t)b * CIN * N + n) * hw;
  T* ys = y + ((int64_t)b * COUT * N + n) * hw;
  const int h0 = blockIdx.y * TH - HALO, w0 = blockIdx.x * TW - HALO;

  // torch layout (cout, cin, 1, ky, kx) -> [cin][ky][kx][cout]
  for (int i = tid; i < TAPS * COUT; i += TW * TH) {
    ws[(i % TAPS) * COUT + i / TAPS] = w[i];
  }
  for (int i = tid; i < CIN * SH * SW; i += TW * TH) {
    const int c = i / (SH * SW), r = i % (SH * SW);
    const int sy = r / SW, sx = r % SW;
    const int gh = h0 + sy, gw = w0 + sx;
    const bool inside = gh >= 0 && gh < H && gw >= 0 && gw < W;
    tile[c][sy][sx] = inside ? dffx::load(xs, c * cstride + (int64_t)gh * W + gw) : 0.f;
  }
  __syncthreads();

  float acc[COUT];
#pragma unroll
  for (int co = 0; co < COUT; ++co) acc[co] = 0.f;
#pragma unroll 1
  for (int c = 0; c < CIN; ++c) {
#pragma unroll 1
    for (int ky = 0; ky < K; ++ky) {
#pragma unroll
      for (int kx = 0; kx < K; ++kx) {
        // tap (ky, kx) of output row h reads input row h + 2 * (ky - 4)
        const float v = tile[c][threadIdx.y + 2 * ky][threadIdx.x + 2 * kx];
        const float4* wv = reinterpret_cast<const float4*>(&ws[((c * K + ky) * K + kx) * COUT]);
        const float4 lo = wv[0], hi = wv[1];
        acc[0] = fmaf(v, lo.x, acc[0]);
        acc[1] = fmaf(v, lo.y, acc[1]);
        acc[2] = fmaf(v, lo.z, acc[2]);
        acc[3] = fmaf(v, lo.w, acc[3]);
        acc[4] = fmaf(v, hi.x, acc[4]);
        acc[5] = fmaf(v, hi.y, acc[5]);
        acc[6] = fmaf(v, hi.z, acc[6]);
        acc[7] = fmaf(v, hi.w, acc[7]);
      }
    }
  }

  const int oh = blockIdx.y * TH + threadIdx.y, ow = blockIdx.x * TW + threadIdx.x;
  if (oh < H && ow < W) {
    const int64_t o = (int64_t)oh * W + ow;
#pragma unroll
    for (int co = 0; co < COUT; ++co) {
      dffx::store(ys, co * cstride + o, fmaxf(fmaf(acc[co], scale[co], shift[co]), 0.f));
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int dffx_fm_conv_bn_relu(const void* x, const void* w, const void* scale,
                                    const void* shift, void* y, int B, int N, int H,
                                    int W, int dtype, void* stream) {
  const dim3 block(TW, TH);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  if (dtype == DFFX_DTYPE_F32) {
    fm_conv_bn_relu_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), wf, sc, sh, static_cast<float*>(y), N, H, W);
  } else if (dtype == DFFX_DTYPE_BF16) {
    fm_conv_bn_relu_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), wf, sc, sh,
        static_cast<__nv_bfloat16*>(y), N, H, W);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
