// rb2d_residual: the SRD's residual pair of (1,3,3) convs, eval mode.
//
// Replaces the TPU kernel dffx/ops/pallas_kernels.py::rb2d_residual_cf (body
// _rb2d_kernel).  Computes, per focal slice,
//   relu(x + BN2(conv2(relu(BN1(conv1(x))))))
// with two bias-free C -> C (1,3,3) convs at pad 1, on (B, C, N, H, W), for
// C = 8, 16 and 32 (DFFNet serves it at C = 8, full resolution).
//
// What bounds it on the card: 2 x 9 x C^2 FMAs per pixel (1,152 at C = 8,
// 2.3 kFLOP) against 8C bytes of fp32 traffic (64 at C = 8), about 36
// FLOP/byte, above the fp32 ridge of about 20: fp32 FMA issue and the shared
// memory reads that feed it bound it, not HBM.
//
// What the design does about it: a block owns a 32 x 8 output tile of one
// slice.  It stages the input tile plus the pair's 2-pixel halo in shared
// memory (zeros outside the image), computes conv1 -> BN1 -> ReLU over the
// (8+2) x (32+2) region conv2 needs into shared memory, and then conv2 -> BN2,
// the residual add and the ReLU for its own pixels, so the intermediate never
// touches device memory.  Each thread keeps all C output channels of a pixel
// in registers, so one shared-memory read feeds C FMAs; weights sit in shared
// memory ordered [cin][ky][kx][cout] and are read as warp-wide broadcasts.
// conv2 zero-pads ITS input: an intermediate position outside the image is
// set to 0, not to relu(BN1(conv1(padding))), which is nonzero wherever the
// BN1 shift is positive (the TPU kernel masks the same rows and columns).
#include "common.cuh"

namespace {

constexpr int TW = 32, TH = 8;
constexpr int IW = TW + 4, IH = TH + 4;  // input tile with the 2-pixel halo
constexpr int MW = TW + 2, MH = TH + 2;  // conv1 output region, 1-pixel halo

template <int C>
constexpr int smem_floats() {
  return C * IH * IW + C * MH * MW + 2 * 9 * C * C;
}

template <typename T, int C>
__global__ void __launch_bounds__(TW * TH)
rb2d_residual_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                     const float* __restrict__ s1, const float* __restrict__ b1,
                     const float* __restrict__ w2, const float* __restrict__ s2,
                     const float* __restrict__ b2, T* __restrict__ y, int N, int H,
                     int W) {
  extern __shared__ float smem[];
  float* in_s = smem;                  // [C][IH][IW]
  float* mid_s = in_s + C * IH * IW;   // [C][MH][MW]
  float* w1_s = mid_s + C * MH * MW;   // [cin][ky][kx][cout]
  float* w2_s = w1_s + 9 * C * C;

  const int tid = threadIdx.y * TW + threadIdx.x;
  const int nthreads = TW * TH;
  const int b = blockIdx.z / N, n = blockIdx.z % N;
  const int64_t hw = (int64_t)H * W;
  const int64_t cstride = (int64_t)N * hw;
  const int64_t base = ((int64_t)b * C * N + n) * hw;
  const int th0 = blockIdx.y * TH, tw0 = blockIdx.x * TW;

  // torch layout (cout, cin, 1, ky, kx): i = cout * 9C + cin * 9 + k
  for (int i = tid; i < 9 * C * C; i += nthreads) {
    const int j = (i % (9 * C)) * C + i / (9 * C);
    w1_s[j] = w1[i];
    w2_s[j] = w2[i];
  }
  for (int i = tid; i < C * IH * IW; i += nthreads) {
    const int c = i / (IH * IW), r = i % (IH * IW);
    const int gh = th0 - 2 + r / IW, gw = tw0 - 2 + r % IW;
    const bool inside = gh >= 0 && gh < H && gw >= 0 && gw < W;
    in_s[i] = inside ? dffx::load(x, base + c * cstride + (int64_t)gh * W + gw) : 0.f;
  }
  __syncthreads();

  // conv1 -> BN1 -> ReLU over the (TH+2) x (TW+2) region; zero outside the image
  for (int p = tid; p < MH * MW; p += nthreads) {
    const int my = p / MW, mx = p % MW;
    float acc[C];
#pragma unroll
    for (int co = 0; co < C; ++co) acc[co] = 0.f;
    for (int ci = 0; ci < C; ++ci) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float v = in_s[(ci * IH + my + ky) * IW + mx + kx];
          const float* wk = &w1_s[(ci * 9 + ky * 3 + kx) * C];
#pragma unroll
          for (int co = 0; co < C; ++co) acc[co] = fmaf(v, wk[co], acc[co]);
        }
      }
    }
    const int gh = th0 - 1 + my, gw = tw0 - 1 + mx;
    const bool inside = gh >= 0 && gh < H && gw >= 0 && gw < W;
#pragma unroll
    for (int co = 0; co < C; ++co) {
      mid_s[(co * MH + my) * MW + mx] =
          inside ? fmaxf(fmaf(acc[co], s1[co], b1[co]), 0.f) : 0.f;
    }
  }
  __syncthreads();

  // conv2 -> BN2, + centre input, ReLU, for this thread's pixel
  const int ty = threadIdx.y, tx = threadIdx.x;
  float acc[C];
#pragma unroll
  for (int co = 0; co < C; ++co) acc[co] = 0.f;
  for (int ci = 0; ci < C; ++ci) {
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float v = mid_s[(ci * MH + ty + ky) * MW + tx + kx];
        const float* wk = &w2_s[(ci * 9 + ky * 3 + kx) * C];
#pragma unroll
        for (int co = 0; co < C; ++co) acc[co] = fmaf(v, wk[co], acc[co]);
      }
    }
  }
  const int oh = th0 + ty, ow = tw0 + tx;
  if (oh < H && ow < W) {
    const int64_t o = base + (int64_t)oh * W + ow;
#pragma unroll
    for (int co = 0; co < C; ++co) {
      const float centre = in_s[(co * IH + ty + 2) * IW + tx + 2];
      dffx::store(y, o + co * cstride, fmaxf(centre + fmaf(acc[co], s2[co], b2[co]), 0.f));
    }
  }
}

template <typename T, int C>
cudaError_t launch(const void* x, const void* w1, const void* s1, const void* b1,
                   const void* w2, const void* s2, const void* b2, void* y, int B,
                   int N, int H, int W, cudaStream_t stream) {
  const int bytes = smem_floats<C>() * static_cast<int>(sizeof(float));
  // above 48 KB (C >= 16) dynamic shared memory has to be asked for
  cudaError_t err = cudaFuncSetAttribute(
      rb2d_residual_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 block(TW, TH);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * N);
  rb2d_residual_kernel<T, C><<<grid, block, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<T*>(y), N, H, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_c(int C, const void* x, const void* w1, const void* s1,
                       const void* b1, const void* w2, const void* s2, const void* b2,
                       void* y, int B, int N, int H, int W, cudaStream_t stream) {
  switch (C) {
    case 8: return launch<T, 8>(x, w1, s1, b1, w2, s2, b2, y, B, N, H, W, stream);
    case 16: return launch<T, 16>(x, w1, s1, b1, w2, s2, b2, y, B, N, H, W, stream);
    case 32: return launch<T, 32>(x, w1, s1, b1, w2, s2, b2, y, B, N, H, W, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).
extern "C" int dffx_rb2d_residual(const void* x, const void* w1, const void* s1,
                                  const void* b1, const void* w2, const void* s2,
                                  const void* b2, void* y, int B, int C, int N, int H,
                                  int W, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DFFX_DTYPE_F32) {
    return dispatch_c<float>(C, x, w1, s1, b1, w2, s2, b2, y, B, N, H, W, s);
  }
  if (dtype == DFFX_DTYPE_BF16) {
    return dispatch_c<__nv_bfloat16>(C, x, w1, s1, b1, w2, s2, b2, y, B, N, H, W, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
