// Shared helpers for the dffx_torch kernels.
//
// Every kernel works on torch's contiguous (B, C, N, H, W) layout: for slice
// (b, n) channel c's H x W plane starts at ((b * C + c) * N + n) * H * W, so
// channel planes of one slice are N * H * W elements apart.  Activations are
// fp32 or bf16 (DFFX_DTYPE_*); weights, BN scale and shift are always fp32,
// and every sum is taken in fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define DFFX_DTYPE_F32 0
#define DFFX_DTYPE_BF16 1
#define DFFX_DTYPE_F16 2  // bn_act.cu alone

namespace dffx {

__device__ __forceinline__ float load(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16(v);
}

__device__ __forceinline__ bool in_image(int gh, int gw, int H, int W) {
  return gh >= 0 && gh < H && gw >= 0 && gw < W;
}

}  // namespace dffx
