// srd_attention_residual: the SRD's focus-axis attention, eval mode.
//
// Replaces the TPU kernel dffx/ops/pallas_kernels.py::srd_attention_residual_cf
// (body _srd_attn_kernel).  Computes
//   out = f + relu(W1 . relu(Wn . [f(n-1); f(n); f(n+1)]))
// where Wn is a bias-free (3,1,1) C -> C conv over the focus axis N with pad 1
// (the neighbours are zero beyond the stack ends) and W1 a bias-free 1x1 C -> C
// conv.  It is pointwise in space; in and out are (B, C, N, H, W).
//
// What bounds it on the card: per pixel and slice it reads and writes C values
// (64 bytes in fp32 at C = 8) for 4 C^2 FMAs (512 FLOP at C = 8), about 8
// FLOP/byte, below the fp32 ridge of about 20: device-memory traffic bounds it.
//
// What the design does about it: one thread per (b, h, w) pixel (b is part of
// the block index: any B, and N is no grid dimension at all) walks n = 0 ..
// N-1 with a three-slice window of C values in registers, so each input value
// is read from device memory once and each output written once; neighbouring
// threads hold neighbouring w, so every load and store of a warp is one
// coalesced 128-byte line per channel plane.  Wn (C x 3C) and W1 (C x C) sit in
// shared memory and are read as broadcasts.  Both sums are fp32, and the
// intermediate relu(Wn . f) stays fp32 in registers.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

// register cap by width: the window and both sums (5C values) fit in 64
// registers at C = 8, so four blocks share an SM to hide memory latency
template <typename T, int C>
__global__ void __launch_bounds__(THREADS, C <= 8 ? 4 : (C <= 16 ? 2 : 1))
srd_attention_kernel(const T* __restrict__ f, const float* __restrict__ wn,
                     const float* __restrict__ w1, T* __restrict__ y, int N,
                     int64_t hw, int blocks_per_b) {
  __shared__ __align__(16) float wn_s[3 * C * C];  // [dn][cin][cout]
  __shared__ __align__(16) float w1_s[C * C];      // [cin][cout]
  // torch layouts: wn (cout, cin, 3, 1, 1), w1 (cout, cin, 1, 1, 1)
  for (int i = threadIdx.x; i < 3 * C * C; i += THREADS) {
    const int co = i / (3 * C), ci = (i / 3) % C, dn = i % 3;
    wn_s[(dn * C + ci) * C + co] = wn[i];
  }
  for (int i = threadIdx.x; i < C * C; i += THREADS) {
    w1_s[(i % C) * C + i / C] = w1[i];
  }
  __syncthreads();

  // blockIdx.x = b * blocks_per_b + the pixel block: B is no grid dimension of its own
  const int b = blockIdx.x / blocks_per_b;
  const int64_t p = (int64_t)(blockIdx.x % blocks_per_b) * THREADS + threadIdx.x;
  if (p >= hw) return;
  const int64_t cstride = (int64_t)N * hw;
  const int64_t base = (int64_t)b * C * cstride + p;

  float prev[C], cur[C], next[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    prev[c] = 0.f;
    cur[c] = dffx::load(f, base + c * cstride);
  }
  for (int n = 0; n < N; ++n) {
    // The weights do not change with n, so the compiler hoists all 4C^2 of
    // them out of this loop into registers, and spills (848 bytes a thread at
    // C = 8, measured on the H100).  This barrier keeps their shared-memory
    // reads, which are warp-wide broadcasts, inside the loop.
    asm volatile("" ::: "memory");
#pragma unroll
    for (int c = 0; c < C; ++c) {
      next[c] = n + 1 < N ? dffx::load(f, base + c * cstride + (int64_t)(n + 1) * hw) : 0.f;
    }
    float a[C];
#pragma unroll
    for (int co = 0; co < C; ++co) a[co] = 0.f;
#pragma unroll
    for (int ci = 0; ci < C; ++ci) {
#pragma unroll
      for (int co = 0; co < C; ++co) {
        a[co] = fmaf(wn_s[ci * C + co], prev[ci], a[co]);
        a[co] = fmaf(wn_s[(C + ci) * C + co], cur[ci], a[co]);
        a[co] = fmaf(wn_s[(2 * C + ci) * C + co], next[ci], a[co]);
      }
    }
    float o[C];
#pragma unroll
    for (int co = 0; co < C; ++co) o[co] = 0.f;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const float ak = fmaxf(a[k], 0.f);
#pragma unroll
      for (int co = 0; co < C; ++co) o[co] = fmaf(w1_s[k * C + co], ak, o[co]);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dffx::store(y, base + c * cstride + (int64_t)n * hw, cur[c] + fmaxf(o[c], 0.f));
      prev[c] = cur[c];
      cur[c] = next[c];
    }
  }
}

template <typename T, int C>
cudaError_t launch(const void* f, const void* wn, const void* w1, void* y, int B,
                   int N, int64_t hw, cudaStream_t stream) {
  const int64_t blocks_per_b = (hw + THREADS - 1) / THREADS;
  if (B * blocks_per_b > 0x7fffffff) return cudaErrorInvalidValue;
  srd_attention_kernel<T, C><<<static_cast<unsigned>(B * blocks_per_b), THREADS, 0, stream>>>(
      static_cast<const T*>(f), static_cast<const float*>(wn),
      static_cast<const float*>(w1), static_cast<T*>(y), N, hw,
      static_cast<int>(blocks_per_b));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_c(int C, const void* f, const void* wn, const void* w1, void* y,
                       int B, int N, int64_t hw, cudaStream_t stream) {
  switch (C) {
    case 8: return launch<T, 8>(f, wn, w1, y, B, N, hw, stream);
    case 16: return launch<T, 16>(f, wn, w1, y, B, N, hw, stream);
    case 32: return launch<T, 32>(f, wn, w1, y, B, N, hw, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).
extern "C" int dffx_srd_attention_residual(const void* f, const void* wn, const void* w1,
                                           void* y, int B, int C, int N, int H, int W,
                                           int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t hw = (int64_t)H * W;
  if (dtype == DFFX_DTYPE_F32) return dispatch_c<float>(C, f, wn, w1, y, B, N, hw, s);
  if (dtype == DFFX_DTYPE_BF16) {
    return dispatch_c<__nv_bfloat16>(C, f, wn, w1, y, B, N, hw, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
