// bn_act: a 16-bit eval BatchNorm with the residual add and ReLU after it, in
// one pass:
//   y = relu?(x * scale[c] + shift[c] (+ z))
//
// Replaces no TPU kernel: XLA fuses the JAX package's eval BN, its add and its
// ReLU into the conv's epilogue, while ATen applies them as separate passes
// over the activation (a broadcast multiply, a broadcast add, the residual add
// and the ReLU, each reading and writing it whole, the first two through the
// generic, unvectorised elementwise kernel).  Here the activation is read once
// (with z once) and written once.
//
// Numerics: scale and shift are the fp32 fold of the BN (bn_fused_affine)
// rounded to the activation dtype, as the JAX package applies them; they are
// widened back to fp32, x * scale + shift is one fused multiply-add (the
// product of two 16-bit values is exact in fp32), z is added in fp32, then
// the ReLU, then one rounding to the activation dtype (round to nearest even).
//
// What bounds it on the card: 2 bytes read and 2 written a value (4 more read
// with z), no arithmetic to speak of, so HBM at 3.35 TB/s.  The design serves
// that: 16-byte loads and stores (8 values), a grid-stride loop over the
// tensor with a few blocks per SM, and the per-channel affine in fp32 in
// shared memory (NDHWC) or in registers (NCDHW).  Two paths take the cells'
// tensors with no division in the loop:
// * NDHWC (channel innermost, C % 8 == 0): the 8 values of a vector are
//   channels 8g .. 8g + 7 of one pixel; a thread tracks its group g as it
//   strides.
// * NCDHW (N * H * W % 8 == 0): a vector lies in one channel's plane; grid
//   dimension y walks the (b, c) planes, x the plane's vectors.
// A third takes every other dense tensor: channels that change inside a
// vector (NDHWC with C % 8 != 0, NCDHW with N * H * W % 8 != 0), more channels
// than shared memory holds, a last vector of fewer than 8 values, a view not
// 16-byte aligned (2-byte loads and stores there).  Each vector finds the
// channel of its first value by one division and steps from there.
// x, z and y are dense in the same layout (ops/kernels.py::bn_act_layout
// checks that before the launch); y is laid out as x.
//
// bn_act_pool: DDFFNet's BN-ReLU that a 2x2 max-pool reads, with the pool, in
// one pass over an NDHWC x (C % 8 == 0, H and W even):
//   p[b, c, n, i, j] = max over (h, w) in {2i, 2i+1} x {2j, 2j+1} of
//                      relu(x[b, c, n, h, w] * scale[c] + shift[c])
// Each of the four values is bn_act's (one fmaf, the ReLU, one rounding); the
// window is scanned as ATen's max_pool3d scans it (h, then w; a value is taken
// where it is greater than the max so far or NaN), so p is bit for bit bn_act
// then F.max_pool3d, signed zeros and NaN included, and no index is written.
// With keep the four rounded vectors are stored too (y, laid out as x).  What
// bounds it is HBM: x read once, p written once (and y with keep), against
// bn_act's y written and read again and the pool's int64 indices.  A thread
// takes one 8-channel group of one output pixel: four 16-byte loads (rows 2i
// and 2i + 1, two adjacent pixels each, which a warp's neighbours fill out to
// whole sectors) and one 16-byte store; it tracks (row, column, group) as it
// strides the grid, with no division in the loop.
#include <cuda_fp16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Pack;  // 8 values of T in a uint4, widened to and narrowed from fp32

template <>
struct Pack<__nv_bfloat16> {
  static __device__ __forceinline__ float to_float(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ void widen(const uint4& v, float (&f)[8]) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(p[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  static __device__ __forceinline__ uint4 narrow(const float (&f)[8]) {
    uint4 v;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return v;
  }
};

template <>
struct Pack<__half> {
  static __device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
  static __device__ __forceinline__ __half from_float(float v) { return __float2half_rn(v); }
  static __device__ __forceinline__ void widen(const uint4& v, float (&f)[8]) {
    const __half2* p = reinterpret_cast<const __half2*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __half22float2(p[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  static __device__ __forceinline__ uint4 narrow(const float (&f)[8]) {
    uint4 v;
    __half2* p = reinterpret_cast<__half2*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
    return v;
  }
};

// y[8 values] = relu?(x * s + b (+ z)), s and b a value each
template <typename T, bool HAS_Z, bool RELU>
__device__ __forceinline__ void apply(const T* __restrict__ x, const T* __restrict__ z,
                                      T* __restrict__ y, int64_t i, const float* s,
                                      const float* b) {
  float f[8];
  Pack<T>::widen(*reinterpret_cast<const uint4*>(x + i), f);
  float r[8];
  if (HAS_Z) Pack<T>::widen(*reinterpret_cast<const uint4*>(z + i), r);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float v = fmaf(f[k], s[k], b[k]);
    if (HAS_Z) v += r[k];
    if (RELU) v = v < 0.f ? 0.f : v;  // NaN passes, as torch.relu
    f[k] = v;
  }
  *reinterpret_cast<uint4*>(y + i) = Pack<T>::narrow(f);
}

template <typename T, bool HAS_Z, bool RELU>
__global__ void __launch_bounds__(kThreads)
    bn_act_ndhwc_kernel(const T* __restrict__ x, const T* __restrict__ z, T* __restrict__ y,
                        const T* __restrict__ scale, const T* __restrict__ shift,
                        int64_t nvec, int groups) {
  extern __shared__ float4 affine4[];  // scale[C] then shift[C], fp32
  float* affine = reinterpret_cast<float*>(affine4);
  const int c = groups * 8;
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    affine[i] = Pack<T>::to_float(scale[i]);
    affine[c + i] = Pack<T>::to_float(shift[i]);
  }
  __syncthreads();
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int g = static_cast<int>(v % groups);
  const int g_step = static_cast<int>(step % groups);
  for (; v < nvec; v += step) {
    const float4* s4 = affine4 + 2 * g;
    const float4* b4 = affine4 + 2 * (groups + g);
    const float4 s0 = s4[0], s1 = s4[1], b0 = b4[0], b1 = b4[1];
    const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    apply<T, HAS_Z, RELU>(x, z, y, v * 8, s, b);
    g += g_step;
    if (g >= groups) g -= groups;
  }
}

template <typename T, bool HAS_Z, bool RELU>
__global__ void __launch_bounds__(kThreads)
    bn_act_ncdhw_kernel(const T* __restrict__ x, const T* __restrict__ z, T* __restrict__ y,
                        const T* __restrict__ scale, const T* __restrict__ shift,
                        int64_t planes, int c, int64_t plane_vecs) {
  for (int64_t p = blockIdx.y; p < planes; p += gridDim.y) {
    const int ch = static_cast<int>(p % c);
    const float sv = Pack<T>::to_float(scale[ch]), bv = Pack<T>::to_float(shift[ch]);
    const float s[8] = {sv, sv, sv, sv, sv, sv, sv, sv};
    const float b[8] = {bv, bv, bv, bv, bv, bv, bv, bv};
    const int64_t base = p * plane_vecs;
    for (int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         v < plane_vecs; v += static_cast<int64_t>(gridDim.x) * blockDim.x)
      apply<T, HAS_Z, RELU>(x, z, y, (base + v) * 8, s, b);
  }
}

// Any dense tensor: value i has channel (i / run) % c, run = 1 in NDHWC and
// N * H * W in NCDHW.  VEC: x, z and y 16-byte aligned, so that full vectors
// move as 16-byte loads and stores; the last vector may hold fewer than 8.
template <typename T, bool HAS_Z, bool RELU, bool VEC>
__global__ void __launch_bounds__(kThreads)
    bn_act_any_kernel(const T* __restrict__ x, const T* __restrict__ z, T* __restrict__ y,
                      const T* __restrict__ scale, const T* __restrict__ shift, int64_t numel,
                      int c, int64_t run) {
  const int64_t nvec = (numel + 7) / 8;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; v < nvec;
       v += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t i = v * 8;
    const int n = numel - i < 8 ? static_cast<int>(numel - i) : 8;
    const int64_t r = i / run;
    int ch = static_cast<int>(r % c);
    int64_t left = (r + 1) * run - i;  // values before the channel changes
    float s[8], b[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      s[k] = Pack<T>::to_float(scale[ch]);
      b[k] = Pack<T>::to_float(shift[ch]);
      if (--left == 0) {
        left = run;
        ch = ch + 1 == c ? 0 : ch + 1;
      }
    }
    if (VEC && n == 8) {
      apply<T, HAS_Z, RELU>(x, z, y, i, s, b);
      continue;
    }
    for (int k = 0; k < n; ++k) {
      float val = fmaf(Pack<T>::to_float(x[i + k]), s[k], b[k]);
      if (HAS_Z) val += Pack<T>::to_float(z[i + k]);
      if (RELU) val = val < 0.f ? 0.f : val;
      y[i + k] = Pack<T>::from_float(val);
    }
  }
}

// the widest C whose fp32 affine fits the 48 KB of shared memory a launch gets
// without asking for more
constexpr int kSmemChannels = 48 * 1024 / (2 * sizeof(float));

template <typename T, bool HAS_Z, bool RELU>
cudaError_t launch(const void* x, const void* z, void* y, const void* scale, const void* shift,
                   int64_t numel, int c, int64_t inner, int ndhwc, int blocks, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* zt = static_cast<const T*>(z);
  T* yt = static_cast<T*>(y);
  const T* st = static_cast<const T*>(scale);
  const T* bt = static_cast<const T*>(shift);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                         reinterpret_cast<uintptr_t>(z);
  const bool aligned = addr % 16 == 0;
  const int64_t nvec = (numel + 7) / 8;
  if (aligned && numel % 8 == 0 && (ndhwc ? c % 8 == 0 && c <= kSmemChannels : inner % 8 == 0)) {
    if (ndhwc) {
      const int64_t need = (nvec + kThreads - 1) / kThreads;
      const int grid = static_cast<int>(need < blocks ? need : blocks);
      const size_t smem = 2 * static_cast<size_t>(c) * sizeof(float);
      bn_act_ndhwc_kernel<T, HAS_Z, RELU><<<grid, kThreads, smem, s>>>(xt, zt, yt, st, bt,
                                                                        nvec, c / 8);
    } else {
      const int64_t planes = numel / inner, plane_vecs = inner / 8;
      const int gy = static_cast<int>(planes < 65535 ? planes : 65535);
      const int64_t per_plane = (plane_vecs + kThreads - 1) / kThreads;
      int64_t gx = (blocks + gy - 1) / gy;
      if (gx > per_plane) gx = per_plane;
      bn_act_ncdhw_kernel<T, HAS_Z, RELU>
          <<<dim3(static_cast<unsigned>(gx), gy), kThreads, 0, s>>>(xt, zt, yt, st, bt, planes,
                                                                   c, plane_vecs);
    }
    return cudaGetLastError();
  }
  const int64_t need = (nvec + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(need < blocks ? need : blocks);
  const int64_t run = ndhwc ? 1 : inner;
  if (aligned)
    bn_act_any_kernel<T, HAS_Z, RELU, true><<<grid, kThreads, 0, s>>>(xt, zt, yt, st, bt, numel,
                                                                       c, run);
  else
    bn_act_any_kernel<T, HAS_Z, RELU, false><<<grid, kThreads, 0, s>>>(xt, zt, yt, st, bt,
                                                                        numel, c, run);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* z, void* y, const void* scale, const void* shift,
                     int64_t numel, int c, int64_t inner, int ndhwc, int relu, int blocks,
                     cudaStream_t s) {
  if (z != nullptr)
    return relu ? launch<T, true, true>(x, z, y, scale, shift, numel, c, inner, ndhwc, blocks, s)
                : launch<T, true, false>(x, z, y, scale, shift, numel, c, inner, ndhwc, blocks, s);
  return relu ? launch<T, false, true>(x, z, y, scale, shift, numel, c, inner, ndhwc, blocks, s)
              : launch<T, false, false>(x, z, y, scale, shift, numel, c, inner, ndhwc, blocks, s);
}

// relu(x * s + b) of 8 values, rounded as apply rounds them
template <typename T>
__device__ __forceinline__ uint4 bn_relu8(const uint4& raw, const float* s, const float* b) {
  float f[8];
  Pack<T>::widen(raw, f);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float v = fmaf(f[k], s[k], b[k]);
    f[k] = v < 0.f ? 0.f : v;
  }
  return Pack<T>::narrow(f);
}

// ATen's max_pool3d step on 8 values: m takes v where v > m or v is NaN
template <typename T>
__device__ __forceinline__ void max8(uint4& m, const uint4& v) {
  T* mp = reinterpret_cast<T*>(&m);
  const T* vp = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float a = Pack<T>::to_float(vp[k]);
    if (a > Pack<T>::to_float(mp[k]) || isnan(a)) mp[k] = vp[k];
  }
}

// rows = B * N * H / 2 output rows of wo = W / 2 pixels, groups = C / 8
template <typename T, bool KEEP>
__global__ void __launch_bounds__(kThreads)
    bn_act_pool_ndhwc_kernel(const T* __restrict__ x, T* __restrict__ y, T* __restrict__ p,
                             const T* __restrict__ scale, const T* __restrict__ shift,
                             int64_t rows, int wo, int groups) {
  extern __shared__ float4 affine4[];  // scale[C] then shift[C], fp32
  float* affine = reinterpret_cast<float*>(affine4);
  const int c = groups * 8;
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    affine[i] = Pack<T>::to_float(scale[i]);
    affine[c + i] = Pack<T>::to_float(shift[i]);
  }
  __syncthreads();
  // the grid's step and this thread's first vector as (row, column, group)
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int sg = static_cast<int>(step % groups);
  const int sj = static_cast<int>(step / groups % wo);
  const int64_t sr = step / groups / wo;
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int g = static_cast<int>(v % groups);
  int j = static_cast<int>(v / groups % wo);
  int64_t r = v / groups / wo;
  const int64_t in_row = 2 * static_cast<int64_t>(wo) * c;  // values of one input row
  while (r < rows) {
    const int64_t in = 2 * r * in_row + 2 * static_cast<int64_t>(j) * c + 8 * g;
    const uint4 x00 = *reinterpret_cast<const uint4*>(x + in);
    const uint4 x01 = *reinterpret_cast<const uint4*>(x + in + c);
    const uint4 x10 = *reinterpret_cast<const uint4*>(x + in + in_row);
    const uint4 x11 = *reinterpret_cast<const uint4*>(x + in + in_row + c);
    const float4* s4 = affine4 + 2 * g;
    const float4* b4 = affine4 + 2 * (groups + g);
    const float4 s0 = s4[0], s1 = s4[1], b0 = b4[0], b1 = b4[1];
    const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    const uint4 y00 = bn_relu8<T>(x00, s, b), y01 = bn_relu8<T>(x01, s, b);
    const uint4 y10 = bn_relu8<T>(x10, s, b), y11 = bn_relu8<T>(x11, s, b);
    if (KEEP) {
      *reinterpret_cast<uint4*>(y + in) = y00;
      *reinterpret_cast<uint4*>(y + in + c) = y01;
      *reinterpret_cast<uint4*>(y + in + in_row) = y10;
      *reinterpret_cast<uint4*>(y + in + in_row + c) = y11;
    }
    uint4 m = y00;
    max8<T>(m, y01);
    max8<T>(m, y10);
    max8<T>(m, y11);
    *reinterpret_cast<uint4*>(p + (r * wo + j) * c + 8 * g) = m;
    g += sg;
    if (g >= groups) {
      g -= groups;
      ++j;
    }
    j += sj;
    if (j >= wo) {
      j -= wo;
      ++r;
    }
    r += sr;
  }
}

// as many blocks as the SMs hold at once (a grid-stride loop: a block beyond
// that would run as a second wave behind the first)
template <typename T, bool KEEP>
cudaError_t launch_pool(const void* x, void* y, void* p, const void* scale, const void* shift,
                        int64_t rows, int wo, int c, int sms, cudaStream_t s) {
  const auto kernel = bn_act_pool_ndhwc_kernel<T, KEEP>;
  const size_t smem = 2 * static_cast<size_t>(c) * sizeof(float);
  int per_sm = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t need = (rows * wo * (c / 8) + kThreads - 1) / kThreads;
  const int64_t most = static_cast<int64_t>(sms) * per_sm;
  const int grid = static_cast<int>(need < most ? need : most);
  kernel<<<grid, kThreads, smem, s>>>(static_cast<const T*>(x), static_cast<T*>(y),
                                      static_cast<T*>(p), static_cast<const T*>(scale),
                                      static_cast<const T*>(shift), rows, wo, c / 8);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_pool(const void* x, void* y, void* p, const void* scale, const void* shift,
                          int64_t rows, int wo, int c, int sms, cudaStream_t s) {
  return y != nullptr ? launch_pool<T, true>(x, y, p, scale, shift, rows, wo, c, sms, s)
                      : launch_pool<T, false>(x, y, p, scale, shift, rows, wo, c, sms, s);
}

}  // namespace

// x, z (nullptr: no residual), y: numel values of a dense (B, C, ...) tensor,
// channels innermost (ndhwc = 1) or outermost but B (ndhwc = 0), inner = the
// values of one (b, c) plane; scale, shift: C values in the activation dtype;
// blocks: the grid's size to aim for.
extern "C" int dffx_bn_act(const void* x, const void* z, void* y, const void* scale,
                           const void* shift, long long numel, int C, long long inner, int ndhwc,
                           int relu, int blocks, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (numel <= 0 || C <= 0 || blocks <= 0 || inner <= 0 || numel % (C * inner))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DFFX_DTYPE_BF16)
    return dispatch<__nv_bfloat16>(x, z, y, scale, shift, numel, C, inner, ndhwc, relu, blocks, s);
  if (dtype == DFFX_DTYPE_F16)
    return dispatch<__half>(x, z, y, scale, shift, numel, C, inner, ndhwc, relu, blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x: an NDHWC (B, C, N, H, W) tensor, rows = B * N * H / 2, wo = W / 2, C % 8
// == 0; p: its (B, C, N, H / 2, W / 2) pool, NDHWC; y (nullptr: not kept): the
// BN-ReLU, laid out as x; scale, shift: C values in the activation dtype; sms:
// the card's SMs.  x, y and p 16-byte aligned.
extern "C" int dffx_bn_act_pool(const void* x, void* y, void* p, const void* scale,
                                const void* shift, long long rows, int wo, int C, int sms,
                                int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                         reinterpret_cast<uintptr_t>(p);
  if (rows <= 0 || wo <= 0 || C <= 0 || C % 8 || C > kSmemChannels || sms <= 0 || addr % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DFFX_DTYPE_BF16)
    return dispatch_pool<__nv_bfloat16>(x, y, p, scale, shift, rows, wo, C, sms, s);
  if (dtype == DFFX_DTYPE_F16)
    return dispatch_pool<__half>(x, y, p, scale, shift, rows, wo, C, sms, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
