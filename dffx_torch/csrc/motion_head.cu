// motion_head_conv_chain: FlowNetwork's full-resolution motion head before its
// pooling, eval mode.
//
// Replaces the TPU kernel dffx/ops/pallas_kernels.py::motion_head_conv_chain_cf
// (body _motion_head_kernel).  Computes, per focal slice,
//   conv3(relu(BN2(conv2(relu(BN1(conv1(relu(BN0(conv0(x))))))))) + bias3
// with four (1,3,3) pad-1 convs 18 -> 16 -> 16 -> 16 -> 3 on (B, C, N, H, W):
// the conv3 head of End_to_End.py:33-61, whose input is the 18-channel motion
// volume at full resolution.
//
// What bounds it on the card: 9 x (18 x 16 + 2 x 16 x 16 + 16 x 3) = 7,632
// FMAs per pixel (15.3 kFLOP) against 84 bytes of fp32 traffic, about 180
// FLOP/byte: fp32 FMA issue and the shared-memory reads that feed it bound it,
// not HBM.  The fused chain recomputes its halo: at the 32 x 16 tile about
// 1.4x the FMAs of the four convs.
//
// What the design does about it: a block owns a 32 x 16 output tile of one
// slice.  The input tile with the chain's 4-pixel halo (18 x 24 x 40), two
// ping-pong intermediates and all weights sit in shared memory (200 KB,
// one block per SM), so the three 16-channel intermediates never touch device
// memory.  Each thread keeps all output channels of a position in registers
// and reads the weights as 16-byte broadcasts (chain.cuh).  Every
// intermediate is 0 outside the image, as the next conv's zero padding
// requires: relu(BN(0)) is not 0 wherever a BN shift is positive (the TPU
// kernel masks the same positions with store_masked).
#include "chain.cuh"

namespace {

constexpr int CIN = 18, C = 16, CO = 3;
constexpr int TW = 32, TH = 16, NT = 256;
constexpr int IH = TH + 8, IW = TW + 8;  // input tile with the chain's 4-pixel halo

using dffx::round4;

// parameters as the wrapper packs them: w0, s0, b0, w1, s1, b1, w2, s2, b2, w3,
// bias3, back to back, each conv as [cin][tap][cout]
constexpr int G_W0 = 0, G_S0 = G_W0 + 9 * CIN * C, G_B0 = G_S0 + C, G_W1 = G_B0 + C,
              G_S1 = G_W1 + 9 * C * C, G_B1 = G_S1 + C, G_W2 = G_B1 + C,
              G_S2 = G_W2 + 9 * C * C, G_B2 = G_S2 + C, G_W3 = G_B2 + C,
              G_BIAS = G_W3 + 9 * C * CO;
// shared memory: the same sections 16-byte aligned, then the input tile and two
// intermediates
constexpr int S_W0 = 0, S_S0 = S_W0 + round4(9 * CIN * C), S_B0 = S_S0 + round4(C),
              S_W1 = S_B0 + round4(C), S_S1 = S_W1 + round4(9 * C * C),
              S_B1 = S_S1 + round4(C), S_W2 = S_B1 + round4(C),
              S_S2 = S_W2 + round4(9 * C * C), S_B2 = S_S2 + round4(C),
              S_W3 = S_B2 + round4(C), S_BIAS = S_W3 + round4(9 * C * CO),
              S_IN = S_BIAS + round4(CO),                         // [CIN][IH][IW]
              S_YA = S_IN + round4(CIN * IH * IW),               // [C][IH-2][IW-2]
              S_YB = S_YA + round4(C * (IH - 2) * (IW - 2)),     // [C][IH-4][IW-4]
              S_END = S_YB + round4(C * (IH - 4) * (IW - 4));

template <typename T>
__global__ void __launch_bounds__(NT)
motion_head_kernel(const T* __restrict__ x, const float* __restrict__ params,
                   T* __restrict__ y, int N, int H, int W) {
  extern __shared__ __align__(16) float smem[];
  dffx::load_vector<NT>(params + G_W0, smem + S_W0, 9 * CIN * C);
  dffx::load_vector<NT>(params + G_W1, smem + S_W1, 9 * C * C);
  dffx::load_vector<NT>(params + G_W2, smem + S_W2, 9 * C * C);
  dffx::load_vector<NT>(params + G_W3, smem + S_W3, 9 * C * CO);
  dffx::load_vector<NT>(params + G_S0, smem + S_S0, C);
  dffx::load_vector<NT>(params + G_B0, smem + S_B0, C);
  dffx::load_vector<NT>(params + G_S1, smem + S_S1, C);
  dffx::load_vector<NT>(params + G_B1, smem + S_B1, C);
  dffx::load_vector<NT>(params + G_S2, smem + S_S2, C);
  dffx::load_vector<NT>(params + G_B2, smem + S_B2, C);
  dffx::load_vector<NT>(params + G_BIAS, smem + S_BIAS, CO);

  const int b = blockIdx.z / N, n = blockIdx.z % N;
  const int64_t hw = (int64_t)H * W;
  const int64_t cstride = (int64_t)N * hw;
  const int th0 = blockIdx.y * TH, tw0 = blockIdx.x * TW;
  float* in_s = smem + S_IN;
  float* ya = smem + S_YA;
  float* yb = smem + S_YB;
  dffx::load_tile<T, CIN, IH, IW, NT>(x, ((int64_t)b * CIN * N + n) * hw, cstride, in_s,
                                      th0 - 4, tw0 - 4, H, W);
  __syncthreads();
  dffx::conv_bn_relu_stage<CIN, C, IH, IW, NT>(in_s, ya, smem + S_W0, smem + S_S0,
                                               smem + S_B0, th0 - 3, tw0 - 3, H, W);
  __syncthreads();
  dffx::conv_bn_relu_stage<C, C, IH - 2, IW - 2, NT>(ya, yb, smem + S_W1, smem + S_S1,
                                                     smem + S_B1, th0 - 2, tw0 - 2, H, W);
  __syncthreads();
  dffx::conv_bn_relu_stage<C, C, IH - 4, IW - 4, NT>(yb, ya, smem + S_W2, smem + S_S2,
                                                     smem + S_B2, th0 - 1, tw0 - 1, H, W);
  __syncthreads();

  // conv3 + bias for the tile's own pixels
  const float* bias = smem + S_BIAS;
  const int64_t obase = ((int64_t)b * CO * N + n) * hw;
  for (int p = threadIdx.x; p < TH * TW; p += NT) {
    const int oy = p / TW, ox = p % TW;
    const int gh = th0 + oy, gw = tw0 + ox;
    if (gh >= H || gw >= W) continue;
    float acc[CO];
    dffx::conv3x3_at<C, CO, IH - 6, IW - 6>(ya, oy, ox, smem + S_W3, acc);
    const int64_t o = obase + (int64_t)gh * W + gw;
#pragma unroll
    for (int co = 0; co < CO; ++co) dffx::store(y, o + co * cstride, acc[co] + bias[co]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* params, void* y, int B, int N, int H, int W,
                   cudaStream_t stream) {
  const int bytes = S_END * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(motion_head_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * N);
  motion_head_kernel<T><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(params), static_cast<T*>(y), N, H,
      W);
  return cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).
extern "C" int dffx_motion_head_conv_chain(const void* x, const void* params, void* y, int B,
                                           int Cin, int Cmid, int N, int H, int W, int dtype,
                                           void* stream) {
  if (Cin != CIN || Cmid != C) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DFFX_DTYPE_F32) return launch<float>(x, params, y, B, N, H, W, s);
  if (dtype == DFFX_DTYPE_BF16) return launch<__nv_bfloat16>(x, params, y, B, N, H, W, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
