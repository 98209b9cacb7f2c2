// rb_of_chain: FlowNetwork's stride-1 resnet_block_2d_OF chain, eval mode.
//
// Replaces the TPU kernel dffx/ops/pallas_kernels.py::rb_of_chain_cf (body
// _rb_of_kernel).  Computes K consecutive blocks, per focal slice,
//   x <- relu(Ws x + BN2(conv2(relu(BN1(conv1(x))))))
// with bias-free (1,3,3) pad-1 convs and a 1x1 projection shortcut Ws, on
// (B, C, N, H, W).  Built for FlowNetwork's three pyramid levels: the
// full-resolution pair 3 -> 8 -> 8 (K = 2), and one 16 -> 16 or 32 -> 32
// block at half and quarter resolution (K = 1).
//
// What bounds it on the card: at the full-resolution pair, 9 x (3 x 8 + 8 x 8
// + 2 x 8 x 8) + 3 x 8 + 8 x 8 = 2,032 FMAs per pixel (4.1 kFLOP) against 44
// bytes of fp32 traffic, about 90 FLOP/byte; at 16 and 32 channels the ratio
// is higher still.  fp32 FMA issue and the shared-memory reads that feed it
// bound it, not HBM.
//
// What the design does about it: a block owns a 32 x 8 output tile of one
// slice.  It stages the input tile with the chain's halo (2 pixels per block)
// in shared memory, zero outside the image, and runs every conv of the chain
// from shared memory into shared memory (chain.cuh), so no intermediate
// touches device memory; only the last block's output is written.  Each
// thread keeps all output channels of a position in registers, so one input
// read feeds C FMAs, and the weights are 16-byte broadcast reads.  Every
// intermediate -- conv1 inside a block and block 0's output before block 1 --
// is set to 0 outside the image: the next conv zero-pads its input, and
// relu(BN(0)) or relu(Ws 0 + shift) is not 0 wherever a BN shift is positive
// (the TPU kernel masks the same positions with store_masked).
#include "chain.cuh"

namespace {

constexpr int TW = 32, TH = 8, NT = TW * TH;

using dffx::round4;

// One block's parameters: packed by the wrapper as w1, s1, b1, w2, s2, b2, ws
// (torch layouts, back to back); in shared memory the same sections, each
// 16-byte aligned, with the convs as [cin][tap][cout].
template <int CI, int C>
struct OFBlock {
  static constexpr int G_W1 = 0, G_S1 = G_W1 + 9 * CI * C, G_B1 = G_S1 + C,
                       G_W2 = G_B1 + C, G_S2 = G_W2 + 9 * C * C, G_B2 = G_S2 + C,
                       G_WS = G_B2 + C, G_END = G_WS + CI * C;
  static constexpr int S_W1 = 0, S_S1 = S_W1 + round4(9 * CI * C), S_B1 = S_S1 + round4(C),
                       S_W2 = S_B1 + round4(C), S_S2 = S_W2 + round4(9 * C * C),
                       S_B2 = S_S2 + round4(C), S_WS = S_B2 + round4(C),
                       S_END = S_WS + round4(CI * C);
};

template <int CI, int C>
__device__ __forceinline__ void load_block(const float* __restrict__ g, float* __restrict__ s) {
  using L = OFBlock<CI, C>;
  dffx::load_conv_weights<NT>(g + L::G_W1, s + L::S_W1, C, CI, 9);
  dffx::load_vector<NT>(g + L::G_S1, s + L::S_S1, C);
  dffx::load_vector<NT>(g + L::G_B1, s + L::S_B1, C);
  dffx::load_conv_weights<NT>(g + L::G_W2, s + L::S_W2, C, C, 9);
  dffx::load_vector<NT>(g + L::G_S2, s + L::S_S2, C);
  dffx::load_vector<NT>(g + L::G_B2, s + L::S_B2, C);
  dffx::load_conv_weights<NT>(g + L::G_WS, s + L::S_WS, C, CI, 1);
}

// One block on region src = [CI][SH][SW] whose (0, 0) is image pixel (gh0, gw0):
// conv1 -> BN1 -> ReLU into mid, then conv2 -> BN2 plus the shortcut on src's
// centre, ReLU.  LAST writes the tile to y; otherwise the output region goes to
// out_s, 0 outside the image.
template <typename T, int CI, int C, int SH, int SW, bool LAST>
__device__ __forceinline__ void of_block(const float* __restrict__ src, float* __restrict__ mid,
                                         float* __restrict__ out_s, const float* __restrict__ wb,
                                         T* __restrict__ y, int64_t obase, int64_t cstride,
                                         int gh0, int gw0, int H, int W) {
  using L = OFBlock<CI, C>;
  constexpr int MH = SH - 2, MW = SW - 2, OH = SH - 4, OW = SW - 4;
  dffx::conv_bn_relu_stage<CI, C, SH, SW, NT>(src, mid, wb + L::S_W1, wb + L::S_S1,
                                              wb + L::S_B1, gh0 + 1, gw0 + 1, H, W);
  __syncthreads();
  const float* s2 = wb + L::S_S2;
  const float* b2 = wb + L::S_B2;
  for (int p = threadIdx.x; p < OH * OW; p += NT) {
    const int oy = p / OW, ox = p % OW;
    float acc[C];
    dffx::conv3x3_at<C, C, MH, MW>(mid, oy, ox, wb + L::S_W2, acc);
#pragma unroll
    for (int co = 0; co < C; ++co) acc[co] = fmaf(acc[co], s2[co], b2[co]);
#pragma unroll
    for (int ci = 0; ci < CI; ++ci) {
      dffx::fma_row<C>(src[(ci * SH + oy + 2) * SW + ox + 2], wb + L::S_WS + ci * C, acc);
    }
    const int gh = gh0 + 2 + oy, gw = gw0 + 2 + ox;
    const bool inside = dffx::in_image(gh, gw, H, W);
    if constexpr (LAST) {
      if (inside) {
        const int64_t o = obase + (int64_t)gh * W + gw;
#pragma unroll
        for (int co = 0; co < C; ++co) dffx::store(y, o + co * cstride, fmaxf(acc[co], 0.f));
      }
    } else {
#pragma unroll
      for (int co = 0; co < C; ++co) {
        out_s[(co * OH + oy) * OW + ox] = inside ? fmaxf(acc[co], 0.f) : 0.f;
      }
    }
  }
}

template <int CIN0, int C, int K>
struct Layout {
  static constexpr int R = 2 * K;  // the chain's halo: two convs per block
  static constexpr int IH = TH + 2 * R, IW = TW + 2 * R;
  static constexpr int W0 = 0;                                     // block 0's weights
  static constexpr int W1 = W0 + OFBlock<CIN0, C>::S_END;          // block 1's (K == 2)
  static constexpr int IN = W1 + (K == 2 ? OFBlock<C, C>::S_END : 0);  // [CIN0][IH][IW]
  static constexpr int MID = IN + round4(CIN0 * IH * IW);          // [C][IH-2][IW-2]
  static constexpr int BLK = MID + round4(C * (IH - 2) * (IW - 2));  // [C][IH-4][IW-4]
  static constexpr int END = BLK + (K == 2 ? round4(C * (IH - 4) * (IW - 4)) : 0);
};

template <typename T, int CIN0, int C, int K>
__global__ void __launch_bounds__(NT)
rb_of_chain_kernel(const T* __restrict__ x, const float* __restrict__ params,
                   T* __restrict__ y, int N, int H, int W) {
  using L = Layout<CIN0, C, K>;
  extern __shared__ __align__(16) float smem[];
  load_block<CIN0, C>(params, smem + L::W0);
  if constexpr (K == 2) load_block<C, C>(params + OFBlock<CIN0, C>::G_END, smem + L::W1);

  const int b = blockIdx.z / N, n = blockIdx.z % N;
  const int64_t hw = (int64_t)H * W;
  const int64_t cstride = (int64_t)N * hw;
  const int th0 = blockIdx.y * TH, tw0 = blockIdx.x * TW;
  dffx::load_tile<T, CIN0, L::IH, L::IW, NT>(x, ((int64_t)b * CIN0 * N + n) * hw, cstride,
                                             smem + L::IN, th0 - L::R, tw0 - L::R, H, W);
  __syncthreads();

  const int64_t obase = ((int64_t)b * C * N + n) * hw;
  if constexpr (K == 1) {
    of_block<T, CIN0, C, L::IH, L::IW, true>(smem + L::IN, smem + L::MID, nullptr,
                                             smem + L::W0, y, obase, cstride, th0 - 2,
                                             tw0 - 2, H, W);
  } else {
    of_block<T, CIN0, C, L::IH, L::IW, false>(smem + L::IN, smem + L::MID, smem + L::BLK,
                                              smem + L::W0, y, obase, cstride, th0 - 4,
                                              tw0 - 4, H, W);
    __syncthreads();  // block 0's output is complete; mid is free again
    of_block<T, C, C, L::IH - 4, L::IW - 4, true>(smem + L::BLK, smem + L::MID, nullptr,
                                                  smem + L::W1, y, obase, cstride, th0 - 2,
                                                  tw0 - 2, H, W);
  }
}

template <typename T, int CIN0, int C, int K>
cudaError_t launch(const void* x, const void* params, void* y, int B, int N, int H, int W,
                   cudaStream_t stream) {
  const int bytes = Layout<CIN0, C, K>::END * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(rb_of_chain_kernel<T, CIN0, C, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * N);
  rb_of_chain_kernel<T, CIN0, C, K><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(params), static_cast<T*>(y), N, H,
      W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int cin, int cout, int nblocks, const void* x, const void* params,
                     void* y, int B, int N, int H, int W, cudaStream_t stream) {
  if (cin == 3 && cout == 8 && nblocks == 2) {
    return launch<T, 3, 8, 2>(x, params, y, B, N, H, W, stream);
  }
  if (cin == 16 && cout == 16 && nblocks == 1) {
    return launch<T, 16, 16, 1>(x, params, y, B, N, H, W, stream);
  }
  if (cin == 32 && cout == 32 && nblocks == 1) {
    return launch<T, 32, 32, 1>(x, params, y, B, N, H, W, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).
extern "C" int dffx_rb_of_chain(const void* x, const void* params, void* y, int B, int Cin,
                                int Cout, int nblocks, int N, int H, int W, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DFFX_DTYPE_F32) {
    return dispatch<float>(Cin, Cout, nblocks, x, params, y, B, N, H, W, s);
  }
  if (dtype == DFFX_DTYPE_BF16) {
    return dispatch<__nv_bfloat16>(Cin, Cout, nblocks, x, params, y, B, N, H, W, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
