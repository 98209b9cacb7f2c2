// One residual block of two (1,3,3) C -> C convs on the tensor cores, the
// block of rb2d.cu (identity shortcut) and of rb_of.cu's 16- and 32-channel
// levels (1x1 projection shortcut):
//   y = relu(S(x) + BN2(conv2(relu(BN1(conv1(x))))))
// with S(x) = x or Ws x, bias-free pad-1 convs, per focal slice of
// (B, C, N, H, W).  conv1's output is 0 outside the image, as conv2's zero
// padding requires: relu(BN1(0)) is not 0 wherever BN1's shift is positive.
//
// The convs are implicit GEMMs (M = the tile's pixels, N = C, K = 9 C) on
// mma.sync m16n8k8 TF32 in the 3xTF32 split (mma.cuh).  A persistent grid
// walks TH x 32 tiles; each block copies the parameters into shared memory
// once, already in B-fragment order (the wrapper packs them), with 16-byte
// cp.async, and folds BN2's scale into its copy of w2.  Per tile: conv1 -> BN1
// -> ReLU into shared memory; then the shortcut goes straight into conv2's
// accumulators -- the projection as C / 8 k-steps, the identity as the exact
// fp32 x (a widened bf16 is exact too) -- and the input buffer is free: the
// next tile's input is in flight while conv2 runs.  Channel planes in shared
// memory are 8 (mod 32) floats apart, so every A-fragment load (8 pixels x 4
// channels across the warp) hits 32 distinct banks.
#pragma once

#include <type_traits>

#include "mma.cuh"

namespace dffx {

constexpr int RES_TW = 32;

// Tile, fragment and shared-memory plan of one block on TH x 32 tiles with NW
// warps.  XO: the tile's column in its staged input, 2 (the pair's halo) or 4
// (a tile origin that 16-byte copies can take: stage_tile_vec).  Parameters as
// the wrapper packs them: w1, s1, b1, w2, s2, b2 and, with PROJ, ws; each conv
// as B fragments [tap][cin / 8][cout / 8][lane][2] (kernels.py::
// mma_conv_layout).  Shared memory holds them as they come, then the input
// tile and conv1's region.
template <int C, int TH, int NW, bool PROJ, int XO>
struct ResBlockPlan {
  static constexpr int NT = 32 * NW;                        // threads: NW warps
  static constexpr int IH = TH + 4, IW = RES_TW + 2 * XO;   // input tile
  static constexpr int RH = TH + 2, RW = RES_TW + 2;        // conv1's region
  static constexpr int IP = plane(IH * IW), MP = plane(RH * RW);
  static constexpr int KC = C / 8, NB = C / 8;              // 8-channel k-steps, n-tiles
  static constexpr int MG1 = region_mg(RH * RW, NW, 3);     // conv1's m-tiles per round
  static constexpr int MG2 = TH * RES_TW / 16 / NW;         // conv2's m-tiles per warp
  static constexpr int W1 = 0, S1 = W1 + 9 * C * C, B1 = S1 + C, W2 = B1 + C,
                       S2 = W2 + 9 * C * C, B2 = S2 + C, WS = B2 + C,
                       WEND = WS + (PROJ ? C * C : 0);
  static constexpr int IN = WEND, MID = IN + C * IP, END = MID + C * MP;
  static_assert(C % 8 == 0 && WEND % 4 == 0, "16-byte weight copy, 8-channel k-steps");
  static_assert(TH * RES_TW % (16 * NW) == 0, "conv2's m-tiles split evenly");
  static_assert(XO >= 2, "conv1's region starts one pixel inside the input tile");
};

// Persistent: block i takes tiles i, i + gridDim.x, ...; tile index =
// (b * N + n) * tiles_h * tiles_w + ty * tiles_w + tx.
// vec: with XO a multiple of 4, the input tile by 16-byte copies (W % 4 == 0,
// x 16-byte aligned).
template <typename T, int C, int TH, int NW, int MINB, bool PROJ, int XO>
__global__ void __launch_bounds__(32 * NW, MINB)
res_block_kernel(const T* __restrict__ x, const float* __restrict__ params, T* __restrict__ y,
                 int N, int H, int W, int tiles_w, int tiles_h, int ntiles, bool vec) {
  using P = ResBlockPlan<C, TH, NW, PROJ, XO>;
  constexpr int NB = P::NB;
  // a widened bf16 is a TF32 already: conv1 and the projection have no lo.hi term
  constexpr bool BF16_IN = !std::is_same<T, float>::value;
  extern __shared__ __align__(16) float smem[];
  float* in_s = smem + P::IN;
  float* mid = smem + P::MID;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int64_t hw = (int64_t)H * W;
  const int64_t cstride = (int64_t)N * hw;
  const int per_slice = tiles_w * tiles_h;
  auto slice_base = [&](int tile) {
    const int bn = tile / per_slice;
    return ((int64_t)(bn / N) * C * N + bn % N) * hw;
  };
  auto stage = [&](int tile) {
    const int r = tile % per_slice;
    const int gh0 = r / tiles_w * TH - 2, gw0 = r % tiles_w * RES_TW - XO;
    if constexpr (XO % 4 == 0) {
      stage_tile_any<C, P::IH, P::IW, P::IP, P::NT>(x, slice_base(tile), cstride, in_s, gh0, gw0,
                                                    H, W, vec);
    } else {
      stage_tile<C, P::IH, P::IW, P::IP, P::NT>(x, slice_base(tile), cstride, in_s, gh0, gw0, H,
                                                W);
    }
  };

  // the weights, once per block, then BN2's scale folded into w2 (entry i of
  // its fragments holds output channel 8 (i / 64 % NB) + i / 8 % 8), so that
  // the shortcut can start conv2's accumulators; the first tile meanwhile
  for (int i = threadIdx.x; i < P::WEND / 4; i += P::NT) cp_async16(smem + 4 * i, params + 4 * i);
  cp_async_commit();
  stage(blockIdx.x);
  cp_async_commit();
  cp_async_wait_older();
  __syncthreads();
  for (int i = threadIdx.x; i < 9 * C * C; i += P::NT) {
    smem[P::W2 + i] *= smem[P::S2 + i / 64 % NB * 8 + i / 8 % 8];
  }

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int r = tile % per_slice;
    const int th0 = r / tiles_w * TH, tw0 = r % tiles_w * RES_TW;
    cp_async_wait_all();
    __syncthreads();  // this tile's input is in (w2 is scaled); mid is free

    // conv1 -> BN1 -> ReLU into mid ([C][RH][RW], planes MP apart), 0 outside
    // the image; region position (ry, rx) is image pixel (th0 - 1 + ry, tw0 - 1
    // + rx) and reads the input tile from (ry, rx + XO - 2)
    const float* s1 = smem + P::S1;
    const float* b1 = smem + P::B1;
    region_mma<NW, P::MG1, NB, P::RH * P::RW>(
        warp, lane,
        [&](const int(&p0)[P::MG1], const int(&p1)[P::MG1], int nvalid,
            float(&acc)[P::MG1][NB][2][4]) {
          int pa[P::MG1], pb[P::MG1];
          region_offsets<P::RW, P::IW>(p0, t * P::IP + XO - 2, pa);
          region_offsets<P::RW, P::IW>(p1, t * P::IP + XO - 2, pb);
          conv3x3_mma<C, P::MG1, NB, P::IP, P::IW, BF16_IN>(in_s, pa, pb, nvalid, smem + P::W1,
                                                            lane, acc);
        },
        [&](int p, int co, float v) {
          const bool inside = in_image(th0 - 1 + p / P::RW, tw0 - 1 + p % P::RW, H, W);
          mid[co * P::MP + p] = inside ? fmaxf(fmaf(v, s1[co], b1[co]), 0.f) : 0.f;
        });

    // the shortcut into conv2's accumulators; the warp's output m-tiles are
    // warp * MG2 + j, 16 pixels of one 32-pixel row each
    float acc[P::MG2][NB][2][4] = {};
    int pa[P::MG2], pb[P::MG2];
#pragma unroll
    for (int j = 0; j < P::MG2; ++j) {
      const int p = (warp * P::MG2 + j) * 16 + g;
      pa[j] = (p / RES_TW + 2) * P::IW + p % RES_TW + XO;
      pb[j] = pa[j] + 8;
    }
    if constexpr (PROJ) {
#pragma unroll
      for (int j = 0; j < P::MG2; ++j) {
        pa[j] += t * P::IP;
        pb[j] += t * P::IP;
      }
      const float2* ws = reinterpret_cast<const float2*>(smem + P::WS);
#pragma unroll
      for (int kc = 0; kc < P::KC; ++kc) {
        mma_kstep_at<P::MG2, NB, BF16_IN>(in_s, pa, pb, kc * 8 * P::IP, (kc * 8 + 4) * P::IP,
                                          P::MG2, ws + kc * NB * 32, lane, acc);
      }
    } else {
      // the exact x: thread (g, t) holds channels 2t, 2t + 1 of pixels g, g + 8
#pragma unroll
      for (int j = 0; j < P::MG2; ++j) {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            acc[j][nb][0][k] = in_s[(nb * 8 + 2 * t + k % 2) * P::IP + (k / 2 ? pb[j] : pa[j])];
          }
        }
      }
    }
    __syncthreads();  // mid is complete, and no warp reads the input tile again

    if (tile + gridDim.x < ntiles) stage(tile + gridDim.x);
    cp_async_commit();

    // conv2 (BN2's scale in its weights) from mid, + BN2's shift, ReLU
#pragma unroll
    for (int j = 0; j < P::MG2; ++j) {
      const int p = (warp * P::MG2 + j) * 16 + g;
      pa[j] = t * P::MP + p / RES_TW * P::RW + p % RES_TW;
      pb[j] = pa[j] + 8;
    }
    conv3x3_mma<C, P::MG2, NB, P::MP, P::RW>(mid, pa, pb, P::MG2, smem + P::W2, lane, acc);
    const float* b2 = smem + P::B2;
    const int64_t obase = slice_base(tile);
#pragma unroll
    for (int j = 0; j < P::MG2; ++j) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int p = (warp * P::MG2 + j) * 16 + g + 8 * (k / 2);
          const int co = nb * 8 + 2 * t + k % 2;
          const int gh = th0 + p / RES_TW, gw = tw0 + p % RES_TW;
          if (gh < H && gw < W) {
            store(y, obase + co * cstride + (int64_t)gh * W + gw,
                  fmaxf(acc[j][nb][0][k] + acc[j][nb][1][k] + b2[co], 0.f));
          }
        }
      }
    }
  }
  cp_async_wait_all();
}

template <typename T, int C, int TH, int NW, int MINB, bool PROJ, int XO>
cudaError_t launch_res_block(const void* x, const void* params, void* y, int B, int N, int H,
                             int W, cudaStream_t stream) {
  using P = ResBlockPlan<C, TH, NW, PROJ, XO>;
  const auto kernel = res_block_kernel<T, C, TH, NW, MINB, PROJ, XO>;
  const int bytes = P::END * static_cast<int>(sizeof(float));
  const int tiles_w = (W + RES_TW - 1) / RES_TW, tiles_h = (H + TH - 1) / TH;
  const int64_t ntiles = (int64_t)B * N * tiles_w * tiles_h;
  int grid = 0;
  const cudaError_t err = persistent_grid(kernel, P::NT, bytes, ntiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, P::NT, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(params), static_cast<T*>(y), N, H, W,
      tiles_w, tiles_h, static_cast<int>(ntiles), vec_ok(x, W));
  return cudaGetLastError();
}

}  // namespace dffx
