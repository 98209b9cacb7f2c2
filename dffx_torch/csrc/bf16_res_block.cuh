// The bf16 residual block of two (1,3,3) C -> C convs, eval mode, for C = 8,
// 16 and 32: rb2d.cu's (identity shortcut) and rb_of.cu's 16- and 32-channel
// levels (1x1 projection shortcut, PROJ):
//   y = relu(S(x) + BN2(conv2(relu(BN1(conv1(x))))))
// with S(x) = x or Ws x, bias-free pad-1 convs, per focal slice of
// (B, C, N, H, W); bf16 in and out, fp32 inside (bf16_mma.cuh).  conv1's
// output is 0 outside the image, as conv2's zero padding requires:
// relu(BN1(0)) is not 0 wherever BN1's shift is positive.  rb2d.cu's notes
// give the design, its measurements and the variants that lost; in short:
// * The raw bf16 tile ([C][TH + 4][40], from column tw0 - 4) arrives by 8-byte
//   cp.async while the last tile's convs run; one pass transposes it to a
//   pixel-major tile (rows 42 pixels apart, chunks swizzled), and the raw
//   buffer takes the next tile's copy at once, before conv1.
// * conv1 = x.w1_hi + x.w1_lo by ldmatrix fragments; BN1, ReLU, and the
//   region written once as bf16 hi and lo planes; conv2 = hi.w2_hi + hi.w2_lo
//   + lo.w2_hi with BN2's scale folded into w2 by the wrapper.
// * The shortcut goes into conv2's accumulators first: the identity as the
//   exact x of the tile's centre; the projection as C / 16 k16 steps of the
//   same centre by ldmatrix, x.ws_hi + x.ws_lo (x is exact in bf16).
// * A persistent grid over TH x 32 tiles, the weights copied once a block in
//   fragment order; conv2 in rounds of at most four accumulator tiles.
#pragma once

#include "bf16_mma.cuh"

namespace dffx {

constexpr int BF16_RES_TW = 32;
constexpr int BF16_RES_XO = 4;  // the tile's column in its staged input

// Tile, fragment and shared-memory plan of a block of NW warps on TH x 32 tiles.
template <int C, int TH, int NW, bool PROJ>
struct Bf16ResPlan {
  static constexpr int NT = 32 * NW;
  static constexpr int TW = BF16_RES_TW, XO = BF16_RES_XO;
  static constexpr int IH = TH + 4, IW = TW + 2 * XO;  // raw input tile [C][IH][IW]
  static constexpr int RH = TH + 2, RW = TW + 2;       // conv1's region
  // pixel rows of the interleaved input tile: the region's plus 8, so that 8
  // consecutive region positions are 8 consecutive pixels (mod 8) across a row
  static constexpr int ISW = RW + 8;
  static constexpr int NCH = C / 8;                     // 16-byte chunks a pixel; n-tiles
  static constexpr int KS = (9 * C + 15) / 16;          // k-steps of a conv (C = 8: the last is k8)
  static constexpr int FW = KS * NCH * 128;             // words of a conv's B fragments
  static constexpr int KSS = PROJ ? C / 16 : 0;         // k-steps of the projection
  // parameters as the wrapper packs them (rb2d_params, rb_of_chain_params of a
  // bf16 x), in words: w1's fragments, s1, b1, w2's (BN2's scale folded in),
  // b2 and, with PROJ, ws's
  static constexpr int W1 = 0, S1 = W1 + FW, B1 = S1 + C, W2 = B1 + C, B2 = W2 + FW,
                       WS = B2 + C, WEND = WS + KSS * NCH * 128;
  // shared memory, in words: the parameters, the raw tile, the interleaved
  // tile [IH * ISW][C], conv1's region as hi and lo planes [RH * RW][C]
  static constexpr int RAW = WEND, XIN = RAW + C * IH * IW / 2, MIDH = XIN + IH * ISW * C / 2,
                       MIDL = MIDH + RH * RW * C / 2, END = MIDL + RH * RW * C / 2;
  static constexpr int MG1 = region_mg(RH * RW, NW, 3);  // conv1's m-tiles a round
  static constexpr int MG2 = TH * TW / 16 / NW;           // conv2's m-tiles a warp
  // conv2's m-tiles a round: at most 4 accumulator tiles (m-tiles x n-tiles)
  static constexpr int MGR = MG2 * NCH <= 4 ? MG2 : 4 / NCH;
  static_assert(WEND % 4 == 0 && XIN % 4 == 0 && MIDH % 4 == 0 && MIDL % 4 == 0,
                "16-byte copies and ldmatrix rows");
  static_assert(ISW >= IW && TH * TW % (16 * NW) == 0 && MG2 % MGR == 0,
                "conv2's m-tiles split evenly");
  static_assert(!PROJ || C % 16 == 0, "the projection in k16 steps");
};

// Persistent: block i takes tiles i, i + gridDim.x, ...; tile index =
// (b * N + n) * tiles_h * tiles_w + ty * tiles_w + tx.  vec: the raw tile by
// 8-byte cp.async (W % 4 == 0, x 8-byte aligned).
template <int C, int TH, int NW, int MINB, bool PROJ>
__global__ void __launch_bounds__(32 * NW, MINB)
bf16_res_block_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ params,
                      __nv_bfloat16* __restrict__ y, int N, int H, int W, int tiles_w,
                      int tiles_h, int ntiles, bool vec) {
  using P = Bf16ResPlan<C, TH, NW, PROJ>;
  constexpr int NB = P::NCH, KS = P::KS, TW = P::TW, XO = P::XO;
  extern __shared__ __align__(16) float smem[];
  __nv_bfloat16* raw = reinterpret_cast<__nv_bfloat16*>(smem + P::RAW);
  const uint32_t* xin = reinterpret_cast<const uint32_t*>(smem + P::XIN);
  uint32_t* midh = reinterpret_cast<uint32_t*>(smem + P::MIDH);
  uint32_t* midl = reinterpret_cast<uint32_t*>(smem + P::MIDL);
  const uint32_t xin_at = smem_addr(smem + P::XIN);
  const uint32_t midh_at = smem_addr(smem + P::MIDH);
  const uint32_t midl_at = smem_addr(smem + P::MIDL);
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
    stage_bf16<C, P::IH, P::IW, P::NT, 4>(x, slice_base(tile), cstride, raw,
                                          r / tiles_w * TH - 2, r % tiles_w * TW - XO, H, W,
                                          vec);
  };

  for (int i = threadIdx.x; i < P::WEND / 4; i += P::NT) {
    cp_async16(smem + 4 * i, params + 4 * i);
  }
  stage(blockIdx.x);
  cp_async_commit();

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int r = tile % per_slice;
    const int th0 = r / tiles_w * TH, tw0 = r % tiles_w * TW;
    cp_async_wait_all();
    __syncthreads();  // the raw tile is in; no warp reads the interleaved tile or the region

    // the raw tile transposed, a thread a pixel and 8-channel chunk
    {
      constexpr int PIX = P::IH * P::IW;
      const unsigned short* r16 = reinterpret_cast<const unsigned short*>(raw);
      uint4* dst = reinterpret_cast<uint4*>(smem + P::XIN);
      for (int i = threadIdx.x; i < PIX * NB; i += P::NT) {
        const int q = i / PIX, pix = i % PIX;
        const unsigned short* src = r16 + 8 * q * PIX + pix;
        uint32_t w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          w[k] = src[2 * k * PIX] | static_cast<uint32_t>(src[(2 * k + 1) * PIX]) << 16;
        }
        dst[chunk_at<NB>(pix / P::IW * P::ISW + pix % P::IW, q)] =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    __syncthreads();  // the interleaved tile is complete, and the raw buffer is free
    if (tile + gridDim.x < ntiles) stage(tile + gridDim.x);
    cp_async_commit();

    // conv1 -> BN1 -> ReLU into the region's hi and lo planes, 0 outside the
    // image; region position (ry, rx) is image pixel (th0 - 1 + ry, tw0 - 1 +
    // rx) and reads the input tile from (ry, rx + XO - 2).  A warp's m-tiles
    // are warp, warp + NW, ..., MG1 of them a round.
    {
      constexpr int NPOS = P::RH * P::RW, M = (NPOS + 15) / 16, MG = P::MG1;
      const float* s1 = smem + P::S1;
      const float* b1 = smem + P::B1;
      const int mine = (M - warp + NW - 1) / NW;
#pragma unroll 1
      for (int i0 = 0; i0 < mine; i0 += MG) {
        const int nvalid = min(mine - i0, MG);
        int pix[MG];
#pragma unroll
        for (int j = 0; j < MG; ++j) {
          const int p = min((warp + (i0 + j) * NW) * 16 + lane % 16, NPOS - 1);
          pix[j] = p / P::RW * P::ISW + p % P::RW + XO - 2;
        }
        float acc[MG][NB][4] = {};
        auto conv1 = [&](int nv) {
#pragma unroll
          for (int s = 0; s < KS; ++s) {
            const bool k8 = 16 * s + 8 >= 9 * C;
            uint4 b[NB];
            conv_b<NB>(smem + P::W1, s, lane, b);
            uint32_t a[MG][4];
#pragma unroll
            for (int j = 0; j < MG; ++j) {
              if (j < nv) conv_a<C, P::ISW>(xin_at, pix[j], lane, s, k8, a[j]);
            }
            mma_bf16_split_b(a, b, nv, k8, acc);
          }
        };
        // a full round gets its count as a constant: no branch around an m-tile
        if (nvalid == MG) {
          conv1(MG);
        } else {
          conv1(nvalid);
        }
#pragma unroll
        for (int j = 0; j < MG; ++j) {
          if (j >= nvalid) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = (warp + (i0 + j) * NW) * 16 + g + 8 * h;
            if (p >= NPOS) continue;
            const bool inside = in_image(th0 - 1 + p / P::RW, tw0 - 1 + p % P::RW, H, W);
#pragma unroll
            for (int nb = 0; nb < NB; ++nb) {
              const int co = nb * 8 + 2 * t;
              const float v0 = inside ? fmaxf(fmaf(acc[j][nb][2 * h], s1[co], b1[co]), 0.f) : 0.f;
              const float v1 =
                  inside ? fmaxf(fmaf(acc[j][nb][2 * h + 1], s1[co + 1], b1[co + 1]), 0.f) : 0.f;
              store_hilo<C>(midh, midl, p, co, v0, v1);
            }
          }
        }
      }
    }

    __syncthreads();  // the region is complete

    // The shortcut into conv2's accumulators, then conv2 (BN2's scale in its
    // weights) from the region's hi and lo planes, + BN2's shift, ReLU.  The
    // warp's output m-tiles are warp * MG2 + j, 16 pixels of one 32-pixel row
    // each, MGR of them a round.
    constexpr int MG = P::MGR;
    const float* b2 = smem + P::B2;
    const int64_t obase = slice_base(tile);
#pragma unroll 1
    for (int r0 = warp * P::MG2; r0 < (warp + 1) * P::MG2; r0 += MG) {
      float acc[MG][NB][4];
      int pix[MG];
#pragma unroll
      for (int j = 0; j < MG; ++j) {
        if constexpr (PROJ) {
          // Ws x from the input tile's centre: this lane's ldmatrix row
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[j][nb][k] = 0.f;
          }
          const int op = (r0 + j) * 16 + lane % 16;
          pix[j] = (op / TW + 2) * P::ISW + op % TW + XO;
        } else {
          // the exact x: thread (g, t) holds channels 2t, 2t + 1 of pixels g, g + 8
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int op = (r0 + j) * 16 + g + 8 * h;
            const int pin = (op / TW + 2) * P::ISW + op % TW + XO;
#pragma unroll
            for (int nb = 0; nb < NB; ++nb) {
              const uint32_t w = xin[chunk_at<NB>(pin, nb) * 4 + t];
              acc[j][nb][2 * h] = bf16_low(w);
              acc[j][nb][2 * h + 1] = bf16_high(w);
            }
          }
        }
      }
      if constexpr (PROJ) {
#pragma unroll
        for (int s = 0; s < P::KSS; ++s) {
          uint4 b[NB];
          conv_b<NB>(smem + P::WS, s, lane, b);
          uint32_t a[MG][4];
#pragma unroll
          for (int j = 0; j < MG; ++j) {
            ldmatrix_x4(a[j], xin_at + 16u * chunk_at<NB>(pix[j], 2 * s + lane / 16));
          }
          mma_bf16_split_b(a, b, MG, false, acc);
        }
      }
#pragma unroll
      for (int j = 0; j < MG; ++j) {
        const int op = (r0 + j) * 16 + lane % 16;
        pix[j] = op / TW * P::RW + op % TW;
      }
      conv3x3_hilo<C, P::RW>(midh_at, midl_at, pix, MG, smem + P::W2, lane, acc);
#pragma unroll
      for (int j = 0; j < MG; ++j) {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int op = (r0 + j) * 16 + g + 8 * (k / 2);
            const int co = nb * 8 + 2 * t + k % 2;
            const int gh = th0 + op / TW, gw = tw0 + op % TW;
            if (gh < H && gw < W) {
              store(y, obase + co * cstride + (int64_t)gh * W + gw,
                    fmaxf(acc[j][nb][k] + b2[co], 0.f));
            }
          }
        }
      }
    }
  }
  cp_async_wait_all();
}

template <int C, int TH, int NW, int MINB, bool PROJ>
cudaError_t launch_bf16_res_block(const void* x, const void* params, void* y, int B, int N,
                                  int H, int W, cudaStream_t stream) {
  using P = Bf16ResPlan<C, TH, NW, PROJ>;
  const auto kernel = bf16_res_block_kernel<C, TH, NW, MINB, PROJ>;
  const int bytes = P::END * static_cast<int>(sizeof(float));
  const int tiles_w = (W + P::TW - 1) / P::TW, tiles_h = (H + TH - 1) / TH;
  const int64_t ntiles = (int64_t)B * N * tiles_w * tiles_h;
  int grid = 0;
  const cudaError_t err = persistent_grid(kernel, P::NT, bytes, ntiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, P::NT, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(params),
      static_cast<__nv_bfloat16*>(y), N, H, W, tiles_w, tiles_h, static_cast<int>(ntiles),
      vec_ok_bf16(x, W, 4));
  return cudaGetLastError();
}

}  // namespace dffx
