// rb2d_residual: the SRD's residual pair of (1,3,3) convs, eval mode.
//
// Replaces the TPU kernel dffx/ops/pallas_kernels.py::rb2d_residual_cf (body
// _rb2d_kernel).  Computes, per focal slice,
//   relu(x + BN2(conv2(relu(BN1(conv1(x))))))
// with two bias-free C -> C (1,3,3) convs at pad 1, on (B, C, N, H, W), for
// C = 8, 16 and 32 (DFFNet serves it at C = 8, full resolution).
//
// What bounds it on the card: 2 x 9 x C^2 FMAs per pixel (1,152 at C = 8,
// 2.3 kFLOP) against 8C bytes of fp32 traffic (64 at C = 8), 36 FLOP/byte.  At
// 1 x 8 x 10 x 608 x 1088 the HBM time is 0.126 ms, the fp32 FMA pipe's 0.23 ms
// and the tensor cores' in 3xTF32 0.092 ms: device memory bounds it.  The
// first design ran on the FMA pipe, one thread a pixel on 32 x 8 tiles, read
// one shared-memory word per 8 FMAs and transposed all 1,152 weights from
// device memory for every tile.
//
// What the design does about it: the block of res_block.cuh with an identity
// shortcut.  Both convs are implicit GEMMs on mma.sync m16n8k8 TF32 in the
// 3xTF32 split (at C = 8 one n-tile, nine k-steps a conv); a persistent grid
// walks 32 x 16 tiles (1.2x halo recompute in conv1), with the weights copied
// once per block, already as B fragments (kernels.py::rb2d_params), and the
// input tile staged from column tw0 - 4 so that it arrives by 16-byte
// cp.async; the next tile's is in flight while conv2 runs.  The shortcut is
// the exact fp32 x: BN2's scale is folded into w2 and conv2's accumulators
// start from the staged tile's centre.  The slice is part of the tile index,
// not a grid dimension: any B * N.
// Measured on the H100 (700 W), kernel alone, against the first design in the
// same run: 0.53 ms at 1 x 8 x 10 x 608 x 1088 in fp32 (0.87-0.89), 0.13 at
// 1 x 8 x 10 x 384 x 384 (0.21-0.22): 95 TFLOP/s of TF32
// MMAs, of the 328 that bare mma.sync reaches there (dffx_torch/bench.py
// --what mma).  By the counts of a tile, tensor pipe, shared-memory wavefronts
// and instruction slots are each about a third busy: the two barriers a tile put a
// block's warps into the same phase, and two blocks of 8 warps per SM (121
// registers) overlap little.  Variants that lost there: three blocks per SM at
// 80 registers (172 bytes of spills, 0.61 ms), 32 x 8 tiles (0.63-0.65),
// conv1's output written as its two TF32 parts so that conv2's loop has no
// split (0.58 against 0.55: twice the shared-memory loads for half the ALU
// work), and m-tiles of 8 pixels of two rows whose taps share their loads
// (0.57-0.59 against 0.52-0.54: a third fewer loads and splits, 8 % more
// m-tiles; the time followed the m-tiles).
//
// bf16 has a design of its own (below).  What bounds it on the card: the
// function is 2 x 9 x C^2 bf16 products a pixel (one each at 989 TFLOP/s:
// 0.023 ms at 1 x 8 x 10 x 608 x 1088) against 2C bytes (32 at C = 8: 0.063
// ms), so HBM bounds it.  Done fp32-accurately (bf16 in, fp32 inside, only the
// output rounded: bf16_mma.cuh) conv1 is x.w1_hi + x.w1_lo and conv2, whose
// input is conv1's fp32 region, hi.hi + hi.lo + lo.hi: five bf16 MMAs of
// m16n8k16 where the fp32 design's block on widened bf16 ran two and three
// TF32 MMAs of half the k (0.49 ms).
//
// What the bf16 design does about it:
// * Shared memory holds every operand as bf16 with a pixel's C channels
//   contiguous, so that an A register is two channels of one pixel and
//   ldmatrix loads a fragment: K = 9C in the order (tap, channel), k-steps of
//   16 (at C = 8 two taps, the ninth as an m16n8k8 step).  A pixel's 16-byte
//   chunks are XOR-swizzled at C = 16 and 32 (chunk_at), and the input
//   tile's rows are 42 pixels apart (the region's 34 + 8), so that the eight
//   rows of every ldmatrix hit eight distinct bank groups.
// * The input is channel-first in device memory.  The raw bf16 tile
//   ([C][TH + 4][40], from column tw0 - 4) arrives by 8-byte cp.async while
//   the last tile's convs run; one pass transposes it, a thread a pixel and
//   8-channel chunk (eight 2-byte loads, one 16-byte store), and the raw
//   buffer takes the next tile's copy at once, before conv1.
// * conv1 -> BN1 -> ReLU is written once as two bf16 planes, hi and lo of the
//   fp32 value (0 outside the image), which conv2 reads by ldmatrix: the split
//   costs one conversion a value instead of one a value and tap.  BN2's scale
//   is folded into w2 by the wrapper before the split (kernels.py::
//   rb2d_params), and the identity shortcut, the exact x, starts conv2's
//   accumulators.
// * The fp32 design's persistent grid and weights copied once a block in
//   fragment order; at C = 8 the tiles are 32 x 32 (32 x 16 at 16, 32 x 8 at
//   32): against 32 x 16, half the barriers a pixel and 1.13 of conv1's
//   region positions a pixel instead of 1.20; conv2 runs in rounds of at most
//   four accumulator tiles.
// Measured on an NVIDIA H100 80GB HBM3 (700.00 W), launches back to back,
// against the fp32 design's block on widened bf16 in the same call
// (dffx_torch/bench.py --what kernels --root): 0.320 ms at 1 x 8 x 10 x 608 x
// 1088 (0.486-0.489), 8.65-8.68 at 128 x 8 x 10 x 384 x 384 (13.43-13.52).
// A 32 x 32 tile at C = 8 takes 730 MMAs in conv1 (73 m-tiles of the 34 x 34
// region, four k16 steps and one k8, two products) and 960 in conv2 (64
// m-tiles, three products), 365 + 640 ldmatrix, three barriers; 124
// registers, no spills, two blocks of 89.4 KB an SM.  Variants that lost,
// each in one call with the kept design: conv1's region kept fp32 and split
// at every load (0.384 ms against 0.351-0.357 for the two planes, both on
// 32 x 16 tiles), each half's tap chosen per lane from two constants (0.394),
// that variant at three blocks an SM (80 registers, 16 bytes of spills:
// 0.369), 32 x 32 tiles with 16 warps (0.367 against 0.322 with 8).
#include "bf16_mma.cuh"
#include "res_block.cuh"

namespace {

// res_block.cuh's block with the identity shortcut (no projection), its input
// tile staged from column tw0 - 4: <T, C, tile height, warps, blocks per SM, ...>
constexpr bool PROJ = false;
constexpr int XO = 4;

cudaError_t dispatch_fp32(int C, const void* x, const void* params, void* y, int B, int N, int H,
                          int W, cudaStream_t stream) {
  using dffx::launch_res_block;
  switch (C) {
    case 8: return launch_res_block<float, 8, 16, 8, 2, PROJ, XO>(x, params, y, B, N, H, W, stream);
    case 16: return launch_res_block<float, 16, 16, 8, 2, PROJ, XO>(x, params, y, B, N, H, W, stream);
    case 32: return launch_res_block<float, 32, 8, 8, 1, PROJ, XO>(x, params, y, B, N, H, W, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16
// ---------------------------------------------------------------------------

// Where chunk q (channels 8q .. 8q + 7) of pixel pix of a [pixels][C] bf16
// tile sits, in 16-byte chunks: XOR-swizzled by the pixel, so that chunk q of
// 8 consecutive pixels lies in 8 distinct bank groups.
template <int NCH>
__device__ __forceinline__ int chunk_at(int pix, int q) {
  return pix * NCH + (q ^ (pix / (8 / NCH) % NCH));
}

// Tile, fragment and shared-memory plan of a block of NW warps on TH x 32 tiles.
template <int C, int TH, int NW>
struct Bf16Plan {
  static constexpr int NT = 32 * NW;
  static constexpr int TW = dffx::RES_TW;
  static constexpr int IH = TH + 4, IW = TW + 2 * XO;  // raw input tile [C][IH][IW]
  static constexpr int RH = TH + 2, RW = TW + 2;       // conv1's region
  // pixel rows of the interleaved input tile: the region's plus 8, so that 8
  // consecutive region positions are 8 consecutive pixels (mod 8) across a row
  static constexpr int ISW = RW + 8;
  static constexpr int NCH = C / 8;                     // 16-byte chunks a pixel; n-tiles
  static constexpr int KS = (9 * C + 15) / 16;          // k-steps of a conv (C = 8: the last is k8)
  static constexpr int FW = KS * NCH * 128;             // words of a conv's B fragments
  // parameters as the wrapper packs them (rb2d_params of a bf16 x), in words:
  // w1's fragments, s1, b1, w2's (BN2's scale folded in), b2
  static constexpr int W1 = 0, S1 = W1 + FW, B1 = S1 + C, W2 = B1 + C, B2 = W2 + FW,
                       WEND = B2 + C;
  // shared memory, in words: the parameters, the raw tile, the interleaved
  // tile [IH * ISW][C], conv1's region as hi and lo planes [RH * RW][C]
  static constexpr int RAW = WEND, XIN = RAW + C * IH * IW / 2, MIDH = XIN + IH * ISW * C / 2,
                       MIDL = MIDH + RH * RW * C / 2, END = MIDL + RH * RW * C / 2;
  static constexpr int MG1 = dffx::region_mg(RH * RW, NW, 3);  // conv1's m-tiles a round
  static constexpr int MG2 = TH * TW / 16 / NW;                 // conv2's m-tiles a warp
  // conv2's m-tiles a round: at most 4 accumulator tiles (m-tiles x n-tiles)
  static constexpr int MGR = MG2 * NCH <= 4 ? MG2 : 4 / NCH;
  static_assert(WEND % 4 == 0 && XIN % 4 == 0 && MIDH % 4 == 0 && MIDL % 4 == 0,
                "16-byte copies and ldmatrix rows");
  static_assert(ISW >= IW && TH * TW % (16 * NW) == 0 && MG2 % MGR == 0,
                "conv2's m-tiles split evenly");
};

// The A fragment of k-step s (k = tap * C + channel, tap = 3 dy + dx) of a conv
// over a [pixels][C] bf16 tile at shared-memory address base whose rows are RS
// pixels apart; pix: the pixel that this lane's ldmatrix row (m-tile pixel
// lane % 16) reads at tap (0, 0).  k8: the last k-step at C = 8, a[0..1].
template <int C, int RS>
__device__ __forceinline__ void conv_a(uint32_t base, int pix, int lane, int s, bool k8,
                                       uint32_t (&a)[4]) {
  const int k = 16 * s + (k8 ? 0 : 8 * (lane / 16));
  const int tap = k / C;
  const uint32_t addr = base + 16u * chunk_at<C / 8>(pix + tap / 3 * RS + tap % 3, k % C / 8);
  if (k8) {
    dffx::ldmatrix_x2(a[0], a[1], addr);
  } else {
    dffx::ldmatrix_x4(a, addr);
  }
}

// k-step s's B fragments of NB n-tiles, {hi b0, hi b1, lo b0, lo b1} a lane
template <int NB>
__device__ __forceinline__ void conv_b(const float* frag, int s, int lane, uint4 (&b)[NB]) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    b[nb] = reinterpret_cast<const uint4*>(frag)[(s * NB + nb) * 32 + lane];
  }
}

// Persistent: block i takes tiles i, i + gridDim.x, ...; tile index =
// (b * N + n) * tiles_h * tiles_w + ty * tiles_w + tx.  vec: the raw tile by
// 8-byte cp.async (W % 4 == 0, x 8-byte aligned).
template <int C, int TH, int NW, int MINB>
__global__ void __launch_bounds__(32 * NW, MINB)
rb2d_bf16_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ params,
                 __nv_bfloat16* __restrict__ y, int N, int H, int W, int tiles_w, int tiles_h,
                 int ntiles, bool vec) {
  using P = Bf16Plan<C, TH, NW>;
  constexpr int NB = P::NCH, KS = P::KS, TW = P::TW;
  extern __shared__ __align__(16) float smem[];
  __nv_bfloat16* raw = reinterpret_cast<__nv_bfloat16*>(smem + P::RAW);
  const uint32_t* xin = reinterpret_cast<const uint32_t*>(smem + P::XIN);
  uint32_t* midh = reinterpret_cast<uint32_t*>(smem + P::MIDH);
  uint32_t* midl = reinterpret_cast<uint32_t*>(smem + P::MIDL);
  const uint32_t xin_at = dffx::smem_addr(smem + P::XIN);
  const uint32_t midh_at = dffx::smem_addr(smem + P::MIDH);
  const uint32_t midl_at = dffx::smem_addr(smem + P::MIDL);
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
    dffx::stage_bf16<C, P::IH, P::IW, P::NT, 4>(x, slice_base(tile), cstride, raw,
                                                r / tiles_w * TH - 2, r % tiles_w * TW - XO, H,
                                                W, vec);
  };

  for (int i = threadIdx.x; i < P::WEND / 4; i += P::NT) {
    dffx::cp_async16(smem + 4 * i, params + 4 * i);
  }
  stage(blockIdx.x);
  dffx::cp_async_commit();

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int r = tile % per_slice;
    const int th0 = r / tiles_w * TH, tw0 = r % tiles_w * TW;
    dffx::cp_async_wait_all();
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
    dffx::cp_async_commit();

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
            dffx::mma_bf16_split_b(a, b, nv, k8, acc);
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
            const bool inside = dffx::in_image(th0 - 1 + p / P::RW, tw0 - 1 + p % P::RW, H, W);
#pragma unroll
            for (int nb = 0; nb < NB; ++nb) {
              const int co = nb * 8 + 2 * t;
              const float v0 = inside ? fmaxf(fmaf(acc[j][nb][2 * h], s1[co], b1[co]), 0.f) : 0.f;
              const float v1 =
                  inside ? fmaxf(fmaf(acc[j][nb][2 * h + 1], s1[co + 1], b1[co + 1]), 0.f) : 0.f;
              uint32_t hi, lo;
              dffx::split_bf16x2(v0, v1, hi, lo);
              const int w = chunk_at<NB>(p, nb) * 4 + t;
              midh[w] = hi;
              midl[w] = lo;
            }
          }
        }
      }
    }

    __syncthreads();  // the region is complete

    // conv2 (BN2's scale in its weights) from the region's hi and lo planes,
    // hi.w_hi + hi.w_lo + lo.w_hi, its accumulators started from the exact x
    // (the shortcut), + BN2's shift, ReLU.  The warp's output m-tiles are
    // warp * MG2 + j, 16 pixels of one 32-pixel row each, MGR of them a round.
    constexpr int MG = P::MGR;
    const float* b2 = smem + P::B2;
    const int64_t obase = slice_base(tile);
#pragma unroll 1
    for (int r0 = warp * P::MG2; r0 < (warp + 1) * P::MG2; r0 += MG) {
      float acc[MG][NB][4];
      int pix[MG];
#pragma unroll
      for (int j = 0; j < MG; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int op = (r0 + j) * 16 + g + 8 * h;
          const int pin = (op / TW + 2) * P::ISW + op % TW + XO;
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            const uint32_t w = xin[chunk_at<NB>(pin, nb) * 4 + t];
            acc[j][nb][2 * h] = dffx::bf16_low(w);
            acc[j][nb][2 * h + 1] = dffx::bf16_high(w);
          }
        }
        const int op = (r0 + j) * 16 + lane % 16;
        pix[j] = op / TW * P::RW + op % TW;
      }
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const bool k8 = 16 * s + 8 >= 9 * C;
        uint4 b[NB];
        conv_b<NB>(smem + P::W2, s, lane, b);
        uint32_t ah[MG][4], al[MG][4];
#pragma unroll
        for (int j = 0; j < MG; ++j) {
          conv_a<C, P::RW>(midh_at, pix[j], lane, s, k8, ah[j]);
          conv_a<C, P::RW>(midl_at, pix[j], lane, s, k8, al[j]);
        }
        dffx::mma_bf16_split_b(ah, b, MG, k8, acc);
        dffx::mma_bf16_part<0>(al, b, MG, k8, acc);
      }
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
              dffx::store(y, obase + co * cstride + (int64_t)gh * W + gw,
                          fmaxf(acc[j][nb][k] + b2[co], 0.f));
            }
          }
        }
      }
    }
  }
  dffx::cp_async_wait_all();
}

template <int C, int TH, int NW, int MINB>
cudaError_t launch_bf16(const void* x, const void* params, void* y, int B, int N, int H, int W,
                        cudaStream_t stream) {
  using P = Bf16Plan<C, TH, NW>;
  const auto kernel = rb2d_bf16_kernel<C, TH, NW, MINB>;
  const int bytes = P::END * static_cast<int>(sizeof(float));
  const int tiles_w = (W + P::TW - 1) / P::TW, tiles_h = (H + TH - 1) / TH;
  const int64_t ntiles = (int64_t)B * N * tiles_w * tiles_h;
  int grid = 0;
  const cudaError_t err = dffx::persistent_grid(kernel, P::NT, bytes, ntiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, P::NT, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(params),
      static_cast<__nv_bfloat16*>(y), N, H, W, tiles_w, tiles_h, static_cast<int>(ntiles),
      dffx::vec_ok_bf16(x, W, 4));
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(int C, const void* x, const void* params, void* y, int B, int N, int H,
                          int W, cudaStream_t stream) {
  switch (C) {
    case 8: return launch_bf16<8, 32, 8, 2>(x, params, y, B, N, H, W, stream);
    case 16: return launch_bf16<16, 16, 8, 2>(x, params, y, B, N, H, W, stream);
    case 32: return launch_bf16<32, 8, 8, 1>(x, params, y, B, N, H, W, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).
extern "C" int dffx_rb2d_residual(const void* x, const void* params, void* y, int B, int C,
                                  int N, int H, int W, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DFFX_DTYPE_F32) return dispatch_fp32(C, x, params, y, B, N, H, W, s);
  if (dtype == DFFX_DTYPE_BF16) return dispatch_bf16(C, x, params, y, B, N, H, W, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
