// rb_of_chain: FlowNetwork's stride-1 resnet_block_2d_OF chain, eval mode.
//
// Replaces the TPU kernel dffx/ops/pallas_kernels.py::rb_of_chain_cf (body
// _rb_of_kernel).  Computes K consecutive blocks, per focal slice,
//   x <- relu(Ws x + BN2(conv2(relu(BN1(conv1(x))))))
// with bias-free (1,3,3) pad-1 convs and a 1x1 projection shortcut Ws, on
// (B, C, N, H, W), for FlowNetwork's three pyramid levels: the
// full-resolution pair 3 -> 8 -> 8 (K = 2), and one 16 -> 16 or 32 -> 32 block
// at half and quarter resolution (K = 1).  Every intermediate -- conv1 inside
// a block, block 0's output before block 1 -- is 0 outside the image, as the
// next conv's zero padding requires: relu(BN(0)) and relu(Ws 0 + shift) are
// not 0 wherever a BN shift is positive (the TPU kernel masks the same
// positions with store_masked).
//
// What bounds it on the card: a C -> C block is 19 C^2 FMAs per pixel (9.7
// kFLOP at C = 16, 38.9 at C = 32) against 8 C bytes of fp32 traffic, 76 and
// 152 FLOP/byte, so arithmetic bounds it, not HBM.  On the fp32 FMA pipe (67
// TFLOP/s) the shared-memory reads that feed the FMAs bound it first: the
// first design read 9 words per 32 FMAs at C = 32, kept one 177 KB block per
// SM, and restaged all 78 KB of weights for every 32 x 8 tile.  The 3 -> 8 -> 8
// pair (2,032 FMAs per pixel, 90 FLOP/byte) stays on that FMA design: its
// 3-channel input does not fill an 8-deep MMA step.
//
// What the design does about it, at C = 16 and 32:
// * The convs run on the tensor cores as implicit GEMMs (M = the tile's
//   pixels, N = Cout, K = 9 Cin): mma.sync m16n8k8 with TF32 operands.  Plain
//   TF32 misses the fp32 bound by 25-55x, so each operand is split into two
//   TF32 parts, v = hi + lo (cvt.rna), and a product is hi.hi + hi.lo + lo.hi
//   (3xTF32): fp32 accuracy at a third of the TF32 rate, still well above the
//   FMA pipe.  The tensor cores truncate each sum they accumulate, so the
//   small terms go to an accumulator of their own (see mma_kstep).
// * A persistent grid (blocks per SM from the occupancy API) walks the
//   tiles; each block copies the weights into shared memory once, already in
//   B-fragment order (the wrapper packs them), with 16-byte cp.async.
// * The input tile arrives by cp.async (4-byte, zero-filled outside the
//   image; bf16 is widened through registers).  Per tile: conv1 -> BN1 ->
//   ReLU into shared memory, then the shortcut Ws x straight into conv2's
//   accumulators (each block folds BN2's scale into its copy of w2), and the
//   input buffer is free: the next tile's input is in flight while conv2 runs.
// * Channel planes in shared memory are padded to a stride of 8 (mod 32)
//   floats, so every A-fragment load (8 pixels x 4 channels across the warp)
//   hits 32 distinct banks.
// * Tiles are 32 x 8 at C = 32 (183 KB of shared memory: one block per SM)
//   and 32 x 16 at C = 16 (107 KB: two blocks per SM, 1.2x halo recompute).
//   A 32 x 12 tile fits at C = 32 (216 KB) and cuts the halo from 1.33x to
//   1.24x, but measured slower on the H100 (0.50 against 0.47 ms at
//   1 x 32 x 10 x 152 x 272): its 30 conv1 m-tiles split unevenly over 8 warps.
// Now the instructions around the MMAs bound it: at C = 16 each m16n8k8 MMA
// comes with about four others (A-fragment loads, the hi/lo splits), at
// C = 32 about three, and the tensor cores run at a fifth to a quarter of
// their TF32 peak.
// The pair keeps one 32 x 8 tile per block, all output channels of a pixel in
// a thread's registers, weights as shared-memory broadcasts (chain.cuh).
#include "chain.cuh"

namespace {

using dffx::round4;

// ---------------------------------------------------------------------------
// The 3 -> 8 -> 8 pair: FMA design
// ---------------------------------------------------------------------------

constexpr int TW = 32, TH = 8, NT = TW * TH;

// One block's parameters as the wrapper packs them: w1, s1, b1, w2, s2, b2, ws
// (G_*), the convs in the design's layout -- [cin][tap][cout] for the FMA
// pair; in the pair's shared memory the same sections, each 16-byte aligned
// (S_*).
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
  dffx::load_vector<NT>(g + L::G_W1, s + L::S_W1, 9 * CI * C);
  dffx::load_vector<NT>(g + L::G_S1, s + L::S_S1, C);
  dffx::load_vector<NT>(g + L::G_B1, s + L::S_B1, C);
  dffx::load_vector<NT>(g + L::G_W2, s + L::S_W2, 9 * C * C);
  dffx::load_vector<NT>(g + L::G_S2, s + L::S_S2, C);
  dffx::load_vector<NT>(g + L::G_B2, s + L::S_B2, C);
  dffx::load_vector<NT>(g + L::G_WS, s + L::S_WS, CI * C);
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

// shared memory of the pair: both blocks' weights, the input tile with the
// chain's 4-pixel halo, conv1's region and block 0's output region
template <int CIN0, int C>
struct PairLayout {
  static constexpr int IH = TH + 8, IW = TW + 8;
  static constexpr int W0 = 0, W1 = W0 + OFBlock<CIN0, C>::S_END;
  static constexpr int IN = W1 + OFBlock<C, C>::S_END;                // [CIN0][IH][IW]
  static constexpr int MID = IN + round4(CIN0 * IH * IW);             // [C][IH-2][IW-2]
  static constexpr int BLK = MID + round4(C * (IH - 2) * (IW - 2));   // [C][IH-4][IW-4]
  static constexpr int END = BLK + round4(C * (IH - 4) * (IW - 4));
};

// one block per 32 x 8 tile; blockIdx.x = (b * N + n) * tiles_h * tiles_w + tile
template <typename T, int CIN0, int C>
__global__ void __launch_bounds__(NT)
rb_of_pair_kernel(const T* __restrict__ x, const float* __restrict__ params,
                  T* __restrict__ y, int N, int H, int W, int tiles_w, int tiles_h) {
  using L = PairLayout<CIN0, C>;
  extern __shared__ __align__(16) float smem[];
  load_block<CIN0, C>(params, smem + L::W0);
  load_block<C, C>(params + OFBlock<CIN0, C>::G_END, smem + L::W1);

  const int tile = blockIdx.x % (tiles_w * tiles_h), bn = blockIdx.x / (tiles_w * tiles_h);
  const int b = bn / N, n = bn % N;
  const int64_t hw = (int64_t)H * W;
  const int64_t cstride = (int64_t)N * hw;
  const int th0 = tile / tiles_w * TH, tw0 = tile % tiles_w * TW;
  dffx::load_tile<T, CIN0, L::IH, L::IW, NT>(x, ((int64_t)b * CIN0 * N + n) * hw, cstride,
                                             smem + L::IN, th0 - 4, tw0 - 4, H, W);
  __syncthreads();

  const int64_t obase = ((int64_t)b * C * N + n) * hw;
  of_block<T, CIN0, C, L::IH, L::IW, false>(smem + L::IN, smem + L::MID, smem + L::BLK,
                                            smem + L::W0, y, obase, cstride, th0 - 4, tw0 - 4,
                                            H, W);
  __syncthreads();  // block 0's output is complete; mid is free again
  of_block<T, C, C, L::IH - 4, L::IW - 4, true>(smem + L::BLK, smem + L::MID, nullptr,
                                                smem + L::W1, y, obase, cstride, th0 - 2,
                                                tw0 - 2, H, W);
}

template <typename T, int CIN0, int C>
cudaError_t launch_pair(const void* x, const void* params, void* y, int B, int N, int H,
                        int W, cudaStream_t stream) {
  const int bytes = PairLayout<CIN0, C>::END * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(rb_of_pair_kernel<T, CIN0, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const int64_t blocks = (int64_t)B * N * tiles_w * tiles_h;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  rb_of_pair_kernel<T, CIN0, C><<<static_cast<unsigned>(blocks), NT, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(params), static_cast<T*>(y), N, H,
      W, tiles_w, tiles_h);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// One C -> C block (C = 16, 32): tensor cores, 3xTF32
// ---------------------------------------------------------------------------

constexpr int MMA_TW = 32;

// the smallest plane stride >= n that is 8 (mod 32) floats
__host__ __device__ constexpr int plane(int n) { return n + ((8 - n % 32) + 32) % 32; }

// Tile, fragment and shared-memory plan of one C -> C block on TH x 32 tiles.
// Parameters as the wrapper packs them (OFBlock's sections), each conv as B
// fragments [tap][cin / 8][cout / 8][lane][2] (kernels.py::mma_conv_layout);
// shared memory holds them as they come, then the input tile and mid.
template <int C, int TH, int NW>
struct MmaPlan {
  static constexpr int NT = 32 * NW;                   // threads: NW warps
  static constexpr int IH = TH + 4, IW = MMA_TW + 4;  // input tile: the block's 2-pixel halo
  static constexpr int RH = TH + 2, RW = MMA_TW + 2;  // conv1's region
  static constexpr int IP = plane(IH * IW), MP = plane(RH * RW);
  static constexpr int KC = C / 8, NB = C / 8;        // 8-channel k-steps, n-tiles
  static constexpr int M1 = (RH * RW + 15) / 16;      // conv1's m-tiles (16 pixels each)
  static constexpr int MT1 = (M1 + NW - 1) / NW;      // per warp, at most
  static constexpr int MG1 = MT1 < 3 ? MT1 : 3;       // per round of a warp
  static constexpr int MG2 = TH * MMA_TW / 16 / NW;   // conv2's m-tiles per warp
  using G = OFBlock<C, C>;
  static constexpr int W1 = G::G_W1, S1 = G::G_S1, B1 = G::G_B1, W2 = G::G_W2, S2 = G::G_S2,
                       B2 = G::G_B2, WS = G::G_WS, WEND = G::G_END;
  static constexpr int IN = WEND, MID = IN + C * IP, END = MID + C * MP;
  static_assert(C % 8 == 0 && WEND % 4 == 0, "16-byte weight copy, 8-channel k-steps");
  static_assert(TH * MMA_TW % (16 * NW) == 0, "conv2's m-tiles split evenly");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// copies 4 bytes, or writes 0 when src_bytes is 0
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_older() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// v = hi + lo with both parts TF32 (round to nearest, ties away from zero)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(v - __uint_as_float(hi)));
}

// d += a b, m16n8k8, TF32 in, fp32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k-step of 8 channels, 3xTF32, for the warp's first nvalid m-tiles:
// acc[j][nb][0] += A_hi B_hi and acc[j][nb][1] += A_lo B_hi + A_hi B_lo.  The
// tensor cores truncate each sum they accumulate, a bias that grows with the
// number of MMAs into one accumulator and its size; keeping the small terms
// apart cuts the MMAs into the large accumulator to one per k-step.  Thread
// (g, t) = (lane / 4, lane % 4) reads A_j at src[pa[j]] (pixel g, channel t),
// src[pb[j]] (pixel g + 8) and, 4 channels on, at + 4P; pa and pb already hold
// t * P.  bfrag: this k-step's packed B fragments, NB x 32 lanes x 2.
template <int MG, int NB, int P>
__device__ __forceinline__ void mma_kstep(const float* __restrict__ src, const int (&pa)[MG],
                                          const int (&pb)[MG], int nvalid,
                                          const float2* __restrict__ bfrag, int lane,
                                          float (&acc)[MG][NB][2][4]) {
  uint32_t bh[NB][2], bl[NB][2];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const float2 v = bfrag[nb * 32 + lane];
    split_tf32(v.x, bh[nb][0], bl[nb][0]);
    split_tf32(v.y, bh[nb][1], bl[nb][1]);
  }
#pragma unroll
  for (int j = 0; j < MG; ++j) {
    if (j < nvalid) {
      uint32_t ah[4], al[4];
      split_tf32(src[pa[j]], ah[0], al[0]);
      split_tf32(src[pb[j]], ah[1], al[1]);
      split_tf32(src[pa[j] + 4 * P], ah[2], al[2]);
      split_tf32(src[pb[j] + 4 * P], ah[3], al[3]);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        mma_tf32(acc[j][nb][1], al, bh[nb][0], bh[nb][1]);
        mma_tf32(acc[j][nb][1], ah, bl[nb][0], bl[nb][1]);
        mma_tf32(acc[j][nb][0], ah, bh[nb][0], bh[nb][1]);
      }
    }
  }
}

// acc += the (1,3,3) conv of src ([CIN][.] planes P floats apart, rows SW
// wide) at the warp's m-tiles; w: the conv's packed fragments
template <int CIN, int MG, int NB, int P, int SW>
__device__ __forceinline__ void conv3x3_mma(const float* __restrict__ src, const int (&pa)[MG],
                                            const int (&pb)[MG], int nvalid,
                                            const float* __restrict__ w, int lane,
                                            float (&acc)[MG][NB][2][4]) {
  const float2* frag = reinterpret_cast<const float2*>(w);
#pragma unroll 1
  for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
      for (int kc = 0; kc < CIN / 8; ++kc) {
        const int ks = (ky * 3 + kx) * (CIN / 8) + kc;
        mma_kstep<MG, NB, P>(src + kc * 8 * P + ky * SW + kx, pa, pb, nvalid,
                             frag + ks * NB * 32, lane, acc);
      }
    }
  }
}

// The input tile [CI][IH][IW] (planes P apart) of slice base, (0, 0) at image
// pixel (gh0, gw0), 0 outside the image: fp32 by cp.async, bf16 widened
// through registers.
template <int CI, int IH, int IW, int P, int NT>
__device__ __forceinline__ void stage_tile(const float* __restrict__ x, int64_t base,
                                           int64_t cstride, float* __restrict__ dst, int gh0,
                                           int gw0, int H, int W) {
  for (int i = threadIdx.x; i < CI * IH * IW; i += NT) {
    const int c = i / (IH * IW), r = i % (IH * IW);
    const int gh = gh0 + r / IW, gw = gw0 + r % IW;
    const bool inside = dffx::in_image(gh, gw, H, W);
    const float* src = inside ? x + base + c * cstride + (int64_t)gh * W + gw : x;
    cp_async4(dst + c * P + r, src, inside ? 4 : 0);
  }
}

template <int CI, int IH, int IW, int P, int NT>
__device__ __forceinline__ void stage_tile(const __nv_bfloat16* __restrict__ x, int64_t base,
                                           int64_t cstride, float* __restrict__ dst, int gh0,
                                           int gw0, int H, int W) {
#pragma unroll 4
  for (int i = threadIdx.x; i < CI * IH * IW; i += NT) {
    const int c = i / (IH * IW), r = i % (IH * IW);
    const int gh = gh0 + r / IW, gw = gw0 + r % IW;
    dst[c * P + r] = dffx::in_image(gh, gw, H, W)
                         ? dffx::load(x, base + c * cstride + (int64_t)gh * W + gw)
                         : 0.f;
  }
}

// Persistent: block i takes tiles i, i + gridDim.x, ...; tile index =
// (b * N + n) * tiles_h * tiles_w + ty * tiles_w + tx.
template <typename T, int C, int TH, int NW, int MINB>
__global__ void __launch_bounds__(32 * NW, MINB)
rb_of_mma_kernel(const T* __restrict__ x, const float* __restrict__ params, T* __restrict__ y,
                 int N, int H, int W, int tiles_w, int tiles_h, int ntiles) {
  using P = MmaPlan<C, TH, NW>;
  constexpr int NB = P::NB;
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
    stage_tile<C, P::IH, P::IW, P::IP, P::NT>(x, slice_base(tile), cstride, in_s,
                                       r / tiles_w * TH - 2, r % tiles_w * MMA_TW - 2, H, W);
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
    const int th0 = r / tiles_w * TH, tw0 = r % tiles_w * MMA_TW;
    cp_async_wait_all();
    __syncthreads();  // this tile's input is in (w2 is scaled); mid is free

    // conv1 -> BN1 -> ReLU into mid ([C][RH][RW], planes MP apart), 0 outside
    // the image; the warp's m-tiles are warp + NW i, i < MT1, MG1 per round
    const float* s1 = smem + P::S1;
    const float* b1 = smem + P::B1;
    const int mine = (P::M1 - warp + NW - 1) / NW;
#pragma unroll 1
    for (int i0 = 0; i0 < mine; i0 += P::MG1) {
      int pa[P::MG1], pb[P::MG1];
#pragma unroll
      for (int j = 0; j < P::MG1; ++j) {
        const int p0 = min((warp + (i0 + j) * NW) * 16 + g, P::RH * P::RW - 1);
        const int p1 = min(p0 + 8, P::RH * P::RW - 1);
        pa[j] = t * P::IP + p0 / P::RW * P::IW + p0 % P::RW;
        pb[j] = t * P::IP + p1 / P::RW * P::IW + p1 % P::RW;
      }
      const int nvalid = min(mine - i0, P::MG1);
      float acc[P::MG1][NB][2][4] = {};
      conv3x3_mma<C, P::MG1, NB, P::IP, P::IW>(in_s, pa, pb, nvalid, smem + P::W1, lane, acc);
#pragma unroll
      for (int j = 0; j < P::MG1; ++j) {
        if (j >= nvalid) continue;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int p = (warp + (i0 + j) * NW) * 16 + g + 8 * (k / 2);
            const int co = nb * 8 + 2 * t + k % 2;
            if (p < P::RH * P::RW) {
              const bool inside =
                  dffx::in_image(th0 - 1 + p / P::RW, tw0 - 1 + p % P::RW, H, W);
              const float v = acc[j][nb][0][k] + acc[j][nb][1][k];
              mid[co * P::MP + p] = inside ? fmaxf(fmaf(v, s1[co], b1[co]), 0.f) : 0.f;
            }
          }
        }
      }
    }

    // the shortcut Ws x into conv2's accumulators; the warp's output m-tiles
    // are warp * MG2 + j, 16 pixels of one 32-pixel row each
    float acc[P::MG2][NB][2][4] = {};
    int pa[P::MG2], pb[P::MG2];
#pragma unroll
    for (int j = 0; j < P::MG2; ++j) {
      const int p = (warp * P::MG2 + j) * 16 + g;
      pa[j] = t * P::IP + (p / MMA_TW + 2) * P::IW + p % MMA_TW + 2;
      pb[j] = pa[j] + 8;
    }
    const float2* ws = reinterpret_cast<const float2*>(smem + P::WS);
#pragma unroll
    for (int kc = 0; kc < P::KC; ++kc) {
      mma_kstep<P::MG2, NB, P::IP>(in_s + kc * 8 * P::IP, pa, pb, P::MG2, ws + kc * NB * 32,
                                   lane, acc);
    }
    __syncthreads();  // mid is complete, and no warp reads the input tile again

    if (tile + gridDim.x < ntiles) stage(tile + gridDim.x);
    cp_async_commit();

    // conv2 (BN2's scale in its weights) from mid, + BN2's shift, ReLU
#pragma unroll
    for (int j = 0; j < P::MG2; ++j) {
      const int p = (warp * P::MG2 + j) * 16 + g;
      pa[j] = t * P::MP + p / MMA_TW * P::RW + p % MMA_TW;
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
          const int gh = th0 + p / MMA_TW, gw = tw0 + p % MMA_TW;
          if (gh < H && gw < W) {
            dffx::store(y, obase + co * cstride + (int64_t)gh * W + gw,
                        fmaxf(acc[j][nb][0][k] + acc[j][nb][1][k] + b2[co], 0.f));
          }
        }
      }
    }
  }
}

template <typename T, int C, int TH, int NW, int MINB>
cudaError_t launch_mma(const void* x, const void* params, void* y, int B, int N, int H, int W,
                       cudaStream_t stream) {
  using P = MmaPlan<C, TH, NW>;
  const auto kernel = rb_of_mma_kernel<T, C, TH, NW, MINB>;
  const int bytes = P::END * static_cast<int>(sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, P::NT, bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles_w = (W + MMA_TW - 1) / MMA_TW, tiles_h = (H + TH - 1) / TH;
  const int64_t ntiles = (int64_t)B * N * tiles_w * tiles_h;
  if (ntiles > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(ntiles < (int64_t)sms * per_sm ? ntiles : sms * per_sm);
  kernel<<<grid, P::NT, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(params), static_cast<T*>(y), N, H, W,
      tiles_w, tiles_h, static_cast<int>(ntiles));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int cin, int cout, int nblocks, const void* x, const void* params,
                     void* y, int B, int N, int H, int W, cudaStream_t stream) {
  if (cin == 3 && cout == 8 && nblocks == 2) {
    return launch_pair<T, 3, 8>(x, params, y, B, N, H, W, stream);
  }
  if (cin == 16 && cout == 16 && nblocks == 1) {
    return launch_mma<T, 16, 16, 8, 2>(x, params, y, B, N, H, W, stream);
  }
  if (cin == 32 && cout == 32 && nblocks == 1) {
    return launch_mma<T, 32, 8, 8, 1>(x, params, y, B, N, H, W, stream);
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
