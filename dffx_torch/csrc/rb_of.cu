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
// fp32 and bf16 have a design each.
//
// fp32.  What bounds it on the card: a C -> C block is 19 C^2 FMAs per pixel
// (9.7 kFLOP at C = 16, 38.9 at C = 32) against 8 C bytes of fp32 traffic, 76
// and 152 FLOP/byte, and the pair 2,032 FMAs per pixel against 44 bytes, 92
// FLOP/byte: arithmetic bounds all three levels, not HBM.  On the fp32 FMA
// pipe (67 TFLOP/s) the shared-memory reads that feed the FMAs bound them
// first: the first design read 9 words per 32 FMAs at C = 32 and one word per
// 8 FMAs in the pair, on 32 x 8 tiles with every weight restaged for every
// tile.
//
// What the fp32 design does about it:
// * The convs run on the tensor cores as implicit GEMMs (M = the tile's
//   pixels, N = Cout, K = 9 Cin): mma.sync m16n8k8 with TF32 operands.  Plain
//   TF32 misses the fp32 bound by 25-55x, so each operand is split into two
//   TF32 parts, v = hi + lo (a mask and a subtraction: mma.cuh::split_tf32),
//   and a product is hi.hi + hi.lo + lo.hi (3xTF32): fp32 accuracy at a third
//   of the TF32 rate, still well above the FMA pipe.  The tensor cores
//   truncate each sum they accumulate, so the small terms go to an
//   accumulator of their own (mma.cuh::mma_3xtf32).
// * Persistent grids (blocks per SM from the occupancy API) walk the tiles;
//   each block copies the weights into shared memory once, already in
//   B-fragment order (the wrapper packs them), with 16-byte cp.async, and the
//   next tile's input is in flight while the current tile's later convs run.
//   Channel planes in shared memory are 8 (mod 32) floats apart, so every
//   A-fragment load (8 pixels x 4 channels across the warp) hits 32 distinct
//   banks.
// * A 16 -> 16 or 32 -> 32 block is res_block.cuh with the projection shortcut
//   as k-steps into conv2's accumulators: 32 x 8 tiles at C = 32 (183 KB of
//   shared memory: one block per SM) and 32 x 16 at C = 16 (107 KB: two, 1.2x
//   halo recompute).  A 32 x 12 tile fits at C = 32 and cuts the halo from
//   1.33x to 1.24x, but measured slower on the H100 (0.50 against 0.47 ms at
//   1 x 32 x 10 x 152 x 272): its 30 conv1 m-tiles split unevenly over 8 warps.
// * The 3 -> 8 -> 8 pair is one kernel of four conv stages on a 32 x 16 tile
//   with the chain's 4-pixel halo (1.63x, 1.41x, 1.20x and 1x the tile's
//   pixels; 2.08x, 1.69x, 1.33x on the first design's 32 x 8), 69 KB of shared
//   memory, two 8-warp blocks per SM.  Five of its six products are 8-channel
//   GEMMs, one k-step a tap; block 0's 3 -> 8 conv has K = 27, run as four
//   k-steps of k = 9 cin + tap padded to 32, whose A operands a thread finds
//   through eight offsets it computes once (a padded k reads a real element
//   of the tile against a zero weight).  Block 0's 3 -> 8 shortcut is 24 exact
//   FMAs a pixel in its conv2's epilogue, block 1's one k-step into conv2's
//   accumulators.  A warp takes two m-tiles a round (with four, 1.21 against
//   1.14 ms; three blocks per SM at 80 registers spill: 2.1 ms).
// Measured on the H100 (700 W), kernel alone: the pair 1.06 to 1.07 ms at
// 1 x 3 x 10 x 608 x 1088 (the FMA design in the same run: 1.82-1.84), 96
// TFLOP/s of TF32 MMAs; 0.46 ms at 1 x 16 x 10 x 304 x 544, 0.37 at 1 x 32 x
// 10 x 152 x 272 (with cvt.rna.tf32.f32 for the splits and one m-tile per
// k-step at a time: 0.56 and 0.47).  The instructions around the MMAs and the
// barriers between the stages bound it, not the tensor cores, which bare
// mma.sync drives to 328 TFLOP/s on this card (dffx_torch/bench.py --what mma).
//
// bf16.  What bounds it on the card: the function is 19 C^2 bf16 products a
// pixel at C = 16 and 32 against 4C bytes, and the pair's 2,032 against 22
// bytes: at FlowNetwork's shapes HBM bounds the pair and the 16-channel block
// (0.043 and 0.032 ms), the tensor cores the 32-channel one (0.016 ms at 989
// TFLOP/s).  Done fp32-accurately (bf16 in, fp32 inside, only the output
// rounded: bf16_mma.cuh) a conv of the exact input is x.w_hi + x.w_lo and a
// conv of an fp32 intermediate hi.w_hi + hi.w_lo + lo.w_hi, on m16n8k16; the
// fp32 design on widened bf16 ran two and three TF32 MMAs of half the k
// (1.04 / 0.37 / 0.37 ms for the three levels).
//
// What the bf16 design does about it:
// * The 16- and 32-channel blocks are bf16_res_block.cuh with the projection
//   (rb2d.cu's bf16 block, whose notes give the tile plan): Ws x is one k16
//   step at C = 16 and two at C = 32 of the pixel-major input tile's centre,
//   by ldmatrix, into conv2's accumulators.  Tiles as rb2d's: 32 x 16 at C =
//   16 (111 KB, two blocks an SM), 32 x 8 at C = 32 (185 KB, one).
// * The pair keeps the fp32 design's tile, stages and m-tile rounds (two a
//   warp, as in fp32: with at most three a round 0.751 ms, four 0.816 with
//   172 bytes of spills, against 0.738 with two, in one run).  The
//   raw bf16 tile ([3][24][40], from column tw0 - 4) arrives by 8-byte
//   cp.async while the last tile's stages run; one pass rewrites it as two
//   words a pixel, channels (0, 1) and (2, a zero), rows 42 pixels apart.
// * Block 0's conv1 has K = 27 over three channels, and an m16n8k16 A
//   register holds two consecutive k: k = 4 tap + channel makes a pixel's
//   two words the k pairs of a tap, so K = 36 is two k16 steps and a k8
//   (kernels.py::rb_of_chain_params), whose A words a thread finds through
//   five offsets it computes once; a pair past tap 8 reads tap 8's words
//   against zero weights.  Taps 2t and 2t + 1 of one row are one word apart,
//   and rows 42 = 10 (mod 16) pixels apart keep a k-step whose taps span two
//   rows free of bank conflicts.
// * Block 0's 3 -> 8 shortcut is one k8 step of the same words at the centre
//   (pairs 2 and 3 read them again against zero weights), block 1's 8 -> 8
//   one k8 step of out0's hi and lo planes by ldmatrix, each into conv2's
//   accumulators; BN2's scale is folded into both w2 by the wrapper.
// * The three 8 -> 8 convs follow rb2d's C = 8 plan: four k16 steps and a k8
//   from hi and lo planes of [pixels][8] that each stage writes once (0
//   outside the image), ldmatrix fragments, rows 44, 42 and 40 pixels apart
//   (each = its reader's region rows, mod 8).
// A 32 x 16 tile takes, in m16n8k16 MMAs (a k8 step counted as half), 265
// in block 0's conv1, 652 in its shortcut and conv2, 527 in block 1's conv1,
// 480 in its shortcut and conv2; 128 registers (the bound of two 8-warp
// blocks an SM), no spills, 82 KB of shared memory.  The 16-channel block
// takes 3,260 a 32 x 16 tile and 128 registers, the 32-channel one 6,880 a
// 32 x 8 tile and 181 registers, no spills.
// Measured on an NVIDIA H100 80GB HBM3 (700.00 W), launches back to back
// (dffx_torch/bench.py --what kernels): 0.738 ms at 1 x
// 3 x 10 x 608 x 1088, 0.210 at 1 x 16 x 10 x 304 x 544, 0.178 at 1 x 32 x 10
// x 152 x 272; by those counts 138, 205 and 271 TFLOP/s of bf16 MMAs.
#include "bf16_res_block.cuh"
#include "res_block.cuh"

namespace {

using dffx::conv3x3_mma;
using dffx::cp_async16;
using dffx::cp_async_commit;
using dffx::cp_async_wait_all;
using dffx::cp_async_wait_older;
using dffx::mma_kstep_at;
using dffx::plane;
using dffx::region_mma;
using dffx::region_offsets;

// ---------------------------------------------------------------------------
// The 3 -> 8 -> 8 pair: four convs and two shortcuts on one tile
// ---------------------------------------------------------------------------

constexpr int CIN = 3, C = 8, TW = 32, TH = 16;
constexpr int NW = 8, NT = 32 * NW, MINB = 2;  // warps and threads of a block, blocks per SM
constexpr int MGCAP = 2;                       // m-tiles of a warp in one round, at most
constexpr int K0 = 9 * CIN, K0_STEPS = (K0 + 7) / 8;  // block 0's conv1: K = 27 in 4 k-steps
constexpr int FRAG = 64;                       // floats of one k-step's B fragments (one n-tile)

// conv r of the chain writes region r, (TH + 6 - 2r) x (TW + 6 - 2r), whose
// (0, 0) is image pixel (th0 - 3 + r, tw0 - 3 + r): block 0's conv1 region,
// block 0's output, block 1's conv1 region, the tile
__host__ __device__ constexpr int rh(int r) { return TH + 6 - 2 * r; }
__host__ __device__ constexpr int rw(int r) { return TW + 6 - 2 * r; }
__host__ __device__ constexpr int npos(int r) { return rh(r) * rw(r); }
// m-tiles a warp takes together in conv r
__host__ __device__ constexpr int mg(int r) { return dffx::region_mg(npos(r), NW, MGCAP); }

// Shared-memory plan of the pair.  Parameters as the wrapper packs them
// (kernels.py::rb_of_chain_params): per block w1, s1, b1, w2, s2, b2, ws; block
// 0's w1 as the B fragments of its four k-steps, k = 9 cin + tap padded from 27
// to 32 (pair_conv0_layout), its ws as it is, [cout][cin]; every other conv
// and block 1's ws in mma_conv_layout.  Shared memory holds them as they come,
// then the input tile with the chain's 4-pixel halo, the two conv1 regions
// (they share a buffer) and block 0's output.
struct P {
  static constexpr int IH = TH + 8, IW = TW + 8;
  static constexpr int IP = plane(IH * IW), MP = plane(npos(0)), OP = plane(npos(1));
  static constexpr int W1A = 0, S1A = W1A + K0_STEPS * FRAG, B1A = S1A + C, W2A = B1A + C,
                       S2A = W2A + 9 * FRAG, B2A = S2A + C, WSA = B2A + C;
  static constexpr int W1B = WSA + CIN * C, S1B = W1B + 9 * FRAG, B1B = S1B + C,
                       W2B = B1B + C, S2B = W2B + 9 * FRAG, B2B = S2B + C, WSB = B2B + C,
                       WEND = WSB + FRAG;
  static constexpr int IN = WEND, MID = IN + CIN * IP, OUT = MID + C * MP, END = OUT + C * OP;
  static_assert(WEND % 4 == 0 && IW % 4 == 0 && IP % 4 == 0, "16-byte copies");
  static_assert(plane(npos(2)) <= MP, "block 1's conv1 region fits block 0's");
};

// The k-steps of one 8 -> 8 conv of the chain over region REG, from src (rows
// SW wide, planes SP apart): a body of region_mma.
template <int REG, int SW, int SP>
struct Conv8 {
  static constexpr int MG = mg(REG);
  const float* src;
  const float* w;
  int lane;
  __device__ __forceinline__ void operator()(const int (&p0)[MG], const int (&p1)[MG],
                                             int nvalid, float (&acc)[MG][1][2][4]) const {
    int pa[MG], pb[MG];
    region_offsets<rw(REG), SW>(p0, lane % 4 * SP, pa);
    region_offsets<rw(REG), SW>(p1, lane % 4 * SP, pb);
    conv3x3_mma<C, MG, 1, SP, SW>(src, pa, pb, nvalid, w, lane, acc);
  }
};

// Persistent: block i takes tiles i, i + gridDim.x, ...; tile index =
// (b * N + n) * tiles_h * tiles_w + ty * tiles_w + tx.
// vec: the input tile by 16-byte copies (W % 4 == 0, x 16-byte aligned).
__global__ void __launch_bounds__(NT, MINB)
rb_of_pair_kernel(const float* __restrict__ x, const float* __restrict__ params,
                  float* __restrict__ y, int N, int H, int W, int tiles_w, int tiles_h,
                  int ntiles, bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* in_s = smem + P::IN;
  float* mid = smem + P::MID;
  float* out0 = smem + P::OUT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
  const int64_t hw = (int64_t)H * W;
  const int64_t cstride = (int64_t)N * hw;
  const int per_slice = tiles_w * tiles_h;
  auto stage = [&](int tile) {
    const int bn = tile / per_slice, r = tile % per_slice;
    dffx::stage_tile_any<CIN, P::IH, P::IW, P::IP, NT>(
        x, ((int64_t)(bn / N) * CIN * N + bn % N) * hw, cstride, in_s, r / tiles_w * TH - 4,
        r % tiles_w * TW - 4, H, W, vec);
  };

  // the weights, once per block, then BN2's scale folded into block 1's w2
  // (entry i of its fragments holds output channel i / 8 % 8), so that its
  // shortcut can start conv2's accumulators; the first tile meanwhile
  for (int i = threadIdx.x; i < P::WEND / 4; i += NT) cp_async16(smem + 4 * i, params + 4 * i);
  cp_async_commit();
  stage(blockIdx.x);
  cp_async_commit();
  cp_async_wait_older();
  __syncthreads();
  for (int i = threadIdx.x; i < 9 * FRAG; i += NT) smem[P::W2B + i] *= smem[P::S2B + i / 8 % 8];

  // Block 0's conv1: k value 8 s + t (+ 4) of k-step s is channel k / 9 at tap
  // k % 9; a thread finds its two through offsets it computes once.  A padded
  // k (27..31, zero weights) reads what k = 0 reads: an element of the tile,
  // never a word that nothing wrote.
  int k0[K0_STEPS][2];
#pragma unroll
  for (int s = 0; s < K0_STEPS; ++s) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 8 * s + 4 * h + t < K0 ? 8 * s + 4 * h + t : 0;
      k0[s][h] = k / 9 * P::IP + k % 9 / 3 * P::IW + k % 3;
    }
  }

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int bn = tile / per_slice, r = tile % per_slice;
    const int th0 = r / tiles_w * TH, tw0 = r % tiles_w * TW;
    cp_async_wait_all();
    __syncthreads();  // this tile's input is in (w2 is scaled); mid and out0 are free

    // v into region REG's planes of dst (DP apart), 0 outside the image
    auto into = [&](float* dst, int dp, int rwid, int reg) {
      return [=](int p, int co, float v) {
        const bool inside =
            dffx::in_image(th0 - 3 + reg + p / rwid, tw0 - 3 + reg + p % rwid, H, W);
        dst[co * dp + p] = inside ? v : 0.f;
      };
    };

    // block 0's conv1 (3 -> 8, four k-steps) -> BN1 -> ReLU into mid
    {
      constexpr int MG = mg(0);
      const float2* frag = reinterpret_cast<const float2*>(smem + P::W1A);
      const float* s1 = smem + P::S1A;
      const float* b1 = smem + P::B1A;
      const auto put = into(mid, P::MP, rw(0), 0);
      region_mma<NW, MG, 1, npos(0)>(
          warp, lane,
          [&](const int(&p0)[MG], const int(&p1)[MG], int nvalid, float(&acc)[MG][1][2][4]) {
            int pa[MG], pb[MG];
            region_offsets<rw(0), P::IW>(p0, 0, pa);
            region_offsets<rw(0), P::IW>(p1, 0, pb);
#pragma unroll
            for (int s = 0; s < K0_STEPS; ++s) {
              mma_kstep_at<MG, 1>(in_s, pa, pb, k0[s][0], k0[s][1], nvalid, frag + s * 32,
                                  lane, acc);
            }
          },
          [&](int p, int co, float v) { put(p, co, fmaxf(fmaf(v, s1[co], b1[co]), 0.f)); });
    }
    __syncthreads();

    // block 0's conv2 -> BN2, + the 3 -> 8 shortcut on the input's centre by
    // FMAs (exact), ReLU, into out0
    {
      const float* s2 = smem + P::S2A;
      const float* b2 = smem + P::B2A;
      const float* ws = smem + P::WSA;
      const auto put = into(out0, P::OP, rw(1), 1);
      region_mma<NW, mg(1), 1, npos(1)>(
          warp, lane, Conv8<1, rw(0), P::MP>{mid, smem + P::W2A, lane},
          [&](int p, int co, float v) {
            const float* xc = in_s + (p / rw(1) + 2) * P::IW + p % rw(1) + 2;
            v = fmaf(v, s2[co], b2[co]);
#pragma unroll
            for (int ci = 0; ci < CIN; ++ci) v = fmaf(ws[co * CIN + ci], xc[ci * P::IP], v);
            put(p, co, fmaxf(v, 0.f));
          });
    }
    __syncthreads();  // out0 is complete, and no warp reads the input tile again

    if (tile + gridDim.x < ntiles) stage(tile + gridDim.x);
    cp_async_commit();

    // block 1's conv1 -> BN1 -> ReLU into mid (rows rw(2) wide)
    {
      const float* s1 = smem + P::S1B;
      const float* b1 = smem + P::B1B;
      const auto put = into(mid, P::MP, rw(2), 2);
      region_mma<NW, mg(2), 1, npos(2)>(
          warp, lane, Conv8<2, rw(1), P::OP>{out0, smem + P::W1B, lane},
          [&](int p, int co, float v) { put(p, co, fmaxf(fmaf(v, s1[co], b1[co]), 0.f)); });
    }
    __syncthreads();

    // block 1's 8 -> 8 shortcut on out0's centre (one k-step) and conv2 (BN2's
    // scale in its weights), + BN2's shift, ReLU, for the tile's own pixels
    {
      constexpr int MG = mg(3);
      const float* b2 = smem + P::B2B;
      const float2* ws = reinterpret_cast<const float2*>(smem + P::WSB);
      const int64_t obase = ((int64_t)(bn / N) * C * N + bn % N) * hw;
      const Conv8<3, rw(2), P::MP> conv2{mid, smem + P::W2B, lane};
      region_mma<NW, MG, 1, TH * TW>(
          warp, lane,
          [&](const int(&p0)[MG], const int(&p1)[MG], int nvalid, float(&acc)[MG][1][2][4]) {
            int pa[MG], pb[MG];
            region_offsets<TW, rw(1)>(p0, t * P::OP + 2 * rw(1) + 2, pa);
            region_offsets<TW, rw(1)>(p1, t * P::OP + 2 * rw(1) + 2, pb);
            mma_kstep_at<MG, 1>(out0, pa, pb, 0, 4 * P::OP, nvalid, ws, lane, acc);
            conv2(p0, p1, nvalid, acc);
          },
          [&](int p, int co, float v) {
            const int gh = th0 + p / TW, gw = tw0 + p % TW;
            if (gh < H && gw < W) {
              dffx::store(y, obase + co * cstride + (int64_t)gh * W + gw,
                          fmaxf(v + b2[co], 0.f));
            }
          });
    }
  }
  cp_async_wait_all();
}

cudaError_t launch_pair(const void* x, const void* params, void* y, int B, int N, int H, int W,
                        cudaStream_t stream) {
  const auto kernel = rb_of_pair_kernel;
  const int bytes = P::END * static_cast<int>(sizeof(float));
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const int64_t ntiles = (int64_t)B * N * tiles_w * tiles_h;
  int grid = 0;
  const cudaError_t err = dffx::persistent_grid(kernel, NT, bytes, ntiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(params), static_cast<float*>(y),
      N, H, W, tiles_w, tiles_h, static_cast<int>(ntiles), dffx::vec_ok(x, W));
  return cudaGetLastError();
}

// the pair, or one C -> C block: res_block.cuh with the projection shortcut and
// the block's 2-pixel halo, <T, C, tile height, warps, blocks per SM, true, 2>
cudaError_t dispatch_fp32(int cin, int cout, int nblocks, const void* x, const void* params,
                          void* y, int B, int N, int H, int W, cudaStream_t stream) {
  using dffx::launch_res_block;
  if (cin == 3 && cout == 8 && nblocks == 2) {
    return launch_pair(x, params, y, B, N, H, W, stream);
  }
  if (cin == 16 && cout == 16 && nblocks == 1) {
    return launch_res_block<16, 16, 8, 2, true, 2>(x, params, y, B, N, H, W, stream);
  }
  if (cin == 32 && cout == 32 && nblocks == 1) {
    return launch_res_block<32, 8, 8, 1, true, 2>(x, params, y, B, N, H, W, stream);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bf16: the pair
// ---------------------------------------------------------------------------

// Shared-memory plan of the bf16 pair.  Parameters as the wrapper packs them
// (kernels.py::rb_of_chain_params of a bf16 x), per block w1, s1, b1, w2 with
// BN2's scale folded in, b2, ws, each conv and shortcut as _bf16_fragments:
// block 0's w1 in conv0's K order (k = 4 tap + channel, channel 3 a zero: two
// k16 steps and a k8), its ws as one k8 step (k = channel), the 8 -> 8 convs
// as four k16 steps and a k8 (k = 8 tap + channel), block 1's ws as one k8
// step.  Shared memory holds them as they come, then the raw input tile
// [3][IH][IW], the input tile as two words a pixel, (c0, c1) and (c2, 0), the
// conv1 regions (they share a buffer) and block 0's output as hi and lo planes
// of [pixels][8].  Rows are XS, S0, S1 and S2 pixels apart: each = its
// reader's region rows (mod 8), so that the eight rows of an ldmatrix lie in
// eight bank groups; XS = 10 (mod 16), so that conv0's word loads, whose two
// taps a k-step may take from two rows, do too.
struct PB {
  static constexpr int IH = TH + 8, IW = TW + 8;
  static constexpr int XS = 42, S0 = 44, S1 = 42, S2 = 40;
  static constexpr int K0S = 3, F8 = 5 * 128;  // k-steps of conv0; words of an 8 -> 8 conv
  static constexpr int W1A = 0, S1A = W1A + K0S * 128, B1A = S1A + C, W2A = B1A + C,
                       B2A = W2A + F8, WSA = B2A + C;
  static constexpr int W1B = WSA + 128, S1B = W1B + F8, B1B = S1B + C, W2B = B1B + C,
                       B2B = W2B + F8, WSB = B2B + C, WEND = WSB + 128;
  static constexpr int MIDW = 4 * (rh(0) * S0 > rh(2) * S2 ? rh(0) * S0 : rh(2) * S2);
  static constexpr int OUTW = 4 * rh(1) * S1;
  static constexpr int RAW = WEND, XIN = RAW + CIN * IH * IW / 2, MIDH = XIN + 2 * IH * XS,
                       MIDL = MIDH + MIDW, OUTH = MIDL + MIDW, OUTL = OUTH + OUTW,
                       END = OUTL + OUTW;
  static_assert(S0 % 8 == rw(1) % 8 && S1 % 8 == rw(2) % 8 && S2 % 8 == rw(3) % 8 &&
                    XS % 16 == 10,
                "conflict-free rows");
  static_assert(XS >= IW && S0 >= rw(0) && S1 >= rw(1) && S2 >= rw(2), "rows fit");
  static_assert(WEND % 4 == 0 && XIN % 4 == 0 && MIDH % 4 == 0 && OUTH % 4 == 0,
                "16-byte copies and ldmatrix rows");
};

// Persistent: block i takes tiles i, i + gridDim.x, ...; tile index =
// (b * N + n) * tiles_h * tiles_w + ty * tiles_w + tx.  vec: the raw tile by
// 8-byte cp.async (W % 4 == 0, x 8-byte aligned).
__global__ void __launch_bounds__(NT, MINB)
rb_of_pair_bf16_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ params,
                       __nv_bfloat16* __restrict__ y, int N, int H, int W, int tiles_w,
                       int tiles_h, int ntiles, bool vec) {
  using dffx::conv3x3_hilo;
  using dffx::conv_b;
  using dffx::region_mma_bf16;
  using dffx::store_hilo;
  extern __shared__ __align__(16) float smem[];
  __nv_bfloat16* raw = reinterpret_cast<__nv_bfloat16*>(smem + PB::RAW);
  uint32_t* xin = reinterpret_cast<uint32_t*>(smem + PB::XIN);
  uint32_t* midh = reinterpret_cast<uint32_t*>(smem + PB::MIDH);
  uint32_t* midl = reinterpret_cast<uint32_t*>(smem + PB::MIDL);
  uint32_t* outh = reinterpret_cast<uint32_t*>(smem + PB::OUTH);
  uint32_t* outl = reinterpret_cast<uint32_t*>(smem + PB::OUTL);
  const uint32_t midh_at = dffx::smem_addr(midh), midl_at = dffx::smem_addr(midl);
  const uint32_t outh_at = dffx::smem_addr(outh), outl_at = dffx::smem_addr(outl);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int64_t hw = (int64_t)H * W;
  const int64_t cstride = (int64_t)N * hw;
  const int per_slice = tiles_w * tiles_h;
  auto stage = [&](int tile) {
    const int bn = tile / per_slice, r = tile % per_slice;
    dffx::stage_bf16<CIN, PB::IH, PB::IW, NT, 4>(
        x, ((int64_t)(bn / N) * CIN * N + bn % N) * hw, cstride, raw, r / tiles_w * TH - 4,
        r % tiles_w * TW - 4, H, W, vec);
  };

  for (int i = threadIdx.x; i < PB::WEND / 4; i += NT) cp_async16(smem + 4 * i, params + 4 * i);
  stage(blockIdx.x);
  cp_async_commit();

  // Block 0's conv1 reads pair q = 2 tap + word of a pixel's two words: thread
  // t takes pair 8 s + t (a0, a1) and 8 s + 4 + t (a2, a3) of k16 step s, pair
  // 16 + t of the k8 step, as word k0[2 s (+ 1)] from its pixel's first word.
  // A pair past tap 8 (zero weights) reads tap 8's words: an element of the
  // tile, never a word that nothing wrote.
  int k0[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int q = 4 * i + t, tap = min(q / 2, 8);
    k0[i] = 2 * (tap / 3 * PB::XS + tap % 3) + q % 2;
  }

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int bn = tile / per_slice, r = tile % per_slice;
    const int th0 = r / tiles_w * TH, tw0 = r % tiles_w * TW;
    cp_async_wait_all();
    __syncthreads();  // the raw tile is in; no warp reads the input words or the regions

    // the raw tile as two words a pixel
    {
      constexpr int PIX = PB::IH * PB::IW;
      const unsigned short* r16 = reinterpret_cast<const unsigned short*>(raw);
      for (int i = threadIdx.x; i < PIX; i += NT) {
        reinterpret_cast<uint2*>(xin)[i / PB::IW * PB::XS + i % PB::IW] =
            make_uint2(r16[i] | static_cast<uint32_t>(r16[PIX + i]) << 16, r16[2 * PIX + i]);
      }
    }
    __syncthreads();  // the input words are complete, and the raw buffer is free
    if (tile + gridDim.x < ntiles) stage(tile + gridDim.x);
    cp_async_commit();

    // whether position p of region reg (rows rwid wide) lies in the image:
    // region reg's (0, 0) is image pixel (th0 - 3 + reg, tw0 - 3 + reg)
    auto inside = [&](int reg, int rwid, int p) {
      return dffx::in_image(th0 - 3 + reg + p / rwid, tw0 - 3 + reg + p % rwid, H, W);
    };

    // block 0's conv1 (3 -> 8): x.w_hi + x.w_lo -> BN1 -> ReLU into mid
    // (region 0, rows S0); position (ry, rx) reads the input from (ry, rx)
    {
      constexpr int MG = mg(0), NPOS = npos(0);
      const float* s1 = smem + PB::S1A;
      const float* b1 = smem + PB::B1A;
      region_mma_bf16<NW, MG, 1, NPOS>(
          warp, lane,
          [&](const int(&m0)[MG], int nvalid, float(&acc)[MG][1][4]) {
            int pa[MG], pb[MG];  // pixels g and g + 8: their first words at tap (0, 0)
#pragma unroll
            for (int j = 0; j < MG; ++j) {
              const int p = min(m0[j] + g, NPOS - 1), q = min(m0[j] + g + 8, NPOS - 1);
              pa[j] = 2 * (p / rw(0) * PB::XS + p % rw(0));
              pb[j] = 2 * (q / rw(0) * PB::XS + q % rw(0));
            }
#pragma unroll
            for (int s = 0; s < PB::K0S; ++s) {
              const bool k8 = s == PB::K0S - 1;
              uint4 b[1];
              conv_b<1>(smem + PB::W1A, s, lane, b);
              uint32_t a[MG][4];
#pragma unroll
              for (int j = 0; j < MG; ++j) {
                if (j >= nvalid) continue;
                a[j][0] = xin[pa[j] + k0[2 * s]];
                a[j][1] = xin[pb[j] + k0[2 * s]];
                if (!k8) {
                  a[j][2] = xin[pa[j] + k0[2 * s + 1]];
                  a[j][3] = xin[pb[j] + k0[2 * s + 1]];
                }
              }
              dffx::mma_bf16_split_b(a, b, nvalid, k8, acc);
            }
          },
          [&](int p, int co, float v0, float v1) {
            const bool in = inside(0, rw(0), p);
            v0 = in ? fmaxf(fmaf(v0, s1[co], b1[co]), 0.f) : 0.f;
            v1 = in ? fmaxf(fmaf(v1, s1[co + 1], b1[co + 1]), 0.f) : 0.f;
            store_hilo<C>(midh, midl, p / rw(0) * PB::S0 + p % rw(0), co, v0, v1);
          });
    }
    __syncthreads();

    // block 0's 3 -> 8 shortcut on the input's centre (one k8 step: pairs 0
    // and 1 are a pixel's two words, 2 and 3 meet zero weights and read them
    // again), then conv2 (BN2's scale in its weights) from mid, + BN2's shift,
    // ReLU, into out0 (region 1, rows S1)
    {
      constexpr int MG = mg(1), NPOS = npos(1);
      const float* b2 = smem + PB::B2A;
      region_mma_bf16<NW, MG, 1, NPOS>(
          warp, lane,
          [&](const int(&m0)[MG], int nvalid, float(&acc)[MG][1][4]) {
            uint4 b[1];
            conv_b<1>(smem + PB::WSA, 0, lane, b);
            uint32_t a[MG][4];
            int pix[MG];
#pragma unroll
            for (int j = 0; j < MG; ++j) {
              const int p = min(m0[j] + g, NPOS - 1), q = min(m0[j] + g + 8, NPOS - 1);
              a[j][0] = xin[2 * ((p / rw(1) + 2) * PB::XS + p % rw(1) + 2) + t % 2];
              a[j][1] = xin[2 * ((q / rw(1) + 2) * PB::XS + q % rw(1) + 2) + t % 2];
              const int o = min(m0[j] + lane % 16, NPOS - 1);
              pix[j] = o / rw(1) * PB::S0 + o % rw(1);
            }
            dffx::mma_bf16_split_b(a, b, nvalid, true, acc);
            conv3x3_hilo<C, PB::S0>(midh_at, midl_at, pix, nvalid, smem + PB::W2A, lane, acc);
          },
          [&](int p, int co, float v0, float v1) {
            const bool in = inside(1, rw(1), p);
            v0 = in ? fmaxf(v0 + b2[co], 0.f) : 0.f;
            v1 = in ? fmaxf(v1 + b2[co + 1], 0.f) : 0.f;
            store_hilo<C>(outh, outl, p / rw(1) * PB::S1 + p % rw(1), co, v0, v1);
          });
    }
    __syncthreads();  // out0 is complete, and no warp reads the input words again

    // block 1's conv1 from out0 -> BN1 -> ReLU into mid (region 2, rows S2)
    {
      constexpr int MG = mg(2), NPOS = npos(2);
      const float* s1 = smem + PB::S1B;
      const float* b1 = smem + PB::B1B;
      region_mma_bf16<NW, MG, 1, NPOS>(
          warp, lane,
          [&](const int(&m0)[MG], int nvalid, float(&acc)[MG][1][4]) {
            int pix[MG];
#pragma unroll
            for (int j = 0; j < MG; ++j) {
              const int o = min(m0[j] + lane % 16, NPOS - 1);
              pix[j] = o / rw(2) * PB::S1 + o % rw(2);
            }
            conv3x3_hilo<C, PB::S1>(outh_at, outl_at, pix, nvalid, smem + PB::W1B, lane, acc);
          },
          [&](int p, int co, float v0, float v1) {
            const bool in = inside(2, rw(2), p);
            v0 = in ? fmaxf(fmaf(v0, s1[co], b1[co]), 0.f) : 0.f;
            v1 = in ? fmaxf(fmaf(v1, s1[co + 1], b1[co + 1]), 0.f) : 0.f;
            store_hilo<C>(midh, midl, p / rw(2) * PB::S2 + p % rw(2), co, v0, v1);
          });
    }
    __syncthreads();

    // block 1's 8 -> 8 shortcut on out0's centre (one k8 step, hi.ws_hi +
    // hi.ws_lo + lo.ws_hi) and conv2 (BN2's scale in its weights) from mid,
    // + BN2's shift, ReLU, for the tile's own pixels
    {
      constexpr int MG = mg(3), NPOS = TH * TW;
      const float* b2 = smem + PB::B2B;
      const int64_t obase = ((int64_t)(bn / N) * C * N + bn % N) * hw;
      region_mma_bf16<NW, MG, 1, NPOS>(
          warp, lane,
          [&](const int(&m0)[MG], int nvalid, float(&acc)[MG][1][4]) {
            uint4 b[1];
            conv_b<1>(smem + PB::WSB, 0, lane, b);
            uint32_t ah[MG][4], al[MG][4];
            int pix[MG];
#pragma unroll
            for (int j = 0; j < MG; ++j) {
              const int o = m0[j] + lane % 16;
              const uint32_t at = 16u * ((o / TW + 2) * PB::S1 + o % TW + 2);
              if (j < nvalid) {
                dffx::ldmatrix_x2(ah[j][0], ah[j][1], outh_at + at);
                dffx::ldmatrix_x2(al[j][0], al[j][1], outl_at + at);
              }
              pix[j] = o / TW * PB::S2 + o % TW;
            }
            dffx::mma_bf16_split_b(ah, b, nvalid, true, acc);
            dffx::mma_bf16_part<0>(al, b, nvalid, true, acc);
            conv3x3_hilo<C, PB::S2>(midh_at, midl_at, pix, nvalid, smem + PB::W2B, lane, acc);
          },
          [&](int p, int co, float v0, float v1) {
            const int gh = th0 + p / TW, gw = tw0 + p % TW;
            if (gh < H && gw < W) {
              const int64_t o = obase + co * cstride + (int64_t)gh * W + gw;
              dffx::store(y, o, fmaxf(v0 + b2[co], 0.f));
              dffx::store(y, o + cstride, fmaxf(v1 + b2[co + 1], 0.f));
            }
          });
    }
  }
  cp_async_wait_all();
}

cudaError_t launch_pair_bf16(const void* x, const void* params, void* y, int B, int N, int H,
                             int W, cudaStream_t stream) {
  const auto kernel = rb_of_pair_bf16_kernel;
  const int bytes = PB::END * static_cast<int>(sizeof(float));
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const int64_t ntiles = (int64_t)B * N * tiles_w * tiles_h;
  int grid = 0;
  const cudaError_t err = dffx::persistent_grid(kernel, NT, bytes, ntiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(params),
      static_cast<__nv_bfloat16*>(y), N, H, W, tiles_w, tiles_h, static_cast<int>(ntiles),
      dffx::vec_ok_bf16(x, W, 4));
  return cudaGetLastError();
}

// the pair, or one C -> C block: bf16_res_block.cuh with the projection
// shortcut, <C, tile height, warps, blocks per SM, true>
cudaError_t dispatch_bf16(int cin, int cout, int nblocks, const void* x, const void* params,
                          void* y, int B, int N, int H, int W, cudaStream_t stream) {
  using dffx::launch_bf16_res_block;
  if (cin == 3 && cout == 8 && nblocks == 2) {
    return launch_pair_bf16(x, params, y, B, N, H, W, stream);
  }
  if (cin == 16 && cout == 16 && nblocks == 1) {
    return launch_bf16_res_block<16, 16, 8, 2, true>(x, params, y, B, N, H, W, stream);
  }
  if (cin == 32 && cout == 32 && nblocks == 1) {
    return launch_bf16_res_block<32, 8, 8, 1, true>(x, params, y, B, N, H, W, stream);
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
    return dispatch_fp32(Cin, Cout, nblocks, x, params, y, B, N, H, W, s);
  }
  if (dtype == DFFX_DTYPE_BF16) {
    return dispatch_bf16(Cin, Cout, nblocks, x, params, y, B, N, H, W, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
