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
// fp32 and bf16 have a design each.
//
// fp32.  What bounds it on the card: 9 x (18 x 16 + 2 x 16 x 16 + 16 x 3) =
// 7,632 FMAs per pixel (15.3 kFLOP) against 84 bytes of fp32 traffic, about 180
// FLOP/byte, so arithmetic bounds it, not HBM: 1.5 ms on the fp32 FMA pipe
// (67 TFLOP/s) at 1 x 18 x 10 x 608 x 1088, 0.61 ms on the tensor cores in
// 3xTF32 (a third of 495 TFLOP/s).  The first design ran on the FMA pipe and
// was bound by the shared-memory loads that fed it (5 loads per 16 FMAs), with
// one 8-warp block per SM and all 30 KB of weights restaged for every tile.
//
// What the fp32 design does about it:
// * The four convs are implicit GEMMs on the tensor cores (mma.cuh): M = the
//   region's pixels in m-tiles of 16, N = 16 output channels (conv3: its 3
//   padded to one n-tile of 8), K = 9 taps x 16 channels in 18 k-steps, 3xTF32.
//   conv0's channels 16 and 17 would fill a quarter of a k-step per tap;
//   instead their 2 x 9 values form 3 k-steps of their own (18 of 24 k values
//   used, the rest meet zero weights), whose A operands a thread finds
//   through six offsets it computes once: 21 k-steps instead of 27.
// * A k-step takes two m-tiles of the warp together: one load and split of
//   the B fragments serves both, and the MMAs are launched term by term (lo.hi
//   of every tile, then hi.hi, then hi.lo), so no MMA waits for the one
//   before it.  A value is split with a mask and a subtraction
//   (split_tf32): with cvt.rna.tf32.f32 the conversions, not the MMAs,
//   set the pace.
// * A persistent grid (one 16-warp block per SM: 200 KB of shared memory)
//   walks the 32 x 16 tiles.  A block copies the weights once, already in
//   B-fragment order (kernels.py::motion_head_params), with 16-byte cp.async.
//   The input tile with the chain's 4-pixel halo arrives by cp.async (16 bytes
//   at a time when W is a multiple of 4, zero-filled outside the image), and
//   the next tile's is in flight from the end of conv0 on, while conv1..conv3
//   run.
// * BN and ReLU are applied to the accumulators in registers; the result goes
//   to shared memory as the next conv's A operand, in two buffers that take
//   turns (conv0 -> A, conv1 -> B, conv2 -> A), channel planes at a stride of
//   8 (mod 32) floats.  Every intermediate is 0 outside the image, as the next
//   conv's zero padding requires: relu(BN(0)) is not 0 wherever a BN shift is
//   positive (the TPU kernel masks the same positions with store_masked).
// The chain recomputes its halo: 1.31x the pixels of the four convs at the
// 32 x 16 tile.  Measured on the H100 (700 W) at 1 x 18 x 10 x 608 x 1088: 3.45
// ms (the FMA design: 7.6; 3.6 to 3.8 while a full round of m-tiles took its
// count at run time), about 134 TFLOP/s of TF32 MMAs, against 328 TFLOP/s
// that bare mma.sync m16n8k8 reaches there (dffx_torch/bench.py --what mma).
// Variants that lost there, kernel only: 8 warps with 4 m-tiles a round
// (4.6 ms), a 32 x 8 tile (5.8 ms), and on that tile the intermediates written
// as their two TF32 parts, which takes the split out of conv1..conv3's loops
// (5.2 ms; the planes do not fit at 32 x 16).
//
// bf16.  What bounds it on the card: 7,632 bf16 products a pixel (0.102 ms at
// 989 TFLOP/s at 1 x 18 x 10 x 608 x 1088) against 42 bytes (0.083 ms), so the
// tensor cores bound it.  Done fp32-accurately (bf16 in, fp32 inside, only the
// output rounded: bf16_mma.cuh) conv0 is x.w_hi + x.w_lo and conv1..conv3,
// whose inputs are fp32 intermediates, hi.w_hi + hi.w_lo + lo.w_hi, on
// m16n8k16; the fp32 design on widened bf16 ran two and three TF32 MMAs of
// half the k (3.22-3.34 ms).
//
// What the bf16 design does about it:
// * The raw bf16 tile ([18][24][40], from column tw0 - 4) arrives by 8-byte
//   cp.async while the last tile's convs run; one pass transposes it, a
//   thread a pixel and 8-channel chunk (channels 0..15 as two swizzled
//   16-byte chunks, bf16_mma.cuh::chunk_at) or a pixel's word of channels 16
//   and 17, and the raw buffer takes the next tile's copy at once.
// * conv0's K order: channels 0..15 of a tap are one k16 step (nine, A by
//   ldmatrix); channels 16 and 17 of tap q are k pair q of a k16 and a k8
//   step, A words a thread finds through three offsets it computes once
//   (kernels.py::motion_head_params); a pair past tap 8 reads tap 8's word
//   against zero weights.  11 k-steps where 3 x 9 would take 18 at k16.
// * conv0 -> BN0 -> ReLU, conv1 and conv2 write their fp32 results once as
//   bf16 hi and lo planes of [pixels][16] (0 outside the image), which the
//   next conv reads by ldmatrix: regions 0 and 2 in buffer A, region 1 in
//   buffer B, whose space holds the transposed input tile until conv1 writes
//   there.  Rows are 46, 44, 42 and 40 pixels apart (each = its reader's
//   region rows, mod 8, so the eight rows of an ldmatrix lie in eight bank
//   groups; 46 = 14 (mod 32) keeps the tail's word loads, whose taps span
//   three rows, conflict-free too).
// * conv3 is one n-tile (3 of 8 output channels real) + bias3; the same
//   persistent grid of one 16-warp block an SM over 32 x 16 tiles.
// The hi/lo planes take 54-62 KB a region, so a 32 x 16 tile fills 185 KB of
// shared memory: neither a second block an SM nor a larger tile fits.  A tile
// takes 7,626 m16n8k16 MMAs (a k8 step counted as half): conv0 2,226, conv1
// 2,430, conv2 2,106, conv3 864; 118 registers, no spills.  Variants that
// lost, each in one run with the kept design (dffx_torch/bench.py --what
// kernels on trees that differ in one constant): four m-tiles a round (2.075
// ms, 268 bytes of spills at the 128 registers of 16 warps), 8 warps with two
// or four m-tiles a round (2.056, 2.016; 124 and 192 registers) against 1.864.
// Measured on an NVIDIA H100 80GB HBM3 (700.00 W), launches back to back
// (dffx_torch/bench.py --what kernels): 1.864 ms at 1 x
// 18 x 10 x 608 x 1088, by those counts 216 TFLOP/s of bf16 MMAs.
#include "bf16_mma.cuh"

namespace {

using dffx::cp_async16;
using dffx::cp_async_commit;
using dffx::cp_async_wait_all;
using dffx::plane;

constexpr int CIN = 18, C = 16, CO = 3, TW = 32, TH = 16;
constexpr int NW = 16, NT = 32 * NW;      // warps and threads of a block
constexpr int MGCAP = 2;                  // m-tiles of a warp in one round, at most
constexpr int KC = 2, NB = 2;             // 8-channel k-steps per tap, n-tiles of C
constexpr int TAIL_K = (CIN - C) * 9;     // k values of channels 16 and 17
constexpr int TAIL_STEPS = (TAIL_K + 7) / 8;

// Tile, m-tile and shared-memory plan of the 16 x 32 tile.  Parameters as the
// wrapper packs them: w0 (main k-steps, then the tail's), s0, b0, w1, s1, b1,
// w2, s2, b2, w3, bias3 padded to 4; shared memory holds them as they come,
// then the input tile and the two intermediates.
struct P {
  static constexpr int IH = TH + 8, IW = TW + 8;
  // conv r of the chain writes region r, (TH + 6 - 2r) x (TW + 6 - 2r); region
  // 3 is the tile
  __host__ __device__ static constexpr int rh(int r) { return TH + 6 - 2 * r; }
  __host__ __device__ static constexpr int rw(int r) { return TW + 6 - 2 * r; }
  // m-tiles a warp takes together in conv r: its share, in rounds of equal size
  __host__ __device__ static constexpr int mg(int r) {
    return dffx::region_mg(rh(r) * rw(r), NW, MGCAP);
  }
  static constexpr int IP = plane(IH * IW), AP = plane((TH + 6) * (TW + 6)),
                       BP = plane((TH + 4) * (TW + 4)), A2P = plane((TH + 2) * (TW + 2));
  static constexpr int W0 = 0, S0 = W0 + (9 * KC + TAIL_STEPS) * NB * 64, B0 = S0 + C,
                       W1 = B0 + C, S1 = W1 + 9 * KC * NB * 64, B1 = S1 + C, W2 = B1 + C,
                       S2 = W2 + 9 * KC * NB * 64, B2 = S2 + C, W3 = B2 + C,
                       BIAS = W3 + 9 * KC * 64, WEND = BIAS + 4;
  static constexpr int IN = WEND, A = IN + CIN * IP, B = A + C * AP, END = B + C * BP;
  static_assert(WEND % 4 == 0, "16-byte weight copy");
  static_assert(A2P <= AP, "conv2's output fits conv0's buffer");
};

// One conv of the chain for the whole block: output position p = ry * RW + rx
// of an RH x RW region reads src (rows SW wide, planes SP apart) at rows ry ..
// ry + 2 and columns rx .. rx + 2.  KC 8-channel k-steps per tap and, with
// TAIL, the three k-steps of channels 16 and 17.  The warp's m-tiles and
// epi(p, co, sum) are mma.cuh::region_mma's, MG m-tiles per round.
template <bool TAIL, int NBO, int MG, int RH, int RW, int SW, int SP, typename Epi>
__device__ __forceinline__ void conv_stage(const float* __restrict__ src,
                                           const float* __restrict__ w, int warp, int lane,
                                           Epi epi) {
  const int t = lane % 4;
  const float2* frag = reinterpret_cast<const float2*>(w);
  // the tail's k value 8 s + t (+ 4) is channel 16 + k / 9 at tap k % 9; the
  // offsets are relative to the thread's own plane t, which pa and pb hold
  int tail[TAIL ? TAIL_STEPS : 1][2] = {};
  if constexpr (TAIL) {
#pragma unroll
    for (int s = 0; s < TAIL_STEPS; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 8 * s + 4 * h + t;
        tail[s][h] = (k < TAIL_K ? (C + k / 9) * SP + k % 9 / 3 * SW + k % 3 : 0) - t * SP;
      }
    }
  }
  dffx::region_mma<NW, MG, NBO, RH * RW>(
      warp, lane,
      [&](const int(&p0)[MG], const int(&p1)[MG], int nvalid, float(&acc)[MG][NBO][2][4]) {
        int pa[MG], pb[MG];
        dffx::region_offsets<RW, SW>(p0, t * SP, pa);
        dffx::region_offsets<RW, SW>(p1, t * SP, pb);
        dffx::conv3x3_mma<C, MG, NBO, SP, SW>(src, pa, pb, nvalid, w, lane, acc);
        if constexpr (TAIL) {
#pragma unroll
          for (int s = 0; s < TAIL_STEPS; ++s) {
            dffx::mma_kstep_at<MG, NBO>(src, pa, pb, tail[s][0], tail[s][1], nvalid,
                                        frag + (9 * KC + s) * NBO * 32, lane, acc);
          }
        }
      },
      epi);
}

// Persistent: block i takes tiles i, i + gridDim.x, ...; tile index =
// (b * N + n) * tiles_h * tiles_w + ty * tiles_w + tx.
// vec: the input tile by 16-byte copies (W % 4 == 0, x 16-byte aligned).
__global__ void __launch_bounds__(NT, 1)
motion_head_kernel(const float* __restrict__ x, const float* __restrict__ params,
                   float* __restrict__ y, int N, int H, int W, int tiles_w, int tiles_h,
                   int ntiles, bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* in_s = smem + P::IN;
  float* ya = smem + P::A;
  float* yb = smem + P::B;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t hw = (int64_t)H * W;
  const int64_t cstride = (int64_t)N * hw;
  const int per_slice = tiles_w * tiles_h;
  auto stage = [&](int tile) {
    const int bn = tile / per_slice, r = tile % per_slice;
    dffx::stage_tile_any<CIN, P::IH, P::IW, P::IP, NT>(
        x, ((int64_t)(bn / N) * CIN * N + bn % N) * hw, cstride, in_s, r / tiles_w * TH - 4,
        r % tiles_w * TW - 4, H, W, vec);
  };

  for (int i = threadIdx.x; i < P::WEND / 4; i += NT) cp_async16(smem + 4 * i, params + 4 * i);
  stage(blockIdx.x);
  cp_async_commit();

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int bn = tile / per_slice, r = tile % per_slice;
    const int th0 = r / tiles_w * TH, tw0 = r % tiles_w * TW;
    cp_async_wait_all();
    __syncthreads();  // the weights and this tile's input are in; ya and yb are free

    // relu(BN(.)) into dst as region R's planes, 0 outside the image; region
    // R's (0, 0) is image pixel (th0 - 3 + R, tw0 - 3 + R)
    auto bn_relu_into = [&](float* dst, int dp, int rwid, int reg, const float* sc,
                            const float* sh) {
      return [=](int p, int co, float v) {
        const bool inside =
            dffx::in_image(th0 - 3 + reg + p / rwid, tw0 - 3 + reg + p % rwid, H, W);
        dst[co * dp + p] = inside ? fmaxf(fmaf(v, sc[co], sh[co]), 0.f) : 0.f;
      };
    };

    conv_stage<true, NB, P::mg(0), P::rh(0), P::rw(0), P::IW, P::IP>(
        in_s, smem + P::W0, warp, lane,
        bn_relu_into(ya, P::AP, P::rw(0), 0, smem + P::S0, smem + P::B0));
    __syncthreads();  // region 0 is complete, and no warp reads the input tile again

    if (tile + gridDim.x < ntiles) stage(tile + gridDim.x);
    cp_async_commit();

    conv_stage<false, NB, P::mg(1), P::rh(1), P::rw(1), P::rw(0), P::AP>(
        ya, smem + P::W1, warp, lane,
        bn_relu_into(yb, P::BP, P::rw(1), 1, smem + P::S1, smem + P::B1));
    __syncthreads();
    conv_stage<false, NB, P::mg(2), P::rh(2), P::rw(2), P::rw(1), P::BP>(
        yb, smem + P::W2, warp, lane,
        bn_relu_into(ya, P::A2P, P::rw(2), 2, smem + P::S2, smem + P::B2));
    __syncthreads();

    // conv3 + bias for the tile's own pixels: channels 0..2 of its one n-tile
    const float* bias = smem + P::BIAS;
    const int64_t obase = ((int64_t)(bn / N) * CO * N + bn % N) * hw;
    conv_stage<false, 1, P::mg(3), TH, TW, P::rw(2), P::A2P>(
        ya, smem + P::W3, warp, lane, [=](int p, int co, float v) {
          const int gh = th0 + p / TW, gw = tw0 + p % TW;
          if (co < CO && gh < H && gw < W) {
            dffx::store(y, obase + co * cstride + (int64_t)gh * W + gw, v + bias[co]);
          }
        });
  }
  cp_async_wait_all();
}

cudaError_t launch(const void* x, const void* params, void* y, int B, int N, int H, int W,
                   cudaStream_t stream) {
  const auto kernel = motion_head_kernel;
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

// ---------------------------------------------------------------------------
// bf16
// ---------------------------------------------------------------------------

constexpr int NW_BF16 = 16, NT_BF16 = 32 * NW_BF16;  // warps and threads of a block
constexpr int MGCAP_BF16 = 2;  // m-tiles of a warp in one round, at most
// m-tiles a warp takes together in conv r of the bf16 kernel
__host__ __device__ constexpr int mg16(int r) {
  return dffx::region_mg(P::rh(r) * P::rw(r), NW_BF16, MGCAP_BF16);
}

// Tile and shared-memory plan of the bf16 kernel: P's tile and regions.
// Parameters as the wrapper packs them (kernels.py::motion_head_params of a
// bf16 x), each conv as _bf16_fragments: w0 (k = 16 tap + channel for
// channels 0..15 in nine k16 steps, then the tail, k = 144 + 2 tap + channel
// - 16, in a k16 and a k8 step), s0, b0, w1, s1, b1, w2, s2, b2 (k = 16 tap
// + channel), w3 (its 3 output channels padded to 8), bias3 padded to 4.
// Shared memory holds them as they come, then the raw input tile
// [18][IH][IW], region A (regions 0 and 2) and region B (region 1) as hi and
// lo planes of [pixels][16].  Until conv1 writes region B, its space holds the
// input tile as [IH][XS] pixels of channels 0..15 and the tail's words
// (channels 16, 17).  Rows are XS, RS0, RS1 and RS2 pixels apart: each = its
// reader's region rows (mod 8), so that the eight rows of an ldmatrix lie in
// eight bank groups; XS = 14 (mod 32) keeps the tail's word loads, whose
// taps span three rows, free of conflicts too.
struct PB {
  static constexpr int IH = P::IH, IW = P::IW;
  static constexpr int XS = 46, RS0 = 44, RS1 = 42, RS2 = 40;
  static constexpr int KS0 = 11, FW = 9 * NB * 128;  // conv0's k-steps; a 16 -> 16 conv's words
  static constexpr int W0 = 0, SC0 = W0 + KS0 * NB * 128, SH0 = SC0 + C, W1 = SH0 + C,
                       SC1 = W1 + FW, SH1 = SC1 + C, W2 = SH1 + C, SC2 = W2 + FW,
                       SH2 = SC2 + C, W3 = SH2 + C, BIAS = W3 + 9 * 128, WEND = BIAS + 4;
  static constexpr int AW = 8 * (P::rh(0) * RS0 > P::rh(2) * RS2 ? P::rh(0) * RS0
                                                                 : P::rh(2) * RS2);
  static constexpr int BW = 8 * P::rh(1) * RS1;
  static constexpr int RAW = WEND, AH = RAW + CIN * IH * IW / 2, AL = AH + AW, BH = AL + AW,
                       BL = BH + BW, END = BL + BW;
  static constexpr int XIN = BH, XT = XIN + 8 * IH * XS;
  static_assert(RS0 % 8 == P::rw(1) % 8 && RS1 % 8 == P::rw(2) % 8 && RS2 % 8 == TW % 8 &&
                    XS % 8 == P::rw(0) % 8 && XS % 32 == 14,
                "conflict-free rows");
  static_assert(XS >= IW && RS0 >= P::rw(0) && RS1 >= P::rw(1) && RS2 >= P::rw(2),
                "rows fit");
  static_assert(XT + IH * XS <= END, "the input tile fits region B's planes");
  static_assert(WEND % 4 == 0 && AH % 4 == 0 && AL % 4 == 0 && BH % 4 == 0 && BL % 4 == 0,
                "16-byte copies and ldmatrix rows");
};

// Persistent: block i takes tiles i, i + gridDim.x, ...; tile index =
// (b * N + n) * tiles_h * tiles_w + ty * tiles_w + tx.  vec: the raw tile by
// 8-byte cp.async (W % 4 == 0, x 8-byte aligned).
__global__ void __launch_bounds__(NT_BF16, 1)
motion_head_bf16_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ params,
                        __nv_bfloat16* __restrict__ y, int N, int H, int W, int tiles_w,
                        int tiles_h, int ntiles, bool vec) {
  using dffx::chunk_at;
  using dffx::conv3x3_hilo;
  using dffx::conv_b;
  using dffx::region_mma_bf16;
  using dffx::store_hilo;
  extern __shared__ __align__(16) float smem[];
  __nv_bfloat16* raw = reinterpret_cast<__nv_bfloat16*>(smem + PB::RAW);
  uint32_t* ah = reinterpret_cast<uint32_t*>(smem + PB::AH);
  uint32_t* al = reinterpret_cast<uint32_t*>(smem + PB::AL);
  uint32_t* bh = reinterpret_cast<uint32_t*>(smem + PB::BH);
  uint32_t* bl = reinterpret_cast<uint32_t*>(smem + PB::BL);
  const uint32_t* xt = reinterpret_cast<const uint32_t*>(smem + PB::XT);
  const uint32_t ah_at = dffx::smem_addr(ah), al_at = dffx::smem_addr(al);
  const uint32_t bh_at = dffx::smem_addr(bh), bl_at = dffx::smem_addr(bl);
  const uint32_t xin_at = dffx::smem_addr(smem + PB::XIN);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int64_t hw = (int64_t)H * W;
  const int64_t cstride = (int64_t)N * hw;
  const int per_slice = tiles_w * tiles_h;
  auto stage = [&](int tile) {
    const int bn = tile / per_slice, r = tile % per_slice;
    dffx::stage_bf16<CIN, PB::IH, PB::IW, NT_BF16, 4>(
        x, ((int64_t)(bn / N) * CIN * N + bn % N) * hw, cstride, raw, r / tiles_w * TH - 4,
        r % tiles_w * TW - 4, H, W, vec);
  };

  for (int i = threadIdx.x; i < PB::WEND / 4; i += NT_BF16) {
    cp_async16(smem + 4 * i, params + 4 * i);
  }
  stage(blockIdx.x);
  cp_async_commit();

  // The tail's k pair q is channels 16 and 17 at tap q, one word of xt: thread
  // t takes pairs t (a0, a1) and 4 + t (a2, a3) of its k16 step and 8 + t of
  // its k8 step, at xt offsets tl[0..2] from its pixel.  A pair past tap 8
  // (zero weights) reads tap 8's word: an element of the tile, never a word
  // that nothing wrote.
  int tl[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int tap = min(4 * i + t, 8);
    tl[i] = tap / 3 * PB::XS + tap % 3;
  }

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int bn = tile / per_slice, r = tile % per_slice;
    const int th0 = r / tiles_w * TH, tw0 = r % tiles_w * TW;
    cp_async_wait_all();
    __syncthreads();  // the raw tile is in, and no warp reads region B any more

    // the raw tile transposed: a thread a pixel and 8-channel chunk, or a
    // pixel's tail word
    {
      constexpr int PIX = PB::IH * PB::IW;
      const unsigned short* r16 = reinterpret_cast<const unsigned short*>(raw);
      for (int i = threadIdx.x; i < 3 * PIX; i += NT_BF16) {
        const int q = i / PIX, pix = i % PIX;
        const int at = pix / PB::IW * PB::XS + pix % PB::IW;
        const unsigned short* src = r16 + 8 * q * PIX + pix;
        if (q < 2) {
          uint32_t w[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            w[k] = src[2 * k * PIX] | static_cast<uint32_t>(src[(2 * k + 1) * PIX]) << 16;
          }
          reinterpret_cast<uint4*>(smem + PB::XIN)[chunk_at<2>(at, q)] =
              make_uint4(w[0], w[1], w[2], w[3]);
        } else {
          reinterpret_cast<uint32_t*>(smem + PB::XT)[at] =
              src[0] | static_cast<uint32_t>(src[PIX]) << 16;
        }
      }
    }
    __syncthreads();  // the input tile is complete, and the raw buffer is free
    if (tile + gridDim.x < ntiles) stage(tile + gridDim.x);
    cp_async_commit();

    // relu(BN(.)) of position p of region reg (rows P::rw(reg)) into the hi
    // and lo planes dh, dl (rows ds pixels apart), 0 outside the image; region
    // reg's (0, 0) is image pixel (th0 - 3 + reg, tw0 - 3 + reg)
    auto bn_relu_into = [&](uint32_t* dh, uint32_t* dl, int ds, int reg, const float* sc,
                            const float* sh) {
      return [=](int p, int co, float v0, float v1) {
        const int rwid = P::rw(reg);
        const bool in = dffx::in_image(th0 - 3 + reg + p / rwid, tw0 - 3 + reg + p % rwid, H, W);
        v0 = in ? fmaxf(fmaf(v0, sc[co], sh[co]), 0.f) : 0.f;
        v1 = in ? fmaxf(fmaf(v1, sc[co + 1], sh[co + 1]), 0.f) : 0.f;
        store_hilo<C>(dh, dl, p / rwid * ds + p % rwid, co, v0, v1);
      };
    };

    // conv0: x.w_hi + x.w_lo, channels 0..15 by ldmatrix, the tail by word
    // loads -> BN0 -> ReLU into region A (region 0, rows RS0)
    {
      constexpr int MG = mg16(0), NPOS = P::rh(0) * P::rw(0);
      region_mma_bf16<NW_BF16, MG, NB, NPOS>(
          warp, lane,
          [&](const int(&m0)[MG], int nvalid, float(&acc)[MG][NB][4]) {
            int pix[MG], pa[MG], pb[MG];
#pragma unroll
            for (int j = 0; j < MG; ++j) {
              const int o = min(m0[j] + lane % 16, NPOS - 1);
              const int p = min(m0[j] + g, NPOS - 1), q = min(m0[j] + g + 8, NPOS - 1);
              pix[j] = o / P::rw(0) * PB::XS + o % P::rw(0);
              pa[j] = p / P::rw(0) * PB::XS + p % P::rw(0);
              pb[j] = q / P::rw(0) * PB::XS + q % P::rw(0);
            }
#pragma unroll
            for (int s = 0; s < 9; ++s) {
              uint4 b[NB];
              conv_b<NB>(smem + PB::W0, s, lane, b);
              uint32_t a[MG][4];
#pragma unroll
              for (int j = 0; j < MG; ++j) {
                if (j < nvalid) dffx::conv_a<C, PB::XS>(xin_at, pix[j], lane, s, false, a[j]);
              }
              dffx::mma_bf16_split_b(a, b, nvalid, false, acc);
            }
#pragma unroll
            for (int s = 9; s < PB::KS0; ++s) {
              const bool k8 = s == PB::KS0 - 1;
              uint4 b[NB];
              conv_b<NB>(smem + PB::W0, s, lane, b);
              uint32_t a[MG][4];
#pragma unroll
              for (int j = 0; j < MG; ++j) {
                if (j >= nvalid) continue;
                a[j][0] = xt[pa[j] + tl[2 * (s - 9)]];
                a[j][1] = xt[pb[j] + tl[2 * (s - 9)]];
                if (!k8) {
                  a[j][2] = xt[pa[j] + tl[1]];
                  a[j][3] = xt[pb[j] + tl[1]];
                }
              }
              dffx::mma_bf16_split_b(a, b, nvalid, k8, acc);
            }
          },
          bn_relu_into(ah, al, PB::RS0, 0, smem + PB::SC0, smem + PB::SH0));
    }
    __syncthreads();  // region 0 is complete, and no warp reads the input tile again

    // conv1 and conv2: hi.w_hi + hi.w_lo + lo.w_hi, A -> B -> A
    {
      constexpr int MG = mg16(1), NPOS = P::rh(1) * P::rw(1);
      region_mma_bf16<NW_BF16, MG, NB, NPOS>(
          warp, lane,
          [&](const int(&m0)[MG], int nvalid, float(&acc)[MG][NB][4]) {
            int pix[MG];
#pragma unroll
            for (int j = 0; j < MG; ++j) {
              const int o = min(m0[j] + lane % 16, NPOS - 1);
              pix[j] = o / P::rw(1) * PB::RS0 + o % P::rw(1);
            }
            conv3x3_hilo<C, PB::RS0>(ah_at, al_at, pix, nvalid, smem + PB::W1, lane, acc);
          },
          bn_relu_into(bh, bl, PB::RS1, 1, smem + PB::SC1, smem + PB::SH1));
    }
    __syncthreads();
    {
      constexpr int MG = mg16(2), NPOS = P::rh(2) * P::rw(2);
      region_mma_bf16<NW_BF16, MG, NB, NPOS>(
          warp, lane,
          [&](const int(&m0)[MG], int nvalid, float(&acc)[MG][NB][4]) {
            int pix[MG];
#pragma unroll
            for (int j = 0; j < MG; ++j) {
              const int o = min(m0[j] + lane % 16, NPOS - 1);
              pix[j] = o / P::rw(2) * PB::RS1 + o % P::rw(2);
            }
            conv3x3_hilo<C, PB::RS1>(bh_at, bl_at, pix, nvalid, smem + PB::W2, lane, acc);
          },
          bn_relu_into(ah, al, PB::RS2, 2, smem + PB::SC2, smem + PB::SH2));
    }
    __syncthreads();

    // conv3 + bias for the tile's own pixels: channels 0..2 of its one n-tile
    {
      constexpr int MG = mg16(3), NPOS = TH * TW;
      const float* bias = smem + PB::BIAS;
      const int64_t obase = ((int64_t)(bn / N) * CO * N + bn % N) * hw;
      region_mma_bf16<NW_BF16, MG, 1, NPOS>(
          warp, lane,
          [&](const int(&m0)[MG], int nvalid, float(&acc)[MG][1][4]) {
            int pix[MG];
#pragma unroll
            for (int j = 0; j < MG; ++j) {
              const int o = m0[j] + lane % 16;
              pix[j] = o / TW * PB::RS2 + o % TW;
            }
            conv3x3_hilo<C, PB::RS2>(ah_at, al_at, pix, nvalid, smem + PB::W3, lane, acc);
          },
          [&](int p, int co, float v0, float v1) {
            const int gh = th0 + p / TW, gw = tw0 + p % TW;
            if (co < CO && gh < H && gw < W) {
              const int64_t o = obase + co * cstride + (int64_t)gh * W + gw;
              dffx::store(y, o, v0 + bias[co]);
              if (co + 1 < CO) dffx::store(y, o + cstride, v1 + bias[co + 1]);
            }
          });
    }
  }
  cp_async_wait_all();
}

cudaError_t launch_bf16(const void* x, const void* params, void* y, int B, int N, int H, int W,
                        cudaStream_t stream) {
  const auto kernel = motion_head_bf16_kernel;
  const int bytes = PB::END * static_cast<int>(sizeof(float));
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const int64_t ntiles = (int64_t)B * N * tiles_w * tiles_h;
  int grid = 0;
  const cudaError_t err = dffx::persistent_grid(kernel, NT_BF16, bytes, ntiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT_BF16, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(params),
      static_cast<__nv_bfloat16*>(y), N, H, W, tiles_w, tiles_h, static_cast<int>(ntiles),
      dffx::vec_ok_bf16(x, W, 4));
  return cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).
extern "C" int dffx_motion_head_conv_chain(const void* x, const void* params, void* y, int B,
                                           int Cin, int Cmid, int N, int H, int W, int dtype,
                                           void* stream) {
  if (Cin != CIN || Cmid != C) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DFFX_DTYPE_F32) return launch(x, params, y, B, N, H, W, s);
  if (dtype == DFFX_DTYPE_BF16) return launch_bf16(x, params, y, B, N, H, W, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
