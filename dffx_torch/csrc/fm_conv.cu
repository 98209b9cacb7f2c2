// fm_conv_bn_relu: the full-resolution focus-measure conv of DFFNet.
//
// Replaces the TPU kernel dffx/ops/pallas_kernels.py::fm_conv_bn_relu_cf
// (body _fm_conv_kernel).  Computes, per focal slice,
//   Conv3d(3 -> 8, k=(1,9,9), pad=(0,8,8), dil=(1,2,2)) -> eval BN -> ReLU
// on (B, 3, N, H, W) -> (B, 8, N, H, W), with eval BN folded into an fp32
// per-channel (scale, shift).  fp32 and bf16 have a design each.
//
// fp32.  What bounds it on the card: 243 taps x 8 outputs = 1,944 FMAs (3.9
// kFLOP) per output pixel against 44 bytes of fp32 traffic (12 read, 32
// written), about 88 FLOP/byte, so arithmetic bounds it, not HBM: at 1 x 3 x
// 10 x 608 x 1088 the HBM time is 0.087 ms, the fp32 FMA pipe's 0.38 ms and the
// tensor cores' in 3xTF32 0.16 ms.  The first design ran on the FMA pipe, one
// thread per pixel, and was bound by its shared-memory loads (3 per 8 FMAs).
//
// What the design does about it:
// * The conv is an implicit GEMM on the tensor cores (mma.cuh): M = pixels,
//   N = 8 output channels (one n-tile), K = 243 taps padded to 248 in 31
//   k-steps, 3xTF32 with the small terms in an accumulator of their own.
// * The k order is chosen so that every A-fragment address is the thread's
//   pixel plus a constant, with no table.  An m-tile is 16 consecutive pixels
//   of a row.  k-steps 0..26 take one (channel, ky) each and kx = 0..7: the
//   taps lie 2 pixels apart, so pixel x + 8 at tap kx reads what pixel x reads
//   at tap kx + 4, and the fragment's four values are three loads.  k-steps
//   27..29 take kx = 8 of one channel at ky = 0..7, k-step 30 the three
//   (8, 8) taps; its other five k values meet zero weights
//   (kernels.py::fm_conv_taps is the same order, for the weights).
// * A persistent grid walks 32 x 16 tiles, 8 warps of 4 m-tiles each; a block
//   copies the weights once, already as B fragments, with 16-byte cp.async.
//   The input tile with its 8-pixel halo (3 x 32 x 48, rows 52 floats apart:
//   2 rows are 8 banks apart, which keeps k-steps 27..29 free of bank
//   conflicts) is double-buffered: the next tile's arrives by cp.async, 16
//   bytes at a time when W is a multiple of 4, zero-filled outside the image,
//   while this tile's MMAs run.  48 KB a block: two blocks per SM (registers).
// * A value is split with a mask and a subtraction (mma.cuh::
//   split_tf32), not with cvt.rna.tf32.f32, whose rate bounded the loop
//   (0.65 ms with it, 0.52 without, H100 at 700 W, 1 x 3 x 10 x 608 x 1088).
//   Splitting the tile once into a plane of high and one of low parts
//   measured the same as the masked split in the loop (0.53 ms) and went.
// * BN and ReLU on the accumulators.  The slice is part of the tile index,
//   not a grid dimension: any B * N.
// Now at about 146 TFLOP/s of TF32 MMAs (0.54 ms), of the 328 that bare
// mma.sync reaches there (dffx_torch/bench.py --what mma).
//
// bf16.  What bounds it on the card: the function is 1,944 bf16 products a
// pixel (one each at 989 TFLOP/s: 0.026 ms at 1 x 3 x 10 x 608 x 1088)
// against 22 bytes (6 read, 16 written: 0.043 ms), so HBM bounds it.  Done
// fp32-accurately (bf16 in, fp32 inside, only the output rounded) each
// product is two bf16 MMAs, x.w_hi + x.w_lo (bf16_mma.cuh; one pass of bf16
// weights is some 80 times further off than 1e-4 before the rounding), and
// with K padded from 243 to 272 that is 57.6 GFLOP of MMAs there, 0.058 ms at
// 989 TFLOP/s.  The fp32 design's kernel on widened bf16 planes ran two TF32
// MMAs (of half the k) a product from 4-byte shared-memory words a value.
//
// What the bf16 design does about it:
// * m16n8k16 bf16 MMAs, whose A register holds two consecutive k values.  A
//   dilated tap's neighbour is 2 pixels away, so each tile is rewritten once
//   into pair planes: word (c, Y, X) holds the bf16 values at columns X and X
//   + 2 (k = kx and kx + 1 of one (c, ky) row).  The raw bf16 tile (3 x 32 x 56)
//   arrives by 16-byte cp.async while the last tile's MMAs run; one pass of
//   byte permutes writes the pair planes (rows 52 words apart, planes 8 (mod
//   32) words apart, as the fp32 tile's), and the raw buffer takes the next
//   tile's copy.
// * K = 243 taps in 17 k-steps of 16 (kernels.py::fm_conv_bf16_taps).  A
//   k-step is two halves of four k pairs, slot t of a half the pair thread t
//   reads: a (c, ky) row's pairs kx = 2t, 2t + 1 for t < 4, or kx = 8 (with a
//   zero-weight kx = 9) at ky = t or 4 + t of one channel, or at (t, 8, 8).
//   Every A word is a per-thread constant plus a per-step one, with no table,
//   and free of bank conflicts.
// * A warp's four m-tiles are 16 pixels of the output rows y0, y0 + 2, y0 + 4
//   and y0 + 6, so that m-tile j at row ky reads the pair row that m-tile
//   j + 1 reads at ky - 1: a channel's 27 rows of pairs for the four m-tiles
//   are 12 rows of words in registers, loaded once.  A k-step's B fragments
//   are one 16-byte load a lane, and its 8 MMAs share them.
// * BN and ReLU on the fp32 accumulators; the same persistent grid over 32 x 16
//   tiles, weights copied once a block.
// Measured on an NVIDIA H100 80GB HBM3 (700.00 W), launches back to back,
// against the fp32 design's kernel on widened bf16 in the same call
// (dffx_torch/bench.py --what kernels --root): 0.238 ms at 1 x 3 x 10 x 608 x
// 1088 (0.371-0.374), 6.96-7.02 at 128 x 3 x 10 x 384 x 384 (10.29-10.32).  A
// tile takes 1,088 MMAs, 1,024 4-byte and 136 16-byte shared loads in the
// k-loop, and 576 units of the pair pass (a 16- and a 4-byte load, two
// 16-byte stores each); 113 registers, no spills, two blocks of 39.6 KB an SM.
// Three blocks an SM (80 registers, 40 bytes of spills) took 0.245 ms.
#include "bf16_mma.cuh"

namespace {

using dffx::cp_async16;
using dffx::cp_async_commit;
using dffx::cp_async_wait_all;

constexpr int TW = 32, TH = 16, HALO = 8, NW = 8, NT = 32 * NW, MG = 4;
constexpr int IH = TH + 2 * HALO, IW = TW + 2 * HALO, SW = 52;
constexpr int P = dffx::plane(IH * SW);
constexpr int CIN = 3, COUT = 8, K = 9;
constexpr int KSTEPS = 31;  // 27 of (c, ky, kx < 8), 3 of (c, ky < 8, kx = 8), 1 of (c, 8, 8)
// parameters as the wrapper packs them, and as shared memory holds them:
// the B fragments [k-step][lane][2], scale, shift; then the two input tiles
constexpr int G_W = 0, G_SCALE = KSTEPS * 64, G_SHIFT = G_SCALE + COUT, G_END = G_SHIFT + COUT;
constexpr int S_IN = G_END, S_END = S_IN + 2 * CIN * P;
static_assert(G_END % 4 == 0 && SW % 4 == 0 && P % 4 == 0 && SW >= IW, "16-byte copies");
static_assert(TH * TW / 16 == NW * MG, "every warp takes MG m-tiles");

// Persistent: block i takes tiles i, i + gridDim.x, ...; tile index =
// (b * N + n) * tiles_h * tiles_w + ty * tiles_w + tx.
__global__ void __launch_bounds__(NT, 2)
fm_conv_bn_relu_kernel(const float* __restrict__ x, const float* __restrict__ params,
                       float* __restrict__ y, int N, int H, int W, int tiles_w, int tiles_h,
                       int ntiles, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int64_t hw = (int64_t)H * W;
  const int64_t cstride = (int64_t)N * hw;
  const int per_slice = tiles_w * tiles_h;
  auto stage = [&](int tile, float* dst) {
    const int bn = tile / per_slice, r = tile % per_slice;
    dffx::stage_tile_any<CIN, IH, IW, P, NT, SW>(
        x, ((int64_t)(bn / N) * CIN * N + bn % N) * hw, cstride, dst, r / tiles_w * TH - HALO,
        r % tiles_w * TW - HALO, H, W, vec);
  };

  for (int i = threadIdx.x; i < G_END / 4; i += NT) cp_async16(smem + 4 * i, params + 4 * i);
  stage(blockIdx.x, smem + S_IN);
  cp_async_commit();

  // the warp's m-tiles: rows 2 warp and 2 warp + 1 of the tile, two halves each
  int px[MG];
#pragma unroll
  for (int j = 0; j < MG; ++j) px[j] = (2 * warp + j / 2) * SW + j % 2 * 16 + g;
  const float2* frag = reinterpret_cast<const float2*>(smem + G_W);

  int cur = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, cur ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this tile's input is in, and no warp reads the last tile's any more
    if (tile + gridDim.x < ntiles) stage(tile + gridDim.x, smem + S_IN + (cur ^ 1) * CIN * P);
    cp_async_commit();
    const float* in = smem + S_IN + cur * CIN * P;

    float acc[MG][1][2][4] = {};
    // k-steps 0..26: (c, ky), k = kx < 8; tap kx of pixel p reads column p + 2 kx
#pragma unroll 1
    for (int c = 0; c < CIN; ++c) {
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
        const float* row = in + c * P + 2 * ky * SW + 2 * t;
        uint32_t bh[1][2], bl[1][2], ah[MG][4], al[MG][4];
        dffx::load_b_split<1>(frag + (c * K + ky) * 32, lane, bh, bl);
#pragma unroll
        for (int j = 0; j < MG; ++j) {
          dffx::load_a(row + px[j], ah[j][0], al[j][0]);
          dffx::load_a(row + px[j] + 8, ah[j][1], al[j][1]);
          dffx::load_a(row + px[j] + 16, ah[j][3], al[j][3]);
          ah[j][2] = ah[j][1];  // (pixel g, tap t + 4) = (pixel g + 8, tap t)
          al[j][2] = al[j][1];
        }
        dffx::mma_3xtf32<MG, 1>(ah, al, bh, bl, MG, acc);
      }
    }
    int pa[MG], pb[MG];
    // k-steps 27..29: channel c, kx = 8, k = ky < 8
#pragma unroll
    for (int j = 0; j < MG; ++j) {
      pa[j] = px[j] + 2 * t * SW;
      pb[j] = pa[j] + 8;
    }
#pragma unroll
    for (int c = 0; c < CIN; ++c) {
      dffx::mma_kstep_at<MG, 1>(in + c * P + 16, pa, pb, 0, 8 * SW, MG,
                                frag + (CIN * K + c) * 32, lane, acc);
    }
    // k-step 30: tap (8, 8) of channel k for k < 3; the rest meets zero weights
#pragma unroll
    for (int j = 0; j < MG; ++j) {
      pa[j] = px[j] + min(t, CIN - 1) * P;
      pb[j] = pa[j] + 8;
    }
    dffx::mma_kstep_at<MG, 1>(in + 16 * SW + 16, pa, pb, 0, 0, MG,
                              frag + (CIN * K + CIN) * 32, lane, acc);

    // BN and ReLU; thread (g, t) holds channels 2t, 2t + 1 of pixels g, g + 8
    const int bn = tile / per_slice, r = tile % per_slice;
    const int th0 = r / tiles_w * TH, tw0 = r % tiles_w * TW;
    const int64_t obase = ((int64_t)(bn / N) * COUT * N + bn % N) * hw;
    const float* scale = smem + G_SCALE;
    const float* shift = smem + G_SHIFT;
#pragma unroll
    for (int j = 0; j < MG; ++j) {
      const int gh = th0 + 2 * warp + j / 2;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int gw = tw0 + j % 2 * 16 + g + 8 * (k / 2), co = 2 * t + k % 2;
        if (gh < H && gw < W) {
          const float v = acc[j][0][0][k] + acc[j][0][1][k];
          dffx::store(y, obase + co * cstride + (int64_t)gh * W + gw,
                      fmaxf(fmaf(v, scale[co], shift[co]), 0.f));
        }
      }
    }
  }
  cp_async_wait_all();
}

// ---------------------------------------------------------------------------
// bf16
// ---------------------------------------------------------------------------

constexpr int RAW_W = 56;     // raw tile columns: the pairs of X <= 47 read X + 2 <= 49
constexpr int PAIR_W = 48;    // pair words a row, X = 0..47
constexpr int BF_KSTEPS = 17;
// parameters as the wrapper packs them (fm_conv_params of a bf16 x), and as
// shared memory holds them: B fragments [k-step][lane][4 words], scale,
// shift; then the pair planes [CIN][P] (rows SW words apart) and the raw tile
constexpr int BG_SCALE = BF_KSTEPS * 128, BG_SHIFT = BG_SCALE + COUT, BG_END = BG_SHIFT + COUT;
constexpr int BS_PAIRS = BG_END, BS_RAW = BS_PAIRS + CIN * P, BS_END = BS_RAW + CIN * IH * RAW_W / 2;
static_assert(BG_END % 4 == 0 && BS_RAW % 4 == 0 && RAW_W % 8 == 0 && SW >= PAIR_W,
              "16-byte copies and pair-plane stores");

// The pair planes of the raw tile: word (c, Y, X) = (raw[c][Y][X], raw[c][Y][X + 2]),
// eight words a unit from 20 bytes of a raw row.
__device__ __forceinline__ void pair_planes(const __nv_bfloat16* __restrict__ raw,
                                            uint32_t* __restrict__ pairs) {
  for (int i = threadIdx.x; i < CIN * IH * (PAIR_W / 8); i += NT) {
    const int c = i / (IH * (PAIR_W / 8)), r = i % (IH * (PAIR_W / 8));
    const int row = r / (PAIR_W / 8), x0 = r % (PAIR_W / 8) * 8;
    const __nv_bfloat16* src = raw + (c * IH + row) * RAW_W + x0;
    const uint4 v = *reinterpret_cast<const uint4*>(src);             // columns x0 .. x0 + 7
    const uint32_t v4 = *reinterpret_cast<const uint32_t*>(src + 8);  // x0 + 8, x0 + 9
    uint32_t* dst = pairs + c * P + row * SW + x0;
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(__byte_perm(v.x, v.y, 0x5410), __byte_perm(v.x, v.y, 0x7632),
                   __byte_perm(v.y, v.z, 0x5410), __byte_perm(v.y, v.z, 0x7632));
    *reinterpret_cast<uint4*>(dst + 4) =
        make_uint4(__byte_perm(v.z, v.w, 0x5410), __byte_perm(v.z, v.w, 0x7632),
                   __byte_perm(v.w, v4, 0x5410), __byte_perm(v.w, v4, 0x7632));
  }
}

// Persistent, on the fp32 kernel's tiles.  Warp w takes output rows y0 + 2j
// (j < MG), y0 = 8 (w / 4) + w / 2 % 2, columns 16 (w % 2) .. + 15: m-tile j
// at pair row ky reads the row m-tile j + 1 reads at ky - 1.
__global__ void __launch_bounds__(NT, 2)
fm_conv_bn_relu_bf16_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ params,
                            __nv_bfloat16* __restrict__ y, int N, int H, int W, int tiles_w,
                            int tiles_h, int ntiles, bool vec) {
  extern __shared__ __align__(16) float smem[];
  uint32_t* pairs = reinterpret_cast<uint32_t*>(smem + BS_PAIRS);
  __nv_bfloat16* raw = reinterpret_cast<__nv_bfloat16*>(smem + BS_RAW);
  const uint4* frag = reinterpret_cast<const uint4*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int64_t hw = (int64_t)H * W;
  const int64_t cstride = (int64_t)N * hw;
  const int per_slice = tiles_w * tiles_h;
  auto stage = [&](int tile) {
    const int bn = tile / per_slice, r = tile % per_slice;
    dffx::stage_bf16<CIN, IH, RAW_W, NT, 8>(x, ((int64_t)(bn / N) * CIN * N + bn % N) * hw,
                                           cstride, raw, r / tiles_w * TH - HALO,
                                           r % tiles_w * TW - HALO, H, W, vec);
  };

  for (int i = threadIdx.x; i < BG_END / 4; i += NT) cp_async16(smem + 4 * i, params + 4 * i);
  stage(blockIdx.x);
  cp_async_commit();

  const int y0 = warp / 4 * 8 + warp / 2 % 2;
  const int px = y0 * SW + warp % 2 * 16 + g;  // pixel g of m-tile 0 in a pair plane
  const int qr = px + 4 * t;                   // (c, ky) rows: pair t, kx = 2t, 2t + 1
  const int qc = px + 16 + 2 * t * SW;         // kx = 8 (and 9) at ky = t
  const int ql = px + 16 + 16 * SW + min(t, CIN - 1) * P;  // (8, 8) of channel t

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    cp_async_wait_all();
    __syncthreads();  // this tile's raw input is in, and no warp reads the pair planes
    pair_planes(raw, pairs);
    __syncthreads();  // the pair planes are complete, and the raw buffer is free
    if (tile + gridDim.x < ntiles) stage(tile + gridDim.x);
    cp_async_commit();

    float acc[MG][1][4] = {};
    uint32_t a[MG][4];
    uint4 b[1];
    // k-steps 5c .. 5c + 4: rows (c, 0..8) and kx = 8 at ky = 0..3
#pragma unroll 1
    for (int c = 0; c < CIN; ++c) {
      const uint32_t* plane = pairs + c * P;
      uint32_t win[MG + 8][2];  // pair row w = j + ky, pixels g and g + 8
#pragma unroll
      for (int w = 0; w < MG + 8; ++w) {
        win[w][0] = plane[qr + 2 * w * SW];
        win[w][1] = plane[qr + 2 * w * SW + 8];
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
#pragma unroll
        for (int j = 0; j < MG; ++j) {
          a[j][0] = win[j + 2 * s][0];
          a[j][1] = win[j + 2 * s][1];
          a[j][2] = win[j + 2 * s + 1][0];
          a[j][3] = win[j + 2 * s + 1][1];
        }
        b[0] = frag[(5 * c + s) * 32 + lane];
        dffx::mma_bf16_split_b(a, b, MG, false, acc);
      }
#pragma unroll
      for (int j = 0; j < MG; ++j) {
        a[j][0] = win[j + 8][0];
        a[j][1] = win[j + 8][1];
        a[j][2] = plane[qc + 2 * j * SW];
        a[j][3] = plane[qc + 2 * j * SW + 8];
      }
      b[0] = frag[(5 * c + 4) * 32 + lane];
      dffx::mma_bf16_split_b(a, b, MG, false, acc);
    }
    // k-step 15: kx = 8 at ky = 4..7 of channels 0 and 1; 16: of channel 2, then (c, 8, 8)
#pragma unroll
    for (int j = 0; j < MG; ++j) {
      const int o = qc + 8 * SW + 2 * j * SW;
      a[j][0] = pairs[o];
      a[j][1] = pairs[o + 8];
      a[j][2] = pairs[P + o];
      a[j][3] = pairs[P + o + 8];
    }
    b[0] = frag[15 * 32 + lane];
    dffx::mma_bf16_split_b(a, b, MG, false, acc);
#pragma unroll
    for (int j = 0; j < MG; ++j) {
      const int o = qc + 8 * SW + 2 * j * SW;
      a[j][0] = pairs[2 * P + o];
      a[j][1] = pairs[2 * P + o + 8];
      a[j][2] = pairs[ql + 2 * j * SW];
      a[j][3] = pairs[ql + 2 * j * SW + 8];
    }
    b[0] = frag[16 * 32 + lane];
    dffx::mma_bf16_split_b(a, b, MG, false, acc);

    // BN and ReLU; thread (g, t) holds channels 2t, 2t + 1 of pixels g, g + 8
    const int bn = tile / per_slice, r = tile % per_slice;
    const int th0 = r / tiles_w * TH, tw0 = r % tiles_w * TW;
    const int64_t obase = ((int64_t)(bn / N) * COUT * N + bn % N) * hw;
    const float* scale = smem + BG_SCALE;
    const float* shift = smem + BG_SHIFT;
#pragma unroll
    for (int j = 0; j < MG; ++j) {
      const int gh = th0 + y0 + 2 * j;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int gw = tw0 + warp % 2 * 16 + g + 8 * (k / 2), co = 2 * t + k % 2;
        if (gh < H && gw < W) {
          dffx::store(y, obase + co * cstride + (int64_t)gh * W + gw,
                      fmaxf(fmaf(acc[j][0][k], scale[co], shift[co]), 0.f));
        }
      }
    }
  }
  cp_async_wait_all();
}

template <typename T, typename Kernel>
cudaError_t launch(Kernel kernel, int words, bool vec, const void* x, const void* params, void* y,
                   int B, int N, int H, int W, cudaStream_t stream) {
  const int bytes = words * static_cast<int>(sizeof(float));
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const int64_t ntiles = (int64_t)B * N * tiles_w * tiles_h;
  int grid = 0;
  const cudaError_t err = dffx::persistent_grid(kernel, NT, bytes, ntiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(params), static_cast<T*>(y), N, H, W,
      tiles_w, tiles_h, static_cast<int>(ntiles), vec);
  return cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).
extern "C" int dffx_fm_conv_bn_relu(const void* x, const void* params, void* y, int B, int N,
                                    int H, int W, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DFFX_DTYPE_F32) {
    return launch<float>(fm_conv_bn_relu_kernel, S_END, dffx::vec_ok(x, W), x, params, y, B, N,
                         H, W, s);
  }
  if (dtype == DFFX_DTYPE_BF16) {
    return launch<__nv_bfloat16>(fm_conv_bn_relu_bf16_kernel, BS_END,
                                 dffx::vec_ok_bf16(x, W, 8), x, params, y, B, N, H, W, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
