// fm_conv_bn_relu: the full-resolution focus-measure conv of DFFNet.
//
// Replaces the TPU kernel dffx/ops/pallas_kernels.py::fm_conv_bn_relu_cf
// (body _fm_conv_kernel).  Computes, per focal slice,
//   Conv3d(3 -> 8, k=(1,9,9), pad=(0,8,8), dil=(1,2,2)) -> eval BN -> ReLU
// on (B, 3, N, H, W) -> (B, 8, N, H, W), with eval BN folded into an fp32
// per-channel (scale, shift).
//
// What bounds it on the card: 243 taps x 8 outputs = 1,944 FMAs (3.9 kFLOP)
// per output pixel against 44 bytes of fp32 traffic (12 read, 32 written),
// about 88 FLOP/byte, so arithmetic bounds it, not HBM: at 1 x 3 x 10 x 608 x
// 1088 the HBM time is 0.087 ms, the fp32 FMA pipe's 0.38 ms and the tensor
// cores' in 3xTF32 0.16 ms.  The first design ran on the FMA pipe, one thread
// per pixel, and was bound by its shared-memory loads (3 per 8 FMAs).
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
//   (0.65 ms with it, 0.52 without, H100 at 700 W, 1 x 3 x 10 x 608 x 1088).  A bf16
//   input is a TF32 already: no low part, two MMAs per product instead of three.
//   Splitting the tile once into a plane of high and one of low parts
//   measured the same as the masked split in the loop (0.53 ms) and went.
// * BN and ReLU on the accumulators; bf16 rounds only the output.  The slice
//   is part of the tile index, not a grid dimension: any B * N.
// Now at about 146 TFLOP/s of TF32 MMAs (0.54 ms), of the 328 that bare
// mma.sync reaches there (dffx_torch/bench.py --what mma).
#include <type_traits>

#include "mma.cuh"

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
template <typename T>
__global__ void __launch_bounds__(NT, 2)
fm_conv_bn_relu_kernel(const T* __restrict__ x, const float* __restrict__ params,
                       T* __restrict__ y, int N, int H, int W, int tiles_w, int tiles_h,
                       int ntiles, bool vec) {
  // a widened bf16 is a TF32 already and has no low part; fp32 is split in the loop
  constexpr bool BF16 = !std::is_same<T, float>::value;
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
          dffx::load_a<BF16>(row + px[j], ah[j][0], al[j][0]);
          dffx::load_a<BF16>(row + px[j] + 8, ah[j][1], al[j][1]);
          dffx::load_a<BF16>(row + px[j] + 16, ah[j][3], al[j][3]);
          ah[j][2] = ah[j][1];  // (pixel g, tap t + 4) = (pixel g + 8, tap t)
          al[j][2] = al[j][1];
        }
        dffx::mma_3xtf32<MG, 1, !BF16>(ah, al, bh, bl, MG, acc);
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
      dffx::mma_kstep_at<MG, 1, BF16>(in + c * P + 16, pa, pb, 0, 8 * SW, MG,
                                      frag + (CIN * K + c) * 32, lane, acc);
    }
    // k-step 30: tap (8, 8) of channel k for k < 3; the rest meets zero weights
#pragma unroll
    for (int j = 0; j < MG; ++j) {
      pa[j] = px[j] + min(t, CIN - 1) * P;
      pb[j] = pa[j] + 8;
    }
    dffx::mma_kstep_at<MG, 1, BF16>(in + 16 * SW + 16, pa, pb, 0, 0, MG,
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

template <typename T>
cudaError_t launch(const void* x, const void* params, void* y, int B, int N, int H, int W,
                   cudaStream_t stream) {
  const auto kernel = fm_conv_bn_relu_kernel<T>;
  const int bytes = S_END * static_cast<int>(sizeof(float));
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const int64_t ntiles = (int64_t)B * N * tiles_w * tiles_h;
  int grid = 0;
  const cudaError_t err = dffx::persistent_grid(kernel, NT, bytes, ntiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(params), static_cast<T*>(y), N, H, W,
      tiles_w, tiles_h, static_cast<int>(ntiles), dffx::vec_ok(x, W));
  return cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).
extern "C" int dffx_fm_conv_bn_relu(const void* x, const void* params, void* y, int B, int N,
                                    int H, int W, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DFFX_DTYPE_F32) return launch<float>(x, params, y, B, N, H, W, s);
  if (dtype == DFFX_DTYPE_BF16) return launch<__nv_bfloat16>(x, params, y, B, N, H, W, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
