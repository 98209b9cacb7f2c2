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
// FLOP/byte, so arithmetic bounds it, not HBM: 1.5 ms on the fp32 FMA pipe
// (67 TFLOP/s) at 1 x 18 x 10 x 608 x 1088, 0.61 ms on the tensor cores in
// 3xTF32 (a third of 495 TFLOP/s).  The first design ran on the FMA pipe and
// was bound by the shared-memory loads that fed it (5 loads per 16 FMAs), with
// one 8-warp block per SM and all 30 KB of weights restaged for every tile.
//
// What the design does about it:
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
//   set the pace.  A bf16 input is a TF32 already: conv0 then has no lo.hi term.
// * A persistent grid (one 16-warp block per SM: 200 KB of shared memory)
//   walks the 32 x 16 tiles.  A block copies the weights once, already in
//   B-fragment order (kernels.py::motion_head_params), with 16-byte cp.async.
//   The input tile with the chain's 4-pixel halo arrives by cp.async (16 bytes
//   at a time when W is a multiple of 4, zero-filled outside the image; bf16
//   through registers), and the next tile's is in flight from the end of
//   conv0 on, while conv1..conv3 run.
// * BN and ReLU are applied to the accumulators in registers; the result goes
//   to shared memory as the next conv's A operand, in two buffers that take
//   turns (conv0 -> A, conv1 -> B, conv2 -> A), channel planes at a stride of
//   8 (mod 32) floats.  Every intermediate is 0 outside the image, as the next
//   conv's zero padding requires: relu(BN(0)) is not 0 wherever a BN shift is
//   positive (the TPU kernel masks the same positions with store_masked).
// The chain recomputes its halo: 1.31x the pixels of the four convs at the
// 32 x 16 tile.  Measured on the H100 (700 W) at 1 x 18 x 10 x 608 x 1088: 3.6 to
// 3.8 ms (the FMA design: 7.6), about 125 TFLOP/s of TF32 MMAs, against 328
// TFLOP/s that bare mma.sync m16n8k8 reaches there (dffx_torch/bench.py --what
// mma).
// Variants that lost there, kernel only: 8 warps with 4 m-tiles a round
// (4.6 ms), a 32 x 8 tile (5.8 ms), and on that tile the intermediates written
// as their two TF32 parts, which takes the split out of conv1..conv3's loops
// (5.2 ms; the planes do not fit at 32 x 16).
#include <type_traits>

#include "mma.cuh"

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

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

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
    const int mt = ceil_div(ceil_div(rh(r) * rw(r), 16), NW);
    return ceil_div(mt, ceil_div(mt, MGCAP));
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
// TAIL, the three k-steps of channels 16 and 17.  The warp's m-tiles are
// warp, warp + NW, ..., MG of them per round; epi(p, co, sum) takes each
// result (co = 8 nb + 2 t + {0, 1}).  BF16: src holds widened bf16 values,
// which have no low part (mma.cuh::load_a).
template <bool TAIL, int NBO, int MG, int RH, int RW, int SW, int SP, bool BF16, typename Epi>
__device__ __forceinline__ void conv_stage(const float* __restrict__ src,
                                           const float* __restrict__ w, int warp, int lane,
                                           Epi epi) {
  constexpr int NPOS = RH * RW, M = (NPOS + 15) / 16;
  const int g = lane / 4, t = lane % 4;
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
  const int mine = (M - warp + NW - 1) / NW;
#pragma unroll 1
  for (int i0 = 0; i0 < mine; i0 += MG) {
    int pa[MG], pb[MG];
#pragma unroll
    for (int j = 0; j < MG; ++j) {
      const int p0 = min((warp + (i0 + j) * NW) * 16 + g, NPOS - 1);
      const int p1 = min(p0 + 8, NPOS - 1);
      pa[j] = t * SP + p0 / RW * SW + p0 % RW;
      pb[j] = t * SP + p1 / RW * SW + p1 % RW;
    }
    const int nvalid = min(mine - i0, MG);
    float acc[MG][NBO][2][4] = {};
    dffx::conv3x3_mma<C, MG, NBO, SP, SW, BF16>(src, pa, pb, nvalid, w, lane, acc);
    if constexpr (TAIL) {
#pragma unroll
      for (int s = 0; s < TAIL_STEPS; ++s) {
        dffx::mma_kstep_at<MG, NBO, BF16>(src, pa, pb, tail[s][0], tail[s][1], nvalid,
                                          frag + (9 * KC + s) * NBO * 32, lane, acc);
      }
    }
#pragma unroll
    for (int j = 0; j < MG; ++j) {
      if (j >= nvalid) continue;
#pragma unroll
      for (int nb = 0; nb < NBO; ++nb) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int p = (warp + (i0 + j) * NW) * 16 + g + 8 * (k / 2);
          if (p < NPOS) epi(p, nb * 8 + 2 * t + k % 2, acc[j][nb][0][k] + acc[j][nb][1][k]);
        }
      }
    }
  }
}

// Persistent: block i takes tiles i, i + gridDim.x, ...; tile index =
// (b * N + n) * tiles_h * tiles_w + ty * tiles_w + tx.
// vec: the input tile by 16-byte copies (fp32, W % 4 == 0, x 16-byte aligned).
template <typename T>
__global__ void __launch_bounds__(NT, 1)
motion_head_kernel(const T* __restrict__ x, const float* __restrict__ params,
                   T* __restrict__ y, int N, int H, int W, int tiles_w, int tiles_h,
                   int ntiles, bool vec) {
  // a widened bf16 is a TF32 already: conv0's A operand has no low part
  constexpr bool BF16_IN = !std::is_same<T, float>::value;
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

    conv_stage<true, NB, P::mg(0), P::rh(0), P::rw(0), P::IW, P::IP, BF16_IN>(
        in_s, smem + P::W0, warp, lane,
        bn_relu_into(ya, P::AP, P::rw(0), 0, smem + P::S0, smem + P::B0));
    __syncthreads();  // region 0 is complete, and no warp reads the input tile again

    if (tile + gridDim.x < ntiles) stage(tile + gridDim.x);
    cp_async_commit();

    conv_stage<false, NB, P::mg(1), P::rh(1), P::rw(1), P::rw(0), P::AP, false>(
        ya, smem + P::W1, warp, lane,
        bn_relu_into(yb, P::BP, P::rw(1), 1, smem + P::S1, smem + P::B1));
    __syncthreads();
    conv_stage<false, NB, P::mg(2), P::rh(2), P::rw(2), P::rw(1), P::BP, false>(
        yb, smem + P::W2, warp, lane,
        bn_relu_into(ya, P::A2P, P::rw(2), 2, smem + P::S2, smem + P::B2));
    __syncthreads();

    // conv3 + bias for the tile's own pixels: channels 0..2 of its one n-tile
    const float* bias = smem + P::BIAS;
    const int64_t obase = ((int64_t)(bn / N) * CO * N + bn % N) * hw;
    conv_stage<false, 1, P::mg(3), TH, TW, P::rw(2), P::A2P, false>(
        ya, smem + P::W3, warp, lane, [=](int p, int co, float v) {
          const int gh = th0 + p / TW, gw = tw0 + p % TW;
          if (co < CO && gh < H && gw < W) {
            dffx::store(y, obase + co * cstride + (int64_t)gh * W + gw, v + bias[co]);
          }
        });
  }
  cp_async_wait_all();
}

template <typename T>
cudaError_t launch(const void* x, const void* params, void* y, int B, int N, int H, int W,
                   cudaStream_t stream) {
  const auto kernel = motion_head_kernel<T>;
  const int bytes = P::END * static_cast<int>(sizeof(float));
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
extern "C" int dffx_motion_head_conv_chain(const void* x, const void* params, void* y, int B,
                                           int Cin, int Cmid, int N, int H, int W, int dtype,
                                           void* stream) {
  if (Cin != CIN || Cmid != C) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DFFX_DTYPE_F32) return launch<float>(x, params, y, B, N, H, W, s);
  if (dtype == DFFX_DTYPE_BF16) return launch<__nv_bfloat16>(x, params, y, B, N, H, W, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
