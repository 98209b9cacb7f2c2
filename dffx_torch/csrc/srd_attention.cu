// srd_attention_residual: the SRD's focus-axis attention, eval mode.
//
// Replaces the TPU kernel dffx/ops/pallas_kernels.py::srd_attention_residual_cf
// (body _srd_attn_kernel).  Computes
//   out = f + relu(W1 . relu(Wn . [f(n-1); f(n); f(n+1)]))
// where Wn is a bias-free (3,1,1) C -> C conv over the focus axis N with pad 1
// (the neighbours are zero beyond the stack ends) and W1 a bias-free 1x1 C -> C
// conv, for C = 8, 16 and 32.  It is pointwise in space; in and out are
// (B, C, N, H, W).
//
// What bounds it on the card: per pixel and slice it reads and writes C values
// for 4 C^2 multiply-accumulates.  At 1 x 8 x 10 x 608 x 1088 that is 0.126 ms
// of HBM time in fp32 and 0.063 ms in bf16, against 0.021 ms of tensor-core
// time in 3xTF32 and 0.008 ms for the bf16 products below (9 C^2 a pixel and
// slice, at 989 TFLOP/s): device memory bounds it.  The first design
// (one thread a pixel walking all N slices, each of its 4 C^2 FMAs reading its
// weight from shared memory) was bound by instruction throughput instead, the same
// in both dtypes, and ran one block with six live threads at 65,537 slices of
// 2 x 3 pixels.
//
// What the design does about it:
// * Both products run on the tensor cores (mma.sync, mma.cuh).  A warp takes a
//   tile of consecutive flat pixels and a run of S slices: M = pixels, N =
//   output channels, K = 3C (tap, channel) for the first product and C for the
//   second.  fp32 runs m16n8k8 TF32 in the 3xTF32 split; bf16 runs m16n8k16
//   (and k8) bf16 with every fp32 operand split into bf16 hi + lo: f Wh + f Wl,
//   then ah W1h + al W1h + ah W1l.  Accumulators are fp32, so both dtypes
//   compute in fp32 accuracy and bf16 rounds only the output, as the first
//   design did.  Unlike mma.cuh's convs, the small terms share the one
//   accumulator: over K <= 3C the tensor cores' truncated sums cost under
//   1e-6 (4e-7 against the fp32 gate of 1e-4, measured on the card).
// * No value crosses lanes.  Thread (g, t) (g = lane / 4, t = lane % 4) holds,
//   of each 8-channel group kc, channels 8 kc + 2t and 8 kc + 2t + 1 at 2 MT
//   pixel slots a sub-tile (MT = 32 / C m-tiles); slot 2j is row g and slot
//   2j + 1 row g + 8 of m-tile j.  In TF32 the K order of a group puts channel
//   2t at column t and 2t + 1 at t + 4, so the accumulator (c0, c1 = row g,
//   channels 2t, 2t + 1; c2, c3 = row g + 8) is, after the ReLU, the second
//   product's A fragment as {c0, c2, c1, c3}; in bf16 the fragment layouts
//   already agree (a register pairs channels 2t and 2t + 1).  The current
//   slice's registers hold the output fragment's (pixel, channel) pairs, so
//   the residual adds in place.
// * A lane's slots are consecutive pixels in runs of up to 16 bytes, so at
//   C = 8 a warp's every load and store covers 256 contiguous bytes of each
//   channel plane: 64 pixels in fp32, 128 in bf16, which computes its tile as
//   two sub-tiles of 64 in turn (5 % faster at the E2E shape than tiles of 64,
//   whose 128-byte runs the card's memory served more slowly).  Scalar
//   loads where HW is no multiple of the run or a tensor is unaligned.  The
//   wider widths keep one sub-tile (16 and 32 pixels a warp).
// * The weights are packed once, by the wrapper's ParamCache
//   (kernels.py::srd_attention_params: one fp32 buffer, B fragments in this K
//   order, a TF32 hi/lo section and a bf16 hi/lo section), and a block copies
//   its dtype's section to shared memory with 16-byte cp.async.
// * The grid is blocks of 4 warps; a warp takes one (stack, run of S slices,
//   tile) item, reading one halo slice on each side of its run (none beyond
//   the stack).  kernels.py::srd_attention_plan picks S (all N where that
//   already gives two waves of warps, else halved until it does, down to 4)
//   and the block count, and passes both: any B, N, H, W >= 1, with no grid
//   dimension near its limit.
// * Bytes in flight: a ring of four slices in registers (prev, cur, next and
//   one ahead), the loop unrolled by four so that the ring needs no moves;
//   slice n + 2's loads go out before slice n is computed.  Kept over a
//   shared-memory ring: registers take the 16-byte loads straight in fragment
//   order, where shared memory would add a copy and bank-conflicted fragment
//   reads; and deeper rings (2 or 4 slices ahead in bf16, 2 in fp32 at three
//   blocks an SM), loads that skip L1 with streaming stores, and 8-warp blocks
//   each moved the E2E time by under 2 % on the card.
// Measured on an NVIDIA H100 80GB HBM3 (700 W), launches back to back, against
// the first design in the same run (dffx_torch/bench.py --root): at
// 1 x 8 x 10 x 608 x 1088 0.150 ms in fp32 (0.165) and 0.081 in bf16 (0.150),
// where a torch copy of the same bytes takes 0.142 and 0.073; at 65,537
// slices of 2 x 3 pixels 0.054 and 0.068 (36.6 and 35.0).
#include <type_traits>

#include "mma.cuh"

namespace {

using dffx::mma_bf16;
using dffx::mma_bf16_k8;
using dffx::mma_tf32;
using dffx::split_tf32;

constexpr int WARPS = 4;  // a block's warps, each with a work item of its own
constexpr int THREADS = 32 * WARPS;

template <int C, bool BF16>
struct Geo {
  static constexpr int KC = C / 8;      // 8-channel groups: a slice's k-chunks, the n-tiles
  static constexpr int MT = 32 / C;     // m-tiles of a sub-tile: MT x KC = 4 accumulators a product
  // sub-tiles a warp computes in turn: two in bf16 at C = 8 (a 128-pixel tile,
  // 256 bytes a channel plane); at C = 16 and 32 two would spill
  static constexpr int SUB = BF16 && C == 8 ? 2 : 1;
  static constexpr int SSL = 2 * MT;            // pixel slots of a thread in a sub-tile
  static constexpr int SL = SSL * SUB;          // pixel slots of a thread
  static constexpr int TILE = 16 * MT * SUB;    // pixels of a warp
  static constexpr int ESZ = BF16 ? 2 : 4;
  static constexpr int V = SL * ESZ < 16 ? SL : 16 / ESZ;  // slots of one load, up to 16 bytes
  static constexpr int WPC = SL * ESZ / 4;                 // 32-bit words of a channel's slots
  static constexpr int WPV = V * ESZ / 4;                  // words of one load
  // the tile's first pixel in the second sub-tile (lane 0's slot SSL); a
  // sub-tile's slots interleave with the other's where SSL < V
  static constexpr int SUB1_PX = SSL / V * 8 * V + SSL % V;
  static constexpr int P = 1;             // slices in flight beyond the next
  static constexpr int R = P + 3;         // the ring: prev, cur, next and those in flight
  // the packed buffer: [TF32 section: 8 C^2 words][bf16 section: 4 C^2 words]
  static constexpr int WORDS = BF16 ? 4 * C * C : 8 * C * C;
  static constexpr int OFFSET = BF16 ? 8 * C * C : 0;
};

template <int NW>
__device__ __forceinline__ void ldg_words(const void* p, uint32_t* w) {
  if constexpr (NW == 4) {
    const uint4 v = __ldg(static_cast<const uint4*>(p));
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else if constexpr (NW == 2) {
    const uint2 v = __ldg(static_cast<const uint2*>(p));
    w[0] = v.x, w[1] = v.y;
  } else {
    w[0] = __ldg(static_cast<const unsigned int*>(p));
  }
}

template <int NW>
__device__ __forceinline__ void stg_words(void* p, const uint32_t* w) {
  if constexpr (NW == 4) {
    *static_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (NW == 2) {
    *static_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *static_cast<unsigned int*>(p) = w[0];
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float low_bf16(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float high_bf16(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// One channel's slots at one slice into w: slot s is element (s / V) 8V + s % V
// of p, read where that element is below lim (the pixels left in the image
// from the lane's first; 0 for a slice that is not read), else 0.
template <typename T, int C, bool VEC, typename G = Geo<C, std::is_same<T, __nv_bfloat16>::value>>
__device__ __forceinline__ void load_channel(const T* __restrict__ p, int64_t lim,
                                             uint32_t (&w)[G::WPC]) {
#pragma unroll
  for (int q = 0; q < G::SL / G::V; ++q) {
    const int e0 = q * 8 * G::V;
    if constexpr (VEC) {
      if (e0 < lim) {
        ldg_words<G::WPV>(p + e0, &w[q * G::WPV]);
      } else {
#pragma unroll
        for (int k = 0; k < G::WPV; ++k) w[q * G::WPV + k] = 0u;
      }
    } else {
#pragma unroll
      for (int i = 0; i < G::V; ++i) {
        const bool in = e0 + i < lim;
        if constexpr (G::ESZ == 4) {
          w[q * G::V + i] = in ? __ldg(reinterpret_cast<const unsigned int*>(p) + e0 + i) : 0u;
        } else {
          const uint32_t v =
              in ? static_cast<uint32_t>(__ldg(reinterpret_cast<const unsigned short*>(p) + e0 + i))
                 : 0u;
          const int k = (q * G::V + i) / 2;
          w[k] = i % 2 == 0 ? v : w[k] | v << 16;
        }
      }
    }
  }
}

// The inverse for the output: w's slots to p where the element is below lim.
template <typename T, int C, bool VEC, typename G = Geo<C, std::is_same<T, __nv_bfloat16>::value>>
__device__ __forceinline__ void store_channel(T* __restrict__ p, int64_t lim,
                                              const uint32_t (&w)[G::WPC]) {
#pragma unroll
  for (int q = 0; q < G::SL / G::V; ++q) {
    const int e0 = q * 8 * G::V;
    if constexpr (VEC) {
      if (e0 < lim) stg_words<G::WPV>(p + e0, &w[q * G::WPV]);
    } else {
#pragma unroll
      for (int i = 0; i < G::V; ++i) {
        if (e0 + i >= lim) continue;
        if constexpr (G::ESZ == 4) {
          reinterpret_cast<unsigned int*>(p)[e0 + i] = w[q * G::V + i];
        } else {
          reinterpret_cast<unsigned short*>(p)[e0 + i] =
              static_cast<unsigned short>(w[(q * G::V + i) / 2] >> (16 * (i % 2)));
        }
      }
    }
  }
}

// The output words of the sub-tile at slots OFF .. OFF + SSL - 1: a float's
// bits, or two bf16 (the lower slot in the low half).
template <int OFF, bool BF16, typename G>
__device__ __forceinline__ void pack_out(const float (&o)[G::KC][2][G::SL],
                                         uint32_t (&w)[G::KC][2][G::WPC]) {
#pragma unroll
  for (int kc = 0; kc < G::KC; ++kc)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int s = OFF; s < OFF + G::SSL; s += BF16 ? 2 : 1) {
        if constexpr (BF16) {
          w[kc][h][s / 2] = pack_bf16(o[kc][h][s], o[kc][h][s + 1]);
        } else {
          w[kc][h][s] = __float_as_uint(o[kc][h][s]);
        }
      }
}

// acc[j][nb] += A B in 3xTF32 (al bh + ah bl + ah bh; b = {bh0, bh1, bl0, bl1}),
// term by term over the MT x NB accumulators: no MMA waits on the one before
template <int MT, int NB>
__device__ __forceinline__ void products_3xtf32(const uint32_t (&ah)[MT][4],
                                           const uint32_t (&al)[MT][4], const float4 (&b)[NB],
                                           float (&acc)[MT][NB][4]) {
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      mma_tf32(acc[j][nb], al[j], __float_as_uint(b[nb].x), __float_as_uint(b[nb].y));
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      mma_tf32(acc[j][nb], ah[j], __float_as_uint(b[nb].z), __float_as_uint(b[nb].w));
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      mma_tf32(acc[j][nb], ah[j], __float_as_uint(b[nb].x), __float_as_uint(b[nb].y));
}

// One output slice in fp32 from its three input slices, at the sub-tile of
// slots OFF .. OFF + SSL - 1; o[nb][h][s]: channel 8 nb + 2t + h at slot s.
// Weights: [Wn: (dn KC + kc)][W1: kc][n-tile][lane] of float4 {hi0, hi1, lo0, lo1}.
template <int C, int OFF, typename G = Geo<C, false>>
__device__ __forceinline__ void attend(const uint32_t (&prev)[G::KC][2][G::WPC],
                                       const uint32_t (&cur)[G::KC][2][G::WPC],
                                       const uint32_t (&next)[G::KC][2][G::WPC],
                                       const uint32_t* wsm, int lane,
                                       float (&o)[G::KC][2][G::SL]) {
  constexpr int KC = G::KC, MT = G::MT;
  const float4* wb = reinterpret_cast<const float4*>(wsm) + lane;
  float acc[MT][KC][4] = {};
  auto taps = [&](const uint32_t (&s)[KC][2][G::WPC], int dn) {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      // A of m-tile j: (slot 2j, channel 2t), (2j + 1, 2t), (2j, 2t + 1), (2j + 1, 2t + 1)
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int j = 0; j < MT; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          split_tf32(__uint_as_float(s[kc][r / 2][OFF + 2 * j + r % 2]), ah[j][r], al[j][r]);
        }
      }
      float4 b[KC];
#pragma unroll
      for (int nb = 0; nb < KC; ++nb) b[nb] = wb[((dn * KC + kc) * KC + nb) * 32];
      products_3xtf32<MT, KC>(ah, al, b, acc);
    }
  };
  taps(prev, 0);
  taps(cur, 1);
  taps(next, 2);
  float acc2[MT][KC][4] = {};
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    // the ReLU'd accumulators of n-tile kc are the A fragments {c0, c2, c1, c3}
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int j = 0; j < MT; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        split_tf32(fmaxf(acc[j][kc][(r % 2) * 2 + r / 2], 0.f), ah[j][r], al[j][r]);
      }
    }
    float4 b[KC];
#pragma unroll
    for (int nb = 0; nb < KC; ++nb) b[nb] = wb[((3 * KC + kc) * KC + nb) * 32];
    products_3xtf32<MT, KC>(ah, al, b, acc2);
  }
#pragma unroll
  for (int nb = 0; nb < KC; ++nb)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int s = 0; s < G::SSL; ++s)
        o[nb][h][OFF + s] = __uint_as_float(cur[nb][h][OFF + s]) +
                            fmaxf(acc2[s / 2][nb][h + 2 * (s % 2)], 0.f);
}

// The same in bf16.  A register of a slice's chunk kc, m-tile j, row g + 8r
// pairs channels 2t (low half) and 2t + 1 at slot 2j + r.  Weights, per
// product: chunk pairs [q][n-tile][lane] of uint4 {hi(2q), hi(2q + 1),
// lo(2q), lo(2q + 1)}, then an odd last chunk as [n-tile][lane] of uint2
// {hi, lo}; a word packs k = 2t (low half) and 2t + 1 of column g.
template <int NCH, int MT, int NB>
__device__ __forceinline__ void mma_bf16_chunks(const uint32_t (&ah)[NCH][MT][2],
                                                const uint32_t (&al)[NCH][MT][2], bool alo,
                                                const uint32_t* w, int lane,
                                                float (&acc)[MT][NB][4]) {
  const uint4* wq = reinterpret_cast<const uint4*>(w) + lane;
#pragma unroll
  for (int q = 0; q < NCH / 2; ++q) {
    uint4 b[NB];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) b[nb] = wq[(q * NB + nb) * 32];
    uint32_t a[MT][4], l[MT][4];
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      a[j][0] = ah[2 * q][j][0], a[j][1] = ah[2 * q][j][1];
      a[j][2] = ah[2 * q + 1][j][0], a[j][3] = ah[2 * q + 1][j][1];
      l[j][0] = al[2 * q][j][0], l[j][1] = al[2 * q][j][1];
      l[j][2] = al[2 * q + 1][j][0], l[j][3] = al[2 * q + 1][j][1];
    }
    if (alo) {
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) mma_bf16(acc[j][nb], l[j], b[nb].x, b[nb].y);
    }
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) mma_bf16(acc[j][nb], a[j], b[nb].z, b[nb].w);
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) mma_bf16(acc[j][nb], a[j], b[nb].x, b[nb].y);
  }
  if constexpr (NCH % 2 == 1) {
    constexpr int c = NCH - 1;
    const uint2* wt = reinterpret_cast<const uint2*>(w + NCH / 2 * NB * 128) + lane;
    uint2 b[NB];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) b[nb] = wt[nb * 32];
    if (alo) {
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          mma_bf16_k8(acc[j][nb], al[c][j][0], al[c][j][1], b[nb].x);
    }
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) mma_bf16_k8(acc[j][nb], ah[c][j][0], ah[c][j][1], b[nb].y);
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) mma_bf16_k8(acc[j][nb], ah[c][j][0], ah[c][j][1], b[nb].x);
  }
}

template <int C, int OFF, typename G = Geo<C, true>>
__device__ __forceinline__ void attend_bf16(const uint32_t (&prev)[G::KC][2][G::WPC],
                                            const uint32_t (&cur)[G::KC][2][G::WPC],
                                            const uint32_t (&next)[G::KC][2][G::WPC],
                                            const uint32_t* wsm, int lane,
                                            float (&o)[G::KC][2][G::SL]) {
  constexpr int KC = G::KC, MT = G::MT;
  // the first product: K = 3C as 3 KC chunks (tap dn, group kc); f is exact in
  // bf16, so A has no low part and the two products are f Wh + f Wl
  uint32_t a[3 * KC][MT][2];
  auto chunks = [&](const uint32_t (&s)[KC][2][G::WPC], int dn) {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          a[dn * KC + kc][j][r] = __byte_perm(s[kc][0][OFF / 2 + j], s[kc][1][OFF / 2 + j],
                                              r ? 0x7632 : 0x5410);
  };
  chunks(prev, 0);
  chunks(cur, 1);
  chunks(next, 2);
  float acc[MT][KC][4] = {};
  mma_bf16_chunks<3 * KC, MT, KC>(a, a, false, wsm, lane, acc);
  // the second: relu(acc) split into bf16 hi + lo, the accumulators of n-tile
  // kc already in chunk kc's A layout
  uint32_t ah[KC][MT][2], al[KC][MT][2];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
    for (int j = 0; j < MT; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float v0 = fmaxf(acc[j][kc][2 * r], 0.f), v1 = fmaxf(acc[j][kc][2 * r + 1], 0.f);
        const uint32_t hi = pack_bf16(v0, v1);
        ah[kc][j][r] = hi;
        al[kc][j][r] = pack_bf16(v0 - low_bf16(hi), v1 - high_bf16(hi));
      }
    }
  }
  float acc2[MT][KC][4] = {};
  mma_bf16_chunks<KC, MT, KC>(ah, al, true, wsm + 3 * C * C, lane, acc2);
#pragma unroll
  for (int nb = 0; nb < KC; ++nb)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int s = 0; s < G::SSL; ++s) {
        const uint32_t w = cur[nb][h][(OFF + s) / 2];
        o[nb][h][OFF + s] = (s % 2 ? high_bf16(w) : low_bf16(w)) +
                            fmaxf(acc2[s / 2][nb][h + 2 * (s % 2)], 0.f);
      }
}

template <typename T, int C, bool VEC>
__global__ void __launch_bounds__(THREADS, 4)
srd_attention_kernel(const T* __restrict__ f, const float* __restrict__ params,
                     T* __restrict__ y, int N, int64_t hw, int S, int64_t tiles, int64_t chunks,
                     int64_t items) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  using G = Geo<C, BF16>;
  __shared__ __align__(16) uint32_t wsm[G::WORDS];
  for (int i = threadIdx.x; i < G::WORDS / 4; i += THREADS) {
    dffx::cp_async16(reinterpret_cast<float*>(wsm) + 4 * i, params + G::OFFSET + 4 * i);
  }
  dffx::cp_async_wait_all();
  __syncthreads();

  // the warp's item: stack b, slices n0 .. n0 + count - 1, pixels of the tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t item = static_cast<int64_t>(blockIdx.x) * WARPS + warp;
  if (item >= items) return;
  const int64_t tile = item % tiles, rest = item / tiles;
  const int n0 = static_cast<int>(rest % chunks) * S;
  const int64_t b = rest / chunks;
  const int count = min(S, N - n0);
  const int g = lane / 4, t = lane % 4;
  const int64_t px = tile * G::TILE + g * G::V;  // the lane's first pixel
  const int64_t lim = hw - px;                     // pixels left from it
  const int64_t cstride = static_cast<int64_t>(N) * hw;
  const int64_t base = (b * C + 2 * t) * cstride + px;  // channel 2t, slice 0
  // in bf16 the second sub-tile is computed only where it has a pixel
  const bool second = tile * G::TILE + G::SUB1_PX < hw;

  // ring slot k holds slice n0 - 1 + k (mod R); slices outside the stack or
  // past the run's halo are zeros and not read
  uint32_t ring[G::R][G::KC][2][G::WPC];
  auto load = [&](uint32_t (&s)[G::KC][2][G::WPC], int m) {
    const bool on = m >= 0 && m < N && m <= n0 + count;
    const T* at = f + base + static_cast<int64_t>(m) * hw;
#pragma unroll
    for (int kc = 0; kc < G::KC; ++kc)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        load_channel<T, C, VEC>(at + (8 * kc + h) * cstride, on ? lim : 0, s[kc][h]);
  };
#pragma unroll
  for (int k = 0; k < G::R - 1; ++k) load(ring[k], n0 - 1 + k);

#pragma unroll 1
  for (int i0 = 0; i0 < count; i0 += G::R) {
#pragma unroll
    for (int ph = 0; ph < G::R; ++ph) {
      if (i0 + ph < count) {
        const int n = n0 + i0 + ph;
        // keeps the weights' shared-memory reads inside the loop: hoisted, the
        // wider widths' fragments would take more registers than a thread has
        asm volatile("" ::: "memory");
        load(ring[(ph + G::R - 1) % G::R], n + G::P + 1);
        const auto& prev = ring[ph];
        const auto& cur = ring[(ph + 1) % G::R];
        const auto& next = ring[(ph + 2) % G::R];
        float o[G::KC][2][G::SL];
        uint32_t w[G::KC][2][G::WPC];
        if constexpr (BF16) {
          attend_bf16<C, 0>(prev, cur, next, wsm, lane, o);
        } else {
          attend<C, 0>(prev, cur, next, wsm, lane, o);
        }
        pack_out<0, BF16, G>(o, w);
        if constexpr (G::SUB > 1) {
          if (second) {
            // the weights again from shared memory: kept from the first
            // sub-tile, the wider widths' fragments would spill
            asm volatile("" ::: "memory");
            attend_bf16<C, G::SSL>(prev, cur, next, wsm, lane, o);
            pack_out<G::SSL, BF16, G>(o, w);
          }
        }
        T* at = y + base + static_cast<int64_t>(n) * hw;
#pragma unroll
        for (int kc = 0; kc < G::KC; ++kc)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            store_channel<T, C, VEC>(at + (8 * kc + h) * cstride, lim, w[kc][h]);
      }
    }
  }
}

template <typename T, int C>
cudaError_t launch(const void* f, const void* params, void* y, int B, int N, int64_t hw, int S,
                   int blocks, cudaStream_t stream) {
  using G = Geo<C, std::is_same<T, __nv_bfloat16>::value>;
  if (S < 1 || blocks < 1) return cudaErrorInvalidValue;
  const int64_t tiles = (hw + G::TILE - 1) / G::TILE, chunks = (N + S - 1) / S;
  const int64_t items = static_cast<int64_t>(B) * chunks * tiles;
  // the plan's block count must cover every item, with no block left idle
  if ((items + WARPS - 1) / WARPS != blocks) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(params) % 16 != 0) return cudaErrorMisalignedAddress;
  const int align = G::V * G::ESZ;
  const bool vec = hw % G::V == 0 && reinterpret_cast<uintptr_t>(f) % align == 0 &&
                   reinterpret_cast<uintptr_t>(y) % align == 0;
  auto args = [&](auto kernel) {
    kernel<<<blocks, THREADS, 0, stream>>>(static_cast<const T*>(f),
                                            static_cast<const float*>(params),
                                            static_cast<T*>(y), N, hw, S, tiles, chunks, items);
  };
  if (vec) {
    args(srd_attention_kernel<T, C, true>);
  } else {
    args(srd_attention_kernel<T, C, false>);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_c(int C, const void* f, const void* params, void* y, int B, int N,
                       int64_t hw, int S, int blocks, cudaStream_t stream) {
  switch (C) {
    case 8: return launch<T, 8>(f, params, y, B, N, hw, S, blocks, stream);
    case 16: return launch<T, 16>(f, params, y, B, N, hw, S, blocks, stream);
    case 32: return launch<T, 32>(f, params, y, B, N, hw, S, blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// params: kernels.py::srd_attention_params; slices (S) and blocks:
// kernels.py::srd_attention_plan.  Returns the launch's cudaError_t (0 on success).
extern "C" int dffx_srd_attention_residual(const void* f, const void* params, void* y, int B,
                                           int C, int N, int H, int W, int slices, int blocks,
                                           int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t hw = static_cast<int64_t>(H) * W;
  if (dtype == DFFX_DTYPE_F32) {
    return dispatch_c<float>(C, f, params, y, B, N, hw, slices, blocks, s);
  }
  if (dtype == DFFX_DTYPE_BF16) {
    return dispatch_c<__nv_bfloat16>(C, f, params, y, B, N, hw, slices, blocks, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
