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
#include "bf16_res_block.cuh"
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
    case 8: return launch_res_block<8, 16, 8, 2, PROJ, XO>(x, params, y, B, N, H, W, stream);
    case 16: return launch_res_block<16, 16, 8, 2, PROJ, XO>(x, params, y, B, N, H, W, stream);
    case 32: return launch_res_block<32, 8, 8, 1, PROJ, XO>(x, params, y, B, N, H, W, stream);
    default: return cudaErrorInvalidValue;
  }
}

// bf16: the block of bf16_res_block.cuh with the identity shortcut,
// <C, tile height, warps, blocks per SM, no projection>
cudaError_t dispatch_bf16(int C, const void* x, const void* params, void* y, int B, int N, int H,
                          int W, cudaStream_t stream) {
  using dffx::launch_bf16_res_block;
  switch (C) {
    case 8: return launch_bf16_res_block<8, 32, 8, 2, false>(x, params, y, B, N, H, W, stream);
    case 16: return launch_bf16_res_block<16, 16, 8, 2, false>(x, params, y, B, N, H, W, stream);
    case 32: return launch_bf16_res_block<32, 8, 8, 1, false>(x, params, y, B, N, H, W, stream);
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
