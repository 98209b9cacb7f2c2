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
// start from the staged tile's centre.  bf16 rounds only the output.  The
// slice is part of the tile index, not a grid dimension: any B * N.
// Measured on the H100 (700 W), kernel alone, against the first design in the
// same run: 0.53 ms at 1 x 8 x 10 x 608 x 1088 in fp32 (0.87-0.89), 0.50 in bf16
// (0.89-0.91), 0.13 at 1 x 8 x 10 x 384 x 384 (0.21-0.22): 95 TFLOP/s of TF32
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
#include "res_block.cuh"

namespace {

// res_block.cuh's block with the identity shortcut (no projection), its input
// tile staged from column tw0 - 4: <T, C, tile height, warps, blocks per SM, ...>
constexpr bool PROJ = false;
constexpr int XO = 4;

template <typename T>
cudaError_t dispatch_c(int C, const void* x, const void* params, void* y, int B, int N, int H,
                       int W, cudaStream_t stream) {
  using dffx::launch_res_block;
  switch (C) {
    case 8: return launch_res_block<T, 8, 16, 8, 2, PROJ, XO>(x, params, y, B, N, H, W, stream);
    case 16: return launch_res_block<T, 16, 16, 8, 2, PROJ, XO>(x, params, y, B, N, H, W, stream);
    case 32: return launch_res_block<T, 32, 8, 8, 1, PROJ, XO>(x, params, y, B, N, H, W, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).
extern "C" int dffx_rb2d_residual(const void* x, const void* params, void* y, int B, int C,
                                  int N, int H, int W, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DFFX_DTYPE_F32) return dispatch_c<float>(C, x, params, y, B, N, H, W, s);
  if (dtype == DFFX_DTYPE_BF16) {
    return dispatch_c<__nv_bfloat16>(C, x, params, y, B, N, H, W, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
