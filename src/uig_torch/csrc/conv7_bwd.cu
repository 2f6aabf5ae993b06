// Entry points of the backward of the 7x7 stride-1 pad-3 conv (reflect or
// zeros) over NHWC fp32 or bf16 for few output channels (the generator
// head, Cin 64 -> Cout 3):
//   dgrad: dy (B, H, W, Cout), w (7, 7, Cin, Cout) -> dx (B, H, W, Cin)
//   wgrad: x (B, H, W, Cin), dy (B, H, W, Cout) -> dw (7, 7, Cin, Cout)
//
// Replaces: src/uig/kernels/conv_pallas.py, _conv5_impl with fold=True (the
// dgrad: a full correlation of the padded dy with flipped weights, then
// _fold_block adds the gradient of the reflect ring onto its mirrored
// sources in VMEM) and _wgrad5_impl -> _wgrad5_kernel (patch^T . dy
// accumulated across the sequential grid into a VMEM-resident block).
//
// Bound on this card: operations, for both in fp32 (the three-term TF32
// split: 2 * B * H * W * 49 * Cin * Cout FLOP, three TF32 products each at
// 495 TFLOP/s, 0.060 ms at B = 8 and 256^2); bytes for both in bf16 (the
// dgrad's dx write or the wgrad's x read, 67 MB at B = 8, 0.020 ms at 3.35
// TB/s).
//
// Every design runs on the tensor cores, one source each:
//   - dgrad fp32: csrc/conv7_bwd_tf32.cu (wgmma m64n64k8 tf32 in the split,
//     A from registers read off a dy halo, the reflect ring as extra K
//     passes);
//   - dgrad bf16: csrc/conv7_bwd_tc.cu (wgmma m64n64k16, A built by the
//     threads from a dy halo);
//   - wgrad fp32: csrc/conv7_wgrad_tf32.cu (wgmma m64n56k8 tf32 in the
//     split at Cout 3: all 49 taps folded into N, one GEMM a padded row, A
//     split in registers, B from staged pre-split dy rows, persistent
//     blocks with ordered partials);
//   - wgrad bf16: csrc/conv7_wgrad_tc.cu (wgmma m64nNk16, kx folded into N,
//     a ring of source rows as MN-major A).
// Each sums in fp32 in a fixed order with no atomics, and rounds once to
// the storage type: repeats are bit-equal.
#include <cuda_runtime.h>

// csrc/conv7_bwd_tf32.cu and csrc/conv7_bwd_tc.cu
cudaError_t conv7_dgrad_fp32_tf32(const void* dy, const void* w, void* dx,
                                  int B, int H, int W, int Cin, int Cout,
                                  int reflect, cudaStream_t stream);
cudaError_t conv7_dgrad_bf16_wgmma(const void* dy, const void* w, void* dx,
                                   int B, int H, int W, int Cin, int Cout,
                                   int reflect, cudaStream_t stream);
// csrc/conv7_wgrad_tf32.cu and csrc/conv7_wgrad_tc.cu
cudaError_t conv7_wgrad_fp32_tf32(const void* x, const void* dy, float* part,
                                  void* dw, int B, int H, int W, int Cin,
                                  int Cout, int reflect, int chunks,
                                  cudaStream_t stream);
cudaError_t conv7_wgrad_bf16_wgmma(const void* x, const void* dy, float* part,
                                   void* dw, int B, int H, int W, int Cin,
                                   int Cout, int reflect, int chunks,
                                   cudaStream_t stream);

// dy: (B, H, W, Cout), w: HWIO (7, 7, Cin, Cout), dx: (B, H, W, Cin); all
// fp32, or all bf16 when is_bf16. 1 <= Cout <= 4; reflect needs H, W >= 4;
// fp32 takes any Cin, bf16 Cin % 4 == 0.
extern "C" cudaError_t uig_conv7_dgrad(const void* dy, const void* w,
                                       void* dx, int B, int H, int W,
                                       int Cin, int Cout, int reflect,
                                       int is_bf16, cudaStream_t stream) {
  if (Cout < 1 || Cout > 4) return cudaErrorInvalidValue;
  return is_bf16 ? conv7_dgrad_bf16_wgmma(dy, w, dx, B, H, W, Cin, Cout,
                                          reflect, stream)
                 : conv7_dgrad_fp32_tf32(dy, w, dx, B, H, W, Cin, Cout,
                                         reflect, stream);
}

// x: (B, H, W, Cin), dy: (B, H, W, Cout), dw: (7, 7, Cin, Cout); part:
// (chunks, 49, Cin, Cout) fp32 scratch, chunks >= 1 persistent blocks a
// 64-channel slice, whose partials a second kernel sums in block order.
// All fp32 (any Cin), or all bf16 when is_bf16 (Cin % 4 == 0, Cin <= 256).
extern "C" cudaError_t uig_conv7_wgrad(const void* x, const void* dy,
                                       float* part, void* dw, int B, int H,
                                       int W, int Cin, int Cout, int reflect,
                                       int chunks, int is_bf16,
                                       cudaStream_t stream) {
  return is_bf16 ? conv7_wgrad_bf16_wgmma(x, dy, part, dw, B, H, W, Cin, Cout,
                                          reflect, chunks, stream)
                 : conv7_wgrad_fp32_tf32(x, dy, part, dw, B, H, W, Cin, Cout,
                                         reflect, chunks, stream);
}
