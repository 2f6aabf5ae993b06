// Direct 7x7 stride-1 pad-3 conv (reflect or zeros) + bias over NHWC fp32
// or bf16, for few output channels (the generator head, Cin 64 -> Cout 3):
// the entry point.
//
// Replaces: src/uig/kernels/conv_pallas.py, _conv5_impl -> _conv5_kernel with
// _assemble_mirror, as reached from conv7_s2d via conv_core5 (on the TPU the
// conv is re-expressed in a space-to-depth "free view" so that the matrix
// unit's lanes fill; that trick buys nothing here and is not carried over).
//
// Bound on this card: at (16, 256, 256, 64) -> 3 the conv is 19.7 GFLOP.
// fp32, in the three-term TF32 split (3 TF32 products each at 495 TFLOP/s,
// H100 SXM data sheet, 700 W): 0.120 ms, by operations. bf16 (x, w and the
// bias already rounded to bf16, as JAX's PadConv casts them; 989 TFLOP/s):
// 0.020 ms, under the x read's 0.040 ms at 3.35 TB/s, by bytes.
//
// Two designs, chosen by the storage type, both with the 7 horizontal taps
// folded into N and a column shift-sum in fp32:
//   - fp32: mma.sync m16n8k8 tf32 in the three-term split, each warp
//     keeping the sums of 7 pending output rows, csrc/conv7_tf32.cu;
//   - bf16: mma.sync m16n8k16 on the exact bf16 products, a ring of 8
//     source rows, csrc/conv7_tc.cu.
// The earlier FMA kernel (one thread a pixel) is gone from the source.
#include <cuda_runtime.h>

// csrc/conv7_tf32.cu (fp32) and csrc/conv7_tc.cu (bf16).
cudaError_t conv7_fwd_tf32(const void* x, const void* w, const void* bias,
                           void* y, int B, int H, int W, int Cin, int Cout,
                           int reflect, cudaStream_t stream);
cudaError_t conv7_fwd_bf16_mma(const void* x, const void* w, const void* bias,
                               void* y, int B, int H, int W, int Cin,
                               int Cout, int reflect, cudaStream_t stream);

// x: (B, H, W, Cin); w: HWIO (7, 7, Cin, Cout), 1 <= Cout <= 4; bias:
// (Cout,); y: (B, H, W, Cout); all fp32 (tf32 split; any Cin whose block
// fits, MAX_CIN_FP32 in kernels/conv.py), or all bf16 when is_bf16 (Cin %
// 4 == 0, Cin <= 256). Reflect needs H, W >= 4.
extern "C" cudaError_t uig_conv7_fwd(const void* x, const void* w,
                                     const void* bias, void* y, int B, int H,
                                     int W, int Cin, int Cout, int reflect,
                                     int is_bf16, cudaStream_t stream) {
  return is_bf16 ? conv7_fwd_bf16_mma(x, w, bias, y, B, H, W, Cin, Cout,
                                      reflect, stream)
                 : conv7_fwd_tf32(x, w, bias, y, B, H, W, Cin, Cout, reflect,
                                  stream);
}
