// Fused 3x3 stride-1 pad-1 conv (reflect or zeros) + bias + instance norm
// (+ReLU) over NHWC fp32 or bf16, for the generator's residual trunk: the
// entry point of K3.
//
// Replaces: src/uig/kernels/convin_pallas.py, _convin_fwd_impl ->
// _convin_kernel (the TPU kernel keeps one example's padded plane resident in
// VMEM, runs the conv as im2col strips on the matrix unit, accumulates the
// channel moments from the values it just produced, then normalizes). In
// bf16 the conv accumulates in fp32, acc + bias is rounded once to bf16 for
// y_conv, and the moments come from those rounded values, as there.
//
// Bound on this card: operations. At (8, 64, 64, 256) -> 256 the conv is
// 38.7 GFLOP, while its ~70 MB of reads and writes take about 20 us at
// 3.35 TB/s (H100 SXM data sheet, 700 W). Both storage types run the conv on
// the tensor cores:
//   - fp32 (csrc/conv3_in_tf32.cu): the serving path and the fp32 step are
//     fp32 at "highest" precision, so the products run in the three-term
//     TF32 split (csrc/tf32.cuh: hi and lo of each operand, three products,
//     fp32 sums), which keeps fp32's order of error; plain single-pass TF32
//     would not, and is not used. Bound on the split's basis: 3 x 38.7
//     GFLOP at 495 TFLOP/s dense TF32, 0.235 ms (on fp32 FMAs at 67
//     TFLOP/s the same conv takes 0.58 ms).
//   - bf16 (csrc/conv3_in_tc.cu): bf16 products, exact in fp32, 0.039 ms at
//     989 TFLOP/s.
// Both write the per-tile moment partials (2, B, tiles, F) in a fixed order
// and share in_common.cuh's finalize, which reduces them in tile order and
// normalizes y_conv into y. No float atomics: repeats are bit-equal.
#include <cuda_runtime.h>

#include "dtype.cuh"

cudaError_t conv3_in_fwd_tf32(const float* x, const float* w, float* wt,
                              const float* bias, const float* gamma,
                              const float* beta, float* yconv, float* y,
                              float* part, float* ss, int B, int H, int W,
                              int C, int F, int reflect, int relu, float eps,
                              cudaStream_t stream);
cudaError_t conv3_in_fwd_bf16_wgmma(const void* x, const void* w,
                                    const float* bias, const float* gamma,
                                    const float* beta, void* yconv, void* y,
                                    float* part, float* ss, int B, int H,
                                    int W, int C, int F, int reflect,
                                    int relu, float eps, cudaStream_t stream);

// x: (B, H, W, C), w: (9C, F) from HWIO (3, 3, C, F), yconv, y: (B, H, W,
// F), all fp32, or all bf16 when is_bf16. wt: in fp32, a (2, F, 9 Cp) fp32
// scratch for the weight's hi/lo planes, Cp = C rounded up to 32 (unused in
// bf16). bias/gamma/beta (F,) fp32. part: (2, B, tiles, F) fp32 with tiles
// = ceil(H*W / 128); ss: (4, B, F) fp32, which keeps the forward's mean and
// 1/sqrt(var + eps) in planes 2 and 3. C % 4 == 0, F % 4 == 0.
extern "C" cudaError_t uig_conv3_in_fwd(const void* x, const void* w,
                                        float* wt, const float* bias,
                                        const float* gamma, const float* beta,
                                        void* yconv, void* y, float* part,
                                        float* ss, int B, int H, int W, int C,
                                        int F, int reflect, int relu,
                                        float eps, int is_bf16,
                                        cudaStream_t stream) {
  if (is_bf16)
    return conv3_in_fwd_bf16_wgmma(x, w, bias, gamma, beta, yconv, y, part,
                                   ss, B, H, W, C, F, reflect, relu, eps,
                                   stream);
  return conv3_in_fwd_tf32(static_cast<const float*>(x),
                           static_cast<const float*>(w), wt, bias, gamma,
                           beta, static_cast<float*>(yconv),
                           static_cast<float*>(y), part, ss, B, H, W, C, F,
                           reflect, relu, eps, stream);
}
