// Square k x k conv with zero padding and a stride, over NHWC fp32 or bf16,
// with its input and weight gradients: the generator's 3x3 stride-2 pad-1
// downsamples (d128: 64 -> 128 channels at 256^2, d256: 128 -> 256 at
// 128^2), and with stride 1 and no padding the generic VALID conv.
//   fwd:   x (B, H, W, C), w (k, k, C, F) [+ bias (F,)] -> y (B, Ho, Wo, F)
//   dgrad: dy (B, Ho, Wo, F), w (k, k, C, F) -> dx (B, H, W, C)
//   wgrad: x, dy -> dw (k, k, C, F)
// with Ho = (H + 2 pad - k) / stride + 1.
//
// Replaces: src/uig/kernels/conv_pallas.py, conv3s2_s2d (kc=2, bi=2, bo=1)
// and conv_core (kc=k, bi=bo=1), both through conv_core5 -> _make_conv5 ->
// _conv5_impl -> _conv5_kernel; the backward's _conv5_impl on the padded dy
// with _dgrad_weights, and _wgrad5_impl -> _wgrad5_kernel. On the TPU the
// stride is folded into a space-to-depth 5-D view so that the matrix unit's
// lanes fill; here the stride is index arithmetic in the loaders, and no
// padded or space-to-depth tensor is ever materialized.
//
// Bound on this card: d128 and d256 at batch 16 are each 2 * 16 * 128^2 *
// 128 * 9 * 64 = 3.87e10 FLOP (forward, dgrad and wgrad alike): 0.58 ms at the
// H100 SXM data-sheet 67 TFLOP/s fp32 FMA rate (700 W), 0.2345 ms as three
// TF32 products at 495 TFLOP/s, 0.039 ms at the 989 TFLOP/s bf16 rate.
//
// Two designs, chosen by the storage type:
//   - bf16, all three: the tensor cores (wgmma, fp32 accumulators),
//     csrc/conv3s2_tc.cu;
//   - fp32, all three (the training step's and the serving path's, whose
//     fp32 products must keep fp32's order of error): the tensor cores in
//     the three-term TF32 split ("tf32x3"), csrc/conv3s2_tf32.cu.
// This file holds the entry points and the reduce pass of every weight
// gradient: the weight gradients' first passes write fp32 partials
// (chunks, k k C, F) over ordered pixel chunks, and the reduce sums them in
// chunk order and rounds once to T, as K4w does. No atomics: repeat runs
// give the same bits.
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

// dw[e] = sum over chunks, in order, of part[chunk][e], rounded once to T.
template <typename T>
__global__ void conv_wgrad_reduce_kernel(const float* __restrict__ part,
                                         T* __restrict__ dw, int n,
                                         int chunks) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int z = 0; z < chunks; ++z) s += part[(size_t)z * n + e];
  dw[e] = from_f32<T>(s);
}

bool bad_shape(int C, int F, int k, int stride, int pad) {
  return C % 4 || F % 4 || k < 1 || k > 7 || stride < 1 || pad < 0;
}

template <typename T>
cudaError_t wgrad_reduce(const float* part, void* dw, int n, int chunks,
                         cudaStream_t stream) {
  conv_wgrad_reduce_kernel<T><<<(n + 255) / 256, 256, 0, stream>>>(
      part, static_cast<T*>(dw), n, chunks);
  return cudaGetLastError();
}

}  // namespace

// The tensor-core kernels of csrc/conv3s2_tc.cu (bf16) and
// csrc/conv3s2_tf32.cu (fp32).
cudaError_t conv_fwd_bf16_wgmma(const void* x, const void* w,
                                const void* bias, void* y, int B, int H,
                                int W, int C, int F, int k, int stride,
                                int pad, cudaStream_t stream);
cudaError_t conv_wgrad_bf16_wgmma(const void* x, const void* dy, float* part,
                                  int B, int H, int W, int C, int F, int k,
                                  int stride, int pad, int chunks,
                                  int per_chunk, cudaStream_t stream);
cudaError_t conv_dgrad_bf16_wgmma(const void* dy, const void* wt, void* dx,
                                  int B, int H, int W, int C, int F, int k,
                                  int stride, int pad, cudaStream_t stream);
cudaError_t conv_fwd_fp32_tf32(const void* x, const void* w, float* ws,
                               const void* bias, void* y, int B, int H,
                               int W, int C, int F, int k, int stride,
                               int pad, cudaStream_t stream);
cudaError_t conv_dgrad_fp32_tf32(const void* dy, const void* w, float* ws,
                                 void* dx, int B, int H, int W, int C, int F,
                                 int k, int stride, int pad,
                                 cudaStream_t stream);
cudaError_t conv_wgrad_fp32_tf32(const void* x, const void* dy, float* part,
                                 int B, int H, int W, int C, int F, int k,
                                 int stride, int pad, int chunks,
                                 int per_chunk, cudaStream_t stream);

// x: (B, H, W, C); w: HWIO (k, k, C, F) = a (k k C, F) matrix; bias: (F,)
// or null; y: (B, Ho, Wo, F). fp32 (tf32x3): ws a (2, F, k k Cp) fp32
// scratch for W^T's split planes, Cp = C rounded up to 32. bf16 when
// is_bf16 (wgmma): ws null. C % 4 == 0, F % 4 == 0, k <= 7.
extern "C" cudaError_t uig_conv_fwd(const void* x, const void* w, float* ws,
                                    const void* bias, void* y, int B, int H,
                                    int W, int C, int F, int k, int stride,
                                    int pad, int is_bf16,
                                    cudaStream_t stream) {
  if (bad_shape(C, F, k, stride, pad)) return cudaErrorInvalidValue;
  if (is_bf16)
    return conv_fwd_bf16_wgmma(x, w, bias, y, B, H, W, C, F, k, stride, pad,
                               stream);
  if (ws == nullptr) return cudaErrorInvalidValue;
  return conv_fwd_fp32_tf32(x, w, ws, bias, y, B, H, W, C, F, k, stride, pad,
                            stream);
}

// dy: (B, Ho, Wo, F); dx: (B, H, W, C). fp32 (tf32x3): w is the forward's
// HWIO (k, k, C, F) and ws a (2, k k C, Fp) fp32 scratch for its split
// planes, Fp = F rounded up to 32. bf16 when is_bf16 (wgmma): w is wt (k,
// k, F, C), the forward's w with its last two axes swapped, and ws null.
extern "C" cudaError_t uig_conv_dgrad(const void* dy, const void* w,
                                      float* ws, void* dx, int B, int H,
                                      int W, int C, int F, int k, int stride,
                                      int pad, int is_bf16,
                                      cudaStream_t stream) {
  if (bad_shape(C, F, k, stride, pad)) return cudaErrorInvalidValue;
  if (is_bf16)
    return conv_dgrad_bf16_wgmma(dy, w, dx, B, H, W, C, F, k, stride, pad,
                                 stream);
  if (ws == nullptr) return cudaErrorInvalidValue;
  return conv_dgrad_fp32_tf32(dy, w, ws, dx, B, H, W, C, F, k, stride, pad,
                              stream);
}

// x: (B, H, W, C), dy: (B, Ho, Wo, F), dw: (k, k, C, F); all fp32
// (tf32x3), or all bf16 (wgmma). part: (chunks, k k C, F) fp32 scratch with
// chunks * per_chunk >= B Ho Wo, the chunking of conv_s2._wgrad_chunks for
// the type's stages.
extern "C" cudaError_t uig_conv_wgrad(const void* x, const void* dy,
                                      float* part, void* dw, int B, int H,
                                      int W, int C, int F, int k, int stride,
                                      int pad, int chunks, int per_chunk,
                                      int is_bf16, cudaStream_t stream) {
  if (bad_shape(C, F, k, stride, pad)) return cudaErrorInvalidValue;
  const cudaError_t err =
      is_bf16 ? conv_wgrad_bf16_wgmma(x, dy, part, B, H, W, C, F, k, stride,
                                      pad, chunks, per_chunk, stream)
              : conv_wgrad_fp32_tf32(x, dy, part, B, H, W, C, F, k, stride,
                                     pad, chunks, per_chunk, stream);
  if (err != cudaSuccess) return err;
  const int n = k * k * C * F;
  return is_bf16 ? wgrad_reduce<bf16>(part, dw, n, chunks, stream)
                 : wgrad_reduce<float>(part, dw, n, chunks, stream);
}
