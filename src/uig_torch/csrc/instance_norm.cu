// Instance norm forward over NHWC fp32 or bf16: per-(example, channel)
// moments over H*W, normalize, affine, optional fused ReLU.
//
// Replaces: src/uig/kernels/norm_pallas.py, _fwd_impl -> _in_fwd_kernel (the
// TPU kernel keeps one example's whole plane resident in VMEM and reads it
// once; in bf16 it takes fp32 moments of the bf16 values and rounds y once).
//
// Bound on this card: bytes. The kernel must read x once and write y once:
// at (8, 256, 256, 64) fp32 that is 2 x 134 MB, about 80 us at the H100 SXM
// data-sheet 3.35 TB/s (700 W); half that in bf16. The arithmetic is a few
// operations a byte.
//
// Design: a 256^2 x 64 fp32 plane is 16 MiB, far beyond a block's 227 KB of
// shared memory, so the plane cannot stay resident and the norm takes two
// passes over x:
//   (a) in_partials_kernel: blocks over (HW chunk, 32-channel tile, b) sum x
//       and x^2 in fp32. A warp reads 32 neighbouring channels of one pixel
//       (coalesced). Each block writes its per-chunk partials to a
//       (2, B, chunks, C) scratch; no float atomics, so the result is
//       bit-stable from run to run.
//   (b) in_common.cuh: one thread per (b, c) reduces the partials in chunk
//       order into scale/shift (keeping mean and 1/sqrt(var + eps) for the
//       backward), then a 4-wide elementwise pass writes y.
// x is read twice (3 x 134 MB in all at the largest fp32 shape); the second
// read partly hits the 50 MB L2 at the smaller planes.
#include <cuda_runtime.h>

#include "in_common.cuh"

namespace {

template <typename T>
cudaError_t fwd(const void* x, const float* gamma, const float* beta, void* y,
                float* part, float* ss, int B, int HW, int C, int chunks,
                int rows_per_chunk, float eps, int relu, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const dim3 grid(chunks, (C + kCT - 1) / kCT, B);
  in_partials_kernel<T><<<grid, dim3(kCT, kRows), 0, stream>>>(
      xt, part, B, HW, C, chunks, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return in_finalize_apply<T>(part, gamma, beta, ss, xt, static_cast<T*>(y),
                              B, HW, C, chunks, eps, relu, stream);
}

}  // namespace

// x, y: (B, HW, C) fp32, or bf16 when is_bf16; C % 4 == 0. gamma, beta:
// (C,) fp32. part: (2, B, chunks, C) fp32 scratch; ss: (4, B, C) fp32:
// scale and shift, then the statistics mean and 1/sqrt(var + eps) that the
// backward takes. chunks * rows_per_chunk >= HW.
extern "C" cudaError_t uig_instance_norm_fwd(const void* x,
                                             const float* gamma,
                                             const float* beta, void* y,
                                             float* part, float* ss, int B,
                                             int HW, int C, int chunks,
                                             int rows_per_chunk, float eps,
                                             int relu, int is_bf16,
                                             cudaStream_t stream) {
  return is_bf16 ? fwd<bf16>(x, gamma, beta, y, part, ss, B, HW, C, chunks,
                             rows_per_chunk, eps, relu, stream)
                 : fwd<float>(x, gamma, beta, y, part, ss, B, HW, C, chunks,
                              rows_per_chunk, eps, relu, stream);
}

extern "C" const char* uig_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
