// Instance norm forward over NHWC fp32: per-(example, channel) moments over
// H*W, normalize, affine, optional fused ReLU.
//
// Replaces: src/uig/kernels/norm_pallas.py, _fwd_impl -> _in_fwd_kernel (the
// TPU kernel keeps one example's whole plane resident in VMEM and reads it
// once).
//
// Bound on this card: bytes. The kernel must read x once and write y once:
// at (8, 256, 256, 64) fp32 that is 2 x 134 MB, about 80 us at the H100 SXM
// data-sheet 3.35 TB/s (700 W). The arithmetic is a few operations a byte.
//
// Design: a 256^2 x 64 fp32 plane is 16 MiB, far beyond a block's 227 KB of
// shared memory, so the plane cannot stay resident and the norm takes two
// passes over x:
//   (a) in_partials_kernel: blocks over (HW chunk, 32-channel tile, b) sum x
//       and x^2 in fp32. A warp reads 32 neighbouring channels of one pixel
//       (128 coalesced bytes). Each block writes its per-chunk partials to a
//       (2, B, chunks, C) scratch; no float atomics, so the result is
//       bit-stable from run to run.
//   (b) in_common.cuh: one thread per (b, c) reduces the partials in chunk
//       order into scale/shift, then a float4 elementwise pass writes y.
// x is read twice (3 x 134 MB in all at the largest shape); the second read
// partly hits the 50 MB L2 at the smaller planes.
#include <cuda_runtime.h>

#include "in_common.cuh"

// x, y: (B, HW, C) fp32, C % 4 == 0. gamma, beta: (C,). part: (2, B, chunks,
// C) scratch; ss: (2, B, C) scratch. chunks * rows_per_chunk >= HW.
extern "C" cudaError_t uig_instance_norm_fwd(const float* x,
                                             const float* gamma,
                                             const float* beta, float* y,
                                             float* part, float* ss, int B,
                                             int HW, int C, int chunks,
                                             int rows_per_chunk, float eps,
                                             int relu, cudaStream_t stream) {
  const dim3 grid(chunks, (C + kCT - 1) / kCT, B);
  in_partials_kernel<<<grid, dim3(kCT, kRows), 0, stream>>>(
      x, part, B, HW, C, chunks, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return in_finalize_apply(part, gamma, beta, ss, x, y, B, HW, C, chunks, eps,
                           relu, stream);
}

extern "C" const char* uig_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
