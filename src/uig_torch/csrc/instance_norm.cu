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

namespace {

constexpr int kCT = 32;    // channels per block (threadIdx.x)
constexpr int kRows = 8;   // pixel lanes per block (threadIdx.y)

__global__ void __launch_bounds__(kCT * kRows)
    in_partials_kernel(const float* __restrict__ x, float* __restrict__ part,
                       int B, int HW, int C, int chunks, int rows_per_chunk) {
  const int c = blockIdx.y * kCT + threadIdx.x;
  const int b = blockIdx.z;
  const int chunk = blockIdx.x;
  const int p0 = chunk * rows_per_chunk;
  const int p1 = min(p0 + rows_per_chunk, HW);
  float s1 = 0.f, s2 = 0.f;
  if (c < C) {
    const float* xb = x + (size_t)b * HW * C + c;
    for (int p = p0 + threadIdx.y; p < p1; p += kRows) {
      const float v = xb[(size_t)p * C];
      s1 += v;
      s2 += v * v;
    }
  }
  __shared__ float r1[kRows][kCT + 1];
  __shared__ float r2[kRows][kCT + 1];
  r1[threadIdx.y][threadIdx.x] = s1;
  r2[threadIdx.y][threadIdx.x] = s2;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      t1 += r1[j][threadIdx.x];
      t2 += r2[j][threadIdx.x];
    }
    const size_t o = ((size_t)b * chunks + chunk) * C + c;
    part[o] = t1;
    part[(size_t)B * chunks * C + o] = t2;
  }
}

}  // namespace

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
