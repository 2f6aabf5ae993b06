// Random crop + optional left-right flip + normalize to [-1, 1]: uint8 NHWC
// (B, H, W, C) -> fp32 NHWC (B, crop, crop, C), with the per-example offsets
// and flips given as a (B, 3) int32 table (oy, ox, flip) drawn by the caller.
//
// Replaces: src/uig/kernels/augment_pallas.py, augment_batch_pallas ->
// _augment_kernel (on the TPU, crop and flip are two exact 0/1 selector
// matmuls on the matrix unit, because that Mosaic backend lowers no dynamic
// slice or lane reversal). On this card both are plain index arithmetic.
//
// Bound on this card: bytes. At (8, 286, 286, 3) -> (8, 256, 256, 3) it reads
// 1.57 MB of the 1.96 MB input and writes 6.3 MB: ~2.5 us at the H100 SXM
// data-sheet 3.35 TB/s (700 W). Launch overhead is of the same order.
//
// Design: one thread per output element. Consecutive threads write
// consecutive fp32 values (coalesced) and read consecutive bytes of one
// input row (reversed runs when flipped, the same 32-byte sectors). The
// scale is __fmul_rn then __fsub_rn, so nvcc cannot contract it into an FMA
// and the result is bit-equal to the plain version's x * (2/255) - 1.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void augment_kernel(const uint8_t* __restrict__ x,
                               const int* __restrict__ meta,
                               float* __restrict__ y, int H, int W, int C,
                               int crop, long long total) {
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= total) return;
  const int c = (int)(o % C);
  long long t = o / C;
  const int j = (int)(t % crop);
  t /= crop;
  const int i = (int)(t % crop);
  const int b = (int)(t / crop);
  const int oy = meta[3 * b + 0];
  const int ox = meta[3 * b + 1];
  const int jj = meta[3 * b + 2] ? crop - 1 - j : j;
  const uint8_t v = x[(((size_t)b * H + oy + i) * W + ox + jj) * C + c];
  y[o] = __fsub_rn(__fmul_rn((float)v, 2.0f / 255.0f), 1.0f);
}

}  // namespace

// x: (B, H, W, C) uint8; meta: (B, 3) int32 rows (oy, ox, flip) with
// 0 <= oy <= H - crop and 0 <= ox <= W - crop; y: (B, crop, crop, C) fp32.
extern "C" cudaError_t uig_augment(const uint8_t* x, const int* meta,
                                   float* y, int B, int H, int W, int C,
                                   int crop, cudaStream_t stream) {
  const long long total = (long long)B * crop * crop * C;
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  augment_kernel<<<(unsigned)blocks, threads, 0, stream>>>(x, meta, y, H, W,
                                                           C, crop, total);
  return cudaGetLastError();
}
