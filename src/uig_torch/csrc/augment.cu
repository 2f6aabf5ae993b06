// Random crop + optional left-right flip + normalize to [-1, 1]: uint8 NHWC
// (B, H, W, C) -> NHWC (B, crop, crop, C) in fp32 or bf16 (the compute
// dtype), with the per-example offsets and flips given as a (B, 3) int32
// table (oy, ox, flip) drawn by the caller.
//
// Replaces: src/uig/kernels/augment_pallas.py, augment_batch_pallas ->
// _augment_kernel (on the TPU, crop and flip are two exact 0/1 selector
// matmuls on the matrix unit, because that Mosaic backend lowers no dynamic
// slice or lane reversal). On this card both are plain index arithmetic.
//
// Bound on this card: bytes. At (8, 286, 286, 3) -> (8, 256, 256, 3) it reads
// 1.57 MB of the 1.96 MB input and writes 6.3 MB in fp32 (3.1 MB in bf16):
// ~2.5 us at the H100 SXM data-sheet 3.35 TB/s (700 W). Launch overhead is
// of the same order.
//
// Design: one thread per output element. Consecutive threads write
// consecutive values (coalesced) and read consecutive bytes of one input
// row (reversed runs when flipped, the same 32-byte sectors). The scale is
// __fmul_rn then __fsub_rn in fp32, so nvcc cannot contract it into an FMA
// and the result is bit-equal to the plain version's x * (2/255) - 1; in
// bf16 that fp32 value is rounded once, as JAX's astype(out_dtype). With
// C = 3 the output rows are not 4-aligned: scalar stores.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"

namespace {

template <typename T>
__global__ void augment_kernel(const uint8_t* __restrict__ x,
                               const int* __restrict__ meta,
                               T* __restrict__ y, int H, int W, int C,
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
  y[o] = from_f32<T>(__fsub_rn(__fmul_rn((float)v, 2.0f / 255.0f), 1.0f));
}

template <typename T>
cudaError_t augment(const uint8_t* x, const int* meta, void* y, int B, int H,
                    int W, int C, int crop, cudaStream_t stream) {
  const long long total = (long long)B * crop * crop * C;
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  augment_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      x, meta, static_cast<T*>(y), H, W, C, crop, total);
  return cudaGetLastError();
}

}  // namespace

// x: (B, H, W, C) uint8; meta: (B, 3) int32 rows (oy, ox, flip) with
// 0 <= oy <= H - crop and 0 <= ox <= W - crop; y: (B, crop, crop, C) fp32,
// or bf16 when is_bf16.
extern "C" cudaError_t uig_augment(const uint8_t* x, const int* meta, void* y,
                                   int B, int H, int W, int C, int crop,
                                   int is_bf16, cudaStream_t stream) {
  return is_bf16 ? augment<bf16>(x, meta, y, B, H, W, C, crop, stream)
                 : augment<float>(x, meta, y, B, H, W, C, crop, stream);
}
