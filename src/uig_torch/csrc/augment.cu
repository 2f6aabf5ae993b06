// Random crop + optional left-right flip + normalize to [-1, 1]: uint8 NHWC
// (B, H, W, C) -> NHWC (B, crop, crop, C) in fp32 or bf16 (the compute
// dtype), with the per-example offsets and flips given by the caller.
//
// Replaces: src/uig/kernels/augment_pallas.py, augment_batch_pallas ->
// _augment_kernel (on the TPU, crop and flip are two exact 0/1 selector
// matmuls on the matrix unit, because that Mosaic backend lowers no dynamic
// slice or lane reversal). On this card both are plain index arithmetic.
//
// Bound on this card: bytes. At (8, 286, 286, 3) -> (8, 256, 256, 3) it reads
// the 1.57 MB of the crops and writes 6.3 MB in fp32 (3.1 MB in bf16): ~2.3
// us (1.4 us in bf16) at the H100 SXM data-sheet 3.35 TB/s (700 W). A launch
// costs more than that, so the design keeps the launch alone: the offsets
// and flips travel in the kernel's parameters (no host-to-device copy, which
// would wait for the stream), and the index arithmetic is 32-bit with no
// division per element.
//
// Design: grid (row chunk, output row, example); a block owns up to
// `chunk` output pixels of one output row. It copies the row's source bytes
// (one contiguous run of the input row, read once, in reverse pixel order
// when flipped) into shared memory in output order, one pixel a thread,
// then writes the output run as whole 16-byte pieces (4 fp32 or 8 bf16),
// with scalar stores for the ends where the run's start or length is not
// 16-byte aligned (e.g. (2, 9, 9, 1)). The scale is __fmul_rn then
// __fsub_rn in fp32, so nvcc cannot contract it into an FMA and the result
// is bit-equal to the plain version's x * (2/255) - 1; in bf16 that fp32
// value is rounded once, as JAX's astype(out_dtype).
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "dtype.cuh"

namespace {

constexpr int kMaxBatch = 64;  // examples a launch; the caller slices more
constexpr int kThreads = 128;

struct Meta {  // by value in the kernel's parameters
  int oy[kMaxBatch], ox[kMaxBatch], flip[kMaxBatch];
};

__device__ __forceinline__ float scale(uint8_t v) {
  return __fsub_rn(__fmul_rn((float)v, 2.0f / 255.0f), 1.0f);
}

template <typename T>
__device__ __forceinline__ void store_piece(T* out, const uint8_t* v);
template <>
__device__ __forceinline__ void store_piece<float>(float* out,
                                                   const uint8_t* v) {
  *reinterpret_cast<float4*>(out) =
      make_float4(scale(v[0]), scale(v[1]), scale(v[2]), scale(v[3]));
}
template <>
__device__ __forceinline__ void store_piece<bf16>(bf16* out,
                                                  const uint8_t* v) {
  uint32_t u[4];
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const __nv_bfloat162 p =
        __floats2bfloat162_rn(scale(v[2 * h]), scale(v[2 * h + 1]));
    u[h] = *reinterpret_cast<const uint32_t*>(&p);
  }
  *reinterpret_cast<uint4*>(out) = make_uint4(u[0], u[1], u[2], u[3]);
}

// grid (ceil(crop / chunk), crop, examples of this launch), block kThreads,
// chunk * C bytes of dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    augment_kernel(const uint8_t* __restrict__ x, const Meta meta,
                   T* __restrict__ y, int H, int W, int C, int crop,
                   int chunk) {
  extern __shared__ uint8_t row[];
  constexpr int V = 16 / sizeof(T);  // values of a 16-byte piece
  const int b = blockIdx.z, i = blockIdx.y;
  const int p0 = blockIdx.x * chunk;
  const int np = min(chunk, crop - p0);
  const int n = np * C;
  const bool flip = meta.flip[b] != 0;
  const uint8_t* src =
      x + (((size_t)b * H + meta.oy[b] + i) * W + meta.ox[b]) * C;
  for (int q = threadIdx.x; q < np; q += kThreads) {
    const int jo = p0 + q;
    const uint8_t* s = src + (flip ? crop - 1 - jo : jo) * C;
    for (int c = 0; c < C; ++c) row[q * C + c] = s[c];
  }
  __syncthreads();

  T* out = y + (((size_t)b * crop + i) * crop + p0) * C;
  // the run's elements before its first 16-byte boundary, then whole
  // pieces, then the rest
  const int mis = (int)((reinterpret_cast<uintptr_t>(out) / sizeof(T)) % V);
  const int head = min(n, (V - mis) % V);
  const int pieces = (n - head) / V;
  const int tail = head + pieces * V;
  for (int e = threadIdx.x; e < head; e += kThreads)
    out[e] = from_f32<T>(scale(row[e]));
  for (int v = threadIdx.x; v < pieces; v += kThreads) {
    const int e = head + v * V;
    uint8_t vals[V];
#pragma unroll
    for (int k = 0; k < V; ++k) vals[k] = row[e + k];
    store_piece<T>(out + e, vals);
  }
  for (int e = tail + threadIdx.x; e < n; e += kThreads)
    out[e] = from_f32<T>(scale(row[e]));
}

template <typename T>
cudaError_t augment(const uint8_t* x, const int* meta_host, void* y, int B,
                    int H, int W, int C, int crop, cudaStream_t stream) {
  if (B < 0 || B > kMaxBatch) return cudaErrorInvalidValue;
  if (B == 0 || crop == 0) return cudaSuccess;
  // output pixels a block: a whole 256-pixel row at the path shape, within
  // 48 KB of shared memory for any C; a multiple of 16, so that every chunk
  // starts where the row does modulo 16 bytes
  const int chunk = min(crop, max(16, (16384 / C) / 16 * 16));
  const size_t smem = (size_t)chunk * C;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  Meta meta;
  memcpy(meta.oy, meta_host, B * sizeof(int));
  memcpy(meta.ox, meta_host + B, B * sizeof(int));
  memcpy(meta.flip, meta_host + 2 * B, B * sizeof(int));
  const dim3 grid((crop + chunk - 1) / chunk, crop, B);
  augment_kernel<T><<<grid, kThreads, smem, stream>>>(
      x, meta, static_cast<T*>(y), H, W, C, crop, chunk);
  return cudaGetLastError();
}

}  // namespace

// x: (B, H, W, C) uint8 on the card; meta_host: 3 B int32 in host memory,
// oy[B] then ox[B] then flip[B], with 0 <= oy <= H - crop and 0 <= ox <=
// W - crop, read before this returns; y: (B, crop, crop, C) fp32, or bf16
// when is_bf16. B <= 64 (the offsets travel in the kernel's parameters);
// one kernel launch.
extern "C" cudaError_t uig_augment(const uint8_t* x, const int* meta_host,
                                   void* y, int B, int H, int W, int C,
                                   int crop, int is_bf16,
                                   cudaStream_t stream) {
  return is_bf16 ? augment<bf16>(x, meta_host, y, B, H, W, C, crop, stream)
                 : augment<float>(x, meta_host, y, B, H, W, C, crop, stream);
}
