// The epilogue of K3's two tensor-core convs, csrc/conv3_in_tc.cu (bf16)
// and csrc/conv3_in_tf32.cu (fp32), after their mainloops on the ring of
// csrc/wgmma.cuh: acc + bias in fp32, rounded once to the storage type T
// for y_conv (the identity in fp32), a masked store of y_conv, then the
// per-column sums of the stored v and v^2 over the tile's valid rows in a
// fixed order: within the thread (its two rows), across the lanes that
// share the column (shuffle-xor 4, 8, 16), across the eight warps in row
// order through shared memory, and one write per (tile, channel) into the
// (2, B, tiles, F) partials that in_common.cuh's finalize reduces. No
// atomics: repeats are bit-equal.
#pragma once

#include <cuda_bf16.h>

#include "dtype.cuh"
#include "wgmma.cuh"

namespace {

// Two neighbouring outputs rounded to T, and widened back to fp32.
template <typename T>
struct Pair;
template <>
struct Pair<float> {
  typedef float2 type;
  static __device__ __forceinline__ float2 round(float a, float b) {
    return make_float2(a, b);
  }
  static __device__ __forceinline__ float2 widen(float2 v) { return v; }
};
template <>
struct Pair<bf16> {
  typedef __nv_bfloat162 type;
  static __device__ __forceinline__ __nv_bfloat162 round(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
  static __device__ __forceinline__ float2 widen(__nv_bfloat162 v) {
    return __bfloat1622float2(v);
  }
};

// d: the accumulator of warpgroup threadIdx.x / 128, rows m0 + 64 wg ..
// m0 + 64 wg + 63 of image b and columns n0 .. n0 + 127; smem: the block's
// ring, free once every warpgroup is done with it (the first barrier), which
// takes the warps' column sums red[stat][warp][column]. grid.x counts the
// tiles of an image.
template <typename T>
__device__ __forceinline__ void conv3_in_epilogue(
    const float (&d)[64], const float* __restrict__ bias, T* __restrict__ y,
    float* __restrict__ part, uint8_t* smem, int B, int HW, int F, int b,
    int m0, int n0) {
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int warp = tid >> 5, lane = tid & 31;
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  bool row_ok[2];
  T* yr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + wg * 64 + acc_row(t, h);
    row_ok[h] = m < HW;
    yr[h] = y + ((size_t)b * HW + (row_ok[h] ? m : 0)) * F;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = acc_col(t, j);
    const int n = n0 + col;
    const bool n_ok = n < F;  // F % 4 == 0: n and n + 1 are both in or out
    const float b0 = n_ok ? bias[n] : 0.f, b1 = n_ok ? bias[n + 1] : 0.f;
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const typename Pair<T>::type v = Pair<T>::round(
          d[4 * j + 2 * h] + b0, d[4 * j + 2 * h + 1] + b1);
      if (!row_ok[h]) continue;
      if (n_ok) *reinterpret_cast<typename Pair<T>::type*>(yr[h] + n) = v;
      const float2 f = Pair<T>::widen(v);
      s1[0] += f.x;
      s2[0] += f.x * f.x;
      s1[1] += f.y;
      s2[1] += f.y * f.y;
    }
    // the 8 lanes of a column (lane % 4 equal): a butterfly, the same
    // order on every lane
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], off);
        s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], off);
      }
    }
    if (lane < 4) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red[(0 * kWarps + warp) * 128 + col + e] = s1[e];
        red[(1 * kWarps + warp) * 128 + col + e] = s2[e];
      }
    }
  }
  __syncthreads();
  if (tid < 128 && n0 + tid < F) {
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int r = 0; r < kWarps; ++r) {  // warps in row order
      t1 += red[(0 * kWarps + r) * 128 + tid];
      t2 += red[(1 * kWarps + r) * 128 + tid];
    }
    const size_t o = ((size_t)b * gridDim.x + blockIdx.x) * F + n0 + tid;
    part[o] = t1;
    part[(size_t)B * gridDim.x * F + o] = t2;
  }
}

}  // namespace
