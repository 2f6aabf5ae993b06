// The instance norm of K3's fused conv3+IN: the reduction of per-tile
// moments in a fixed order, and normalize + affine (+ReLU) elementwise.
//
// Used by conv3_in_tf32.cu and conv3_in_tc.cu (moments from the conv
// epilogue), which write their partial sums as a (2, B, chunks, C) fp32
// buffer: plane 0 holds sum(x), plane 1 sum(x^2). (K2f, the norm on its
// own, is one kernel of its own: instance_norm_fwd.cu.)
// Activations are T (float or bf16, dtype.cuh); moments, scale, shift and
// every sum are fp32, computed from the stored T values, as the JAX
// InstanceNorm takes fp32 statistics of its bf16 input.
// No float atomics anywhere: every sum runs in one fixed order, so two runs
// on the same inputs give the same bits.
#pragma once

#include <cuda_runtime.h>

#include "dtype.cuh"

// One thread per (b, c): walk the chunks in order, then
//   mean = s1 / n, var = max(s2 / n - mean^2, 0), r = 1 / sqrt(var + eps)
//   scale = r * gamma, shift = beta - mean * scale
// which is the numerics of the JAX InstanceNorm (fp32 one-pass moments,
// variance clamped at 0, eps inside the square root). mean and r are kept
// for the backward (instance_norm_bwd.cu), as the JAX convin VJP keeps them.
static __global__ void in_finalize_kernel(const float* __restrict__ part,
                                          const float* __restrict__ gamma,
                                          const float* __restrict__ beta,
                                          float* __restrict__ scale,
                                          float* __restrict__ shift,
                                          float* __restrict__ mean,
                                          float* __restrict__ rstd, int B,
                                          int C, int chunks, float n,
                                          float eps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * C) return;
  const int b = i / C;
  const int c = i - b * C;
  const size_t plane = (size_t)B * chunks * C;
  const float* p1 = part + (size_t)b * chunks * C + c;
  const float* p2 = p1 + plane;
  float s1 = 0.f, s2 = 0.f;
  for (int k = 0; k < chunks; ++k) {
    s1 += p1[(size_t)k * C];
    s2 += p2[(size_t)k * C];
  }
  const float m = s1 / n;
  const float var = fmaxf(s2 / n - m * m, 0.f);
  const float r = 1.f / sqrtf(var + eps);
  const float sc = r * gamma[c];
  scale[i] = sc;
  shift[i] = beta[c] - m * sc;
  mean[i] = m;
  rstd[i] = r;
}

// y = x * scale[b, c] + shift[b, c] (+ReLU), four channels at a time
// (C % 4 == 0), rounded once to T. grid (x: blocks over one image's
// H*W*C/4 groups, y: batch index b).
template <typename T>
static __global__ void in_apply_kernel(const T* __restrict__ x,
                                       const float* __restrict__ scale,
                                       const float* __restrict__ shift,
                                       T* __restrict__ y, int hwc4, int C,
                                       int relu) {
  const int b = blockIdx.y;
  const int c4n = C >> 2;
  const T* xb = x + (size_t)b * hwc4 * 4;
  T* yb = y + (size_t)b * hwc4 * 4;
  const float* sc = scale + (size_t)b * C;
  const float* sh = shift + (size_t)b * C;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < hwc4;
       i += gridDim.x * blockDim.x) {
    const int c = (i % c4n) * 4;
    float4 v = load4(xb + (size_t)i * 4);
    v.x = v.x * sc[c + 0] + sh[c + 0];
    v.y = v.y * sc[c + 1] + sh[c + 1];
    v.z = v.z * sc[c + 2] + sh[c + 2];
    v.w = v.w * sc[c + 3] + sh[c + 3];
    if (relu) {
      v.x = fmaxf(v.x, 0.f);
      v.y = fmaxf(v.y, 0.f);
      v.z = fmaxf(v.z, 0.f);
      v.w = fmaxf(v.w, 0.f);
    }
    store4(yb + (size_t)i * 4, v);
  }
}

// Finalize the moments in `part` into `ss` (planes of (B, C): 0 scale, 1
// shift, 2 mean, 3 1/sqrt(var + eps), the statistics the backward takes)
// and apply them to x -> y. Returns the first launch error.
template <typename T>
static cudaError_t in_finalize_apply(const float* part, const float* gamma,
                                     const float* beta, float* ss, const T* x,
                                     T* y, int B, int HW, int C, int chunks,
                                     float eps, int relu,
                                     cudaStream_t stream) {
  const int bc = B * C;
  float* scale = ss;
  float* shift = ss + bc;
  in_finalize_kernel<<<(bc + 255) / 256, 256, 0, stream>>>(
      part, gamma, beta, scale, shift, ss + 2 * bc, ss + 3 * bc, B, C, chunks,
      (float)HW, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int hwc4 = HW * (C / 4);
  int gx = (hwc4 + 255) / 256;
  if (gx > 1024) gx = 1024;
  in_apply_kernel<T><<<dim3(gx, B), 256, 0, stream>>>(x, scale, shift, y,
                                                      hwc4, C, relu);
  return cudaGetLastError();
}
