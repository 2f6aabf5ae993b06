// Fused 3x3 stride-1 pad-1 conv (reflect or zeros) + bias + instance norm
// (+ReLU) over NHWC fp32 or bf16, for the generator's residual trunk.
//
// Replaces: src/uig/kernels/convin_pallas.py, _convin_fwd_impl ->
// _convin_kernel (the TPU kernel keeps one example's padded plane resident in
// VMEM, runs the conv as im2col strips on the matrix unit, accumulates the
// channel moments from the values it just produced, then normalizes). In
// bf16 the conv accumulates in fp32, acc + bias is rounded once to bf16 for
// y_conv, and the moments come from those rounded values, as there.
//
// Bound on this card: operations. At (8, 64, 64, 256) -> 256 the conv is
// 38.7 GFLOP: about 0.58 ms at the H100 SXM data-sheet 67 TFLOP/s fp32
// (700 W), while its ~70 MB of reads and writes take about 20 us.
//
// Two designs, chosen by the storage type. fp32 (this file): the serving
// path is fp32 at "highest" precision, so the conv runs fp32 FMAs and not
// the TF32 tensor cores (TF32 would break parity with the JAX reference).
// bf16 (csrc/conv3_in_tc.cu, launched from the entry point below): the
// same FLOPs take ~0.04 ms at the data-sheet's 989 TFLOP/s bf16 tensor-core
// rate, so the conv issues wgmma on the ring of csrc/wgmma.cuh, with the
// same partials and the same finalize; that file states its bound and
// design.
//
// FMA design (fp32): an implicit GEMM. Output pixels of one image are the M
// dimension, output channels N, and the (3, 3, C) window K = 9C, read
// straight from the HWIO weights as a (9C, F) row-major matrix. Each
// 256-thread block computes a 128-pixel x 128-channel tile, 8 x 8 outputs
// per thread, stepping K by 8 through two small shared-memory tiles. The A
// loader gathers the window with reflect padding as index mirroring (row
// -1 -> row 1, row H -> H-2), or a masked zero load, so no padded tensor is
// ever materialized. A 4-channel run never crosses a tap because
// C % 4 == 0, so it is one 4-wide load. The epilogue adds the bias, writes
// y_conv, and sums y and y^2 per channel over the tile's pixels in a fixed
// order into a (2, B, tiles, F) scratch: deterministic, no float atomics.
// in_common.cuh then reduces those partials and normalizes y_conv into the
// output, as the instance norm kernel does.
#include <cuda_runtime.h>

#include "dtype.cuh"
#include "in_common.cuh"

namespace {

constexpr int kBM = 128;  // output pixels per block
constexpr int kBN = 128;  // output channels per block
constexpr int kBK = 8;    // K step
constexpr int kThreads = 256;

__device__ __forceinline__ int mirror(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// grid (ceil(HW / kBM), ceil(F / kBN), B), block kThreads.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    conv3_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const float* __restrict__ bias, T* __restrict__ y,
                      float* __restrict__ part, int B, int H, int W, int C,
                      int F, int reflect) {
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][kBN];
  __shared__ float red[2][16][kBN];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int tiles = gridDim.x;
  const int HW = H * W;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int K = 9 * C;
  const T* xb = x + (size_t)b * HW * C;

  // A loader: one pixel, one run of 4 K entries.
  const int a_row = tid >> 1;
  const int a_k = (tid & 1) * 4;
  const int a_m = m0 + a_row;
  const bool a_ok = a_m < HW;
  const int a_y = a_ok ? a_m / W : 0;
  const int a_x = a_ok ? a_m - a_y * W : 0;
  // B loader: one K row, 4 output channels.
  const int b_row = tid >> 5;
  const int b_col = (tid & 31) * 4;
  const bool b_ok = n0 + b_col < F;

  const int tm = tid >> 4;
  const int tn = tid & 15;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f);
    const int k = k0 + a_k;
    if (a_ok && k < K) {
      const int tap = k / C;
      const int c = k - tap * C;
      const int di = tap / 3;
      const int dj = tap - di * 3;
      int sy = a_y + di - 1;
      int sx = a_x + dj - 1;
      bool in = true;
      if (reflect) {
        sy = mirror(sy, H);
        sx = mirror(sx, W);
      } else {
        in = sy >= 0 && sy < H && sx >= 0 && sx < W;
      }
      if (in) av = load4(xb + ((size_t)sy * W + sx) * C + c);
    }
    As[a_k + 0][a_row] = av.x;
    As[a_k + 1][a_row] = av.y;
    As[a_k + 2][a_row] = av.z;
    As[a_k + 3][a_row] = av.w;

    float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
    const int kb = k0 + b_row;
    if (b_ok && kb < K) bv = load4(w + (size_t)kb * F + n0 + b_col);
    *reinterpret_cast<float4*>(&Bs[b_row][b_col]) = bv;
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][tm * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + tm * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tn * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tn * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: bias, store y_conv, per-thread column moments over its rows.
  float bv[8];
  int ncol[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    ncol[j] = (j < 4 ? tn * 4 + j : 64 + tn * 4 + (j - 4));
    const int n = n0 + ncol[j];
    bv[j] = n < F ? bias[n] : 0.f;
  }
  float s1[8], s2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s1[j] = s2[j] = 0.f;
  const bool lo_ok = n0 + tn * 4 < F;
  const bool hi_ok = n0 + 64 + tn * 4 < F;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? tm * 4 + i : 64 + tm * 4 + (i - 4));
    if (m < HW) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] = round_to<T>(acc[i][j] + bv[j]);
        s1[j] += v[j];
        s2[j] += v[j] * v[j];
      }
      T* yrow = y + ((size_t)b * HW + m) * F + n0;
      if (lo_ok) store4(yrow + tn * 4, make_float4(v[0], v[1], v[2], v[3]));
      if (hi_ok)
        store4(yrow + 64 + tn * 4, make_float4(v[4], v[5], v[6], v[7]));
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    red[0][tm][ncol[j]] = s1[j];
    red[1][tm][ncol[j]] = s2[j];
  }
  __syncthreads();
  if (tid < kBN) {
    const int n = n0 + tid;
    if (n < F) {
      float t1 = 0.f, t2 = 0.f;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        t1 += red[0][r][tid];
        t2 += red[1][r][tid];
      }
      const size_t o = ((size_t)b * tiles + blockIdx.x) * F + n;
      part[o] = t1;
      part[(size_t)B * tiles * F + o] = t2;
    }
  }
}

template <typename T>
cudaError_t fwd(const T* x, const T* w, const float* bias, const float* gamma,
                const float* beta, T* yconv, T* y, float* part, float* ss,
                int B, int H, int W, int C, int F, int reflect, int relu,
                float eps, cudaStream_t stream) {
  const int HW = H * W;
  const int tiles = (HW + kBM - 1) / kBM;
  const dim3 grid(tiles, (F + kBN - 1) / kBN, B);
  conv3_gemm_kernel<T><<<grid, kThreads, 0, stream>>>(
      x, w, bias, yconv, part, B, H, W, C, F, reflect);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return in_finalize_apply<T>(part, gamma, beta, ss, yconv, y, B, HW, F,
                              tiles, eps, relu, stream);
}

}  // namespace

// The tensor-core conv of csrc/conv3_in_tc.cu, with its finalize.
cudaError_t conv3_in_fwd_bf16_wgmma(const void* x, const void* w,
                                    const float* bias, const float* gamma,
                                    const float* beta, void* yconv, void* y,
                                    float* part, float* ss, int B, int H,
                                    int W, int C, int F, int reflect,
                                    int relu, float eps, cudaStream_t stream);

// x: (B, H, W, C), w: (9C, F) from HWIO (3, 3, C, F), yconv, y: (B, H, W,
// F), all fp32 (FMA design), or all bf16 when is_bf16 (wgmma). bias/gamma/
// beta (F,) fp32.
// part: (2, B, tiles, F) fp32 with tiles = ceil(H*W / 128); ss: (2, B, F)
// fp32. C % 4 == 0, F % 4 == 0.
extern "C" cudaError_t uig_conv3_in_fwd(const void* x, const void* w,
                                        const float* bias, const float* gamma,
                                        const float* beta, void* yconv,
                                        void* y, float* part, float* ss,
                                        int B, int H, int W, int C, int F,
                                        int reflect, int relu, float eps,
                                        int is_bf16, cudaStream_t stream) {
  if (is_bf16)
    return conv3_in_fwd_bf16_wgmma(x, w, bias, gamma, beta, yconv, y, part,
                                   ss, B, H, W, C, F, reflect, relu, eps,
                                   stream);
  return fwd<float>(static_cast<const float*>(x), static_cast<const float*>(w),
                    bias, gamma, beta, static_cast<float*>(yconv),
                    static_cast<float*>(y), part, ss, B, H, W, C, F, reflect,
                    relu, eps, stream);
}
