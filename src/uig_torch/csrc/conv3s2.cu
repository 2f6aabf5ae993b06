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
// 128 * 9 * 64 = 3.87e10 FLOP (dgrad and wgrad the same): 0.58 ms at the
// H100 SXM data-sheet 67 TFLOP/s fp32 FMA rate (700 W), 0.2345 ms as three
// TF32 products at 495 TFLOP/s, 0.039 ms at the 989 TFLOP/s bf16 rate.
//
// Three designs, chosen by the storage type and the function:
//   - bf16, all three: the tensor cores (wgmma, fp32 accumulators),
//     csrc/conv3s2_tc.cu;
//   - fp32 dgrad and wgrad: the tensor cores in the three-term TF32 split
//     ("tf32x3"), csrc/conv3s2_tf32.cu;
//   - fp32 forward (the training step's and the serving path's, TF32 off):
//     this file's FMA core.
// This file holds the entry points, the FMA forward and the reduce pass of
// every weight gradient: the weight gradients' first passes write fp32
// partials (chunks, k k C, F) over ordered pixel chunks, and the reduce
// sums them in chunk order and rounds once to T, as K4w does. No atomics:
// repeat runs give the same bits.
//
// FMA core: K3's implicit GEMM (csrc/conv3_in.cu): a block computes a
// 128 x BN tile (BN 128, or 64 when F is at most 64), 8 x 8 outputs a
// thread in registers, stepping K by 8 through two fp32 shared tiles.
// Loads take four values at a time (C % 4 == 0 and F % 4 == 0, so a run of
// four never crosses a tap); every sum is an fp32 FMA in a fixed order. M
// = output pixels of one image, N = F, K = (tap, c), read straight from
// the HWIO weights as a (k k C, F) row-major matrix; the A loader gathers
// the strided window with zero padding as a masked load; the bias is added
// before the store.
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

constexpr int kBM = 128;      // GEMM rows per block
constexpr int kBK = 8;        // K step

// The thread's 8 x 8 outputs: rows tm*4 + i and 64 + tm*4 + i, columns
// tn*4 + j and BN/2 + tn*4 + j (i, j < 4) of the block's kBM x BN tile.
__device__ __forceinline__ int row_of(int i, int tm) {
  return i < 4 ? tm * 4 + i : 64 + tm * 4 + (i - 4);
}

template <int BN>
__device__ __forceinline__ void mma_step(float (*As)[kBM], float (*Bs)[BN],
                                         float (&acc)[8][8], int tm, int tn) {
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][tm * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + tm * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tn * 4]);
    const float4 b1 =
        *reinterpret_cast<const float4*>(&Bs[kk][BN / 2 + tn * 4]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// A run of four K entries of one GEMM row, transposed into As[k][row].
__device__ __forceinline__ void put_a(float (*As)[kBM], int k, int row,
                                      float4 v) {
  As[k + 0][row] = v.x;
  As[k + 1][row] = v.y;
  As[k + 2][row] = v.z;
  As[k + 3][row] = v.w;
}

// ------------------------------------------------------------------ fwd --
// fp32. grid (ceil(Ho Wo / kBM), ceil(F / BN), B), block 2 BN.
template <int BN>
__global__ void __launch_bounds__(2 * BN)
    conv_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ y,
                    int H, int W, int C, int F, int Ho, int Wo, int k,
                    int stride, int pad) {
  constexpr int kThreads = 2 * BN;
  constexpr int kALoads = kBM * kBK / 4 / kThreads;
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][BN];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int M = Ho * Wo;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int K = k * k * C;
  const float* xb = x + (size_t)b * H * W * C;

  // A loader: kALoads (output pixel, run of 4 K entries) a thread
  int a_row[kALoads], a_k[kALoads], a_iy[kALoads], a_ix[kALoads];
  bool a_ok[kALoads];
#pragma unroll
  for (int q = 0; q < kALoads; ++q) {
    const int idx = tid + q * kThreads;
    a_row[q] = idx >> 1;
    a_k[q] = (idx & 1) * 4;
    const int m = m0 + a_row[q];
    a_ok[q] = m < M;
    const int oy = a_ok[q] ? m / Wo : 0;
    const int ox = a_ok[q] ? m - oy * Wo : 0;
    a_iy[q] = oy * stride - pad;
    a_ix[q] = ox * stride - pad;
  }
  // B loader: one K row, 4 output channels
  const int b_row = tid / (BN / 4);
  const int b_col = (tid % (BN / 4)) * 4;
  const bool b_ok = n0 + b_col < F;

  const int tm = tid / (BN / 8), tn = tid % (BN / 8);
  float acc[8][8];
  zero(acc);

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int q = 0; q < kALoads; ++q) {
      float4 av = make_float4(0.f, 0.f, 0.f, 0.f);
      const int kq = k0 + a_k[q];
      if (a_ok[q] && kq < K) {
        const int tap = kq / C;
        const int c = kq - tap * C;
        const int di = tap / k;
        const int sy = a_iy[q] + di;
        const int sx = a_ix[q] + tap - di * k;
        if (sy >= 0 && sy < H && sx >= 0 && sx < W)
          av = load4(xb + ((size_t)sy * W + sx) * C + c);
      }
      put_a(As, a_k[q], a_row[q], av);
    }
    float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
    const int kb = k0 + b_row;
    if (b_ok && kb < K) bv = load4(w + (size_t)kb * F + n0 + b_col);
    *reinterpret_cast<float4*>(&Bs[b_row][b_col]) = bv;
    __syncthreads();
    mma_step<BN>(As, Bs, acc, tm, tn);
    __syncthreads();
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int col = half ? BN / 2 + tn * 4 : tn * 4;
    if (n0 + col >= F) continue;
    float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (bias != nullptr) bv = load4(bias + n0 + col);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + row_of(i, tm);
      if (m >= M) continue;
      const float* a = &acc[i][half * 4];
      store4(y + ((size_t)b * M + m) * F + n0 + col,
             make_float4(a[0] + bv.x, a[1] + bv.y, a[2] + bv.z, a[3] + bv.w));
    }
  }
}

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

template <int BN>
cudaError_t fwd(const void* x, const void* w, const void* bias, void* y,
                int B, int H, int W, int C, int F, int k, int stride, int pad,
                cudaStream_t stream) {
  const int Ho = (H + 2 * pad - k) / stride + 1;
  const int Wo = (W + 2 * pad - k) / stride + 1;
  const dim3 grid((Ho * Wo + kBM - 1) / kBM, (F + BN - 1) / BN, B);
  conv_fwd_kernel<BN><<<grid, 2 * BN, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(y), H, W, C, F, Ho,
      Wo, k, stride, pad);
  return cudaGetLastError();
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
// csrc/conv3s2_tf32.cu (fp32 dgrad and wgrad).
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
cudaError_t conv_dgrad_fp32_tf32(const void* dy, const void* w, float* ws,
                                 void* dx, int B, int H, int W, int C, int F,
                                 int k, int stride, int pad,
                                 cudaStream_t stream);
cudaError_t conv_wgrad_fp32_tf32(const void* x, const void* dy, float* part,
                                 int B, int H, int W, int C, int F, int k,
                                 int stride, int pad, int chunks,
                                 int per_chunk, cudaStream_t stream);

// x: (B, H, W, C); w: HWIO (k, k, C, F) = a (k k C, F) matrix; bias: (F,)
// or null; y: (B, Ho, Wo, F); all fp32 (FMA core), or all bf16 when
// is_bf16 (wgmma). C % 4 == 0, F % 4 == 0, k <= 7.
extern "C" cudaError_t uig_conv_fwd(const void* x, const void* w,
                                    const void* bias, void* y, int B, int H,
                                    int W, int C, int F, int k, int stride,
                                    int pad, int is_bf16,
                                    cudaStream_t stream) {
  if (bad_shape(C, F, k, stride, pad)) return cudaErrorInvalidValue;
  if (is_bf16)
    return conv_fwd_bf16_wgmma(x, w, bias, y, B, H, W, C, F, k, stride, pad,
                               stream);
  return F <= 64 ? fwd<64>(x, w, bias, y, B, H, W, C, F, k, stride, pad,
                           stream)
                 : fwd<128>(x, w, bias, y, B, H, W, C, F, k, stride, pad,
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
