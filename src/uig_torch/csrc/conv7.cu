// Direct 7x7 stride-1 pad-3 conv (reflect or zeros) + bias over NHWC fp32
// or bf16, for few output channels (the generator head, Cin 64 -> Cout 3):
// the entry point and the fp32 kernel.
//
// Replaces: src/uig/kernels/conv_pallas.py, _conv5_impl -> _conv5_kernel with
// _assemble_mirror, as reached from conv7_s2d via conv_core5 (on the TPU the
// conv is re-expressed in a space-to-depth "free view" so that the matrix
// unit's lanes fill; that trick buys nothing here and is not carried over).
//
// Bound on this card: operations. At (8, 256, 256, 64) -> 3 the conv is
// 9.87 GFLOP, about 0.147 ms at the H100 SXM data-sheet 67 TFLOP/s fp32
// (700 W); its 134 MB read and 6 MB write take about 42 us. In bf16 (x, w
// and the bias already rounded to bf16, as JAX's PadConv casts them) its
// bound at the 989 TFLOP/s bf16 tensor-core rate is ~0.01 ms, by bytes
// ~0.02 ms.
//
// Two designs, chosen by the storage type:
//   - fp32: this file's FMA kernel, below;
//   - bf16: the tensor cores (mma.sync m16n8k16 on the exact bf16
//     products, the 7 horizontal taps folded into N), csrc/conv7_tc.cu.
//
// FMA design: one thread per output pixel computes all (<= 4) output channels,
// so a product with N = 3 wastes nothing on padding to a matrix tile. A
// 32 x 8 block stages its input tile plus the 3-pixel halo in shared memory,
// 16 input channels at a time, with reflect padding as index mirroring in
// the loader (zeros mode is a masked load), so no padded tensor is ever
// materialized. The chunk's 7 x 7 x 16 weights sit in shared memory as one
// float4 per (tap, channel); every thread of a warp reads the same one, a
// broadcast. A warp reads 32 neighbouring pixels of one tile row: no bank
// conflicts. Bias is added in the epilogue; tanh stays outside, as in JAX.
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

constexpr int kTW = 32;  // output columns per block
constexpr int kTH = 8;   // output rows per block
constexpr int kCK = 16;  // input channels per shared-memory chunk
constexpr int kR = 3;    // halo
constexpr int kIH = kTH + 2 * kR;
constexpr int kIW = kTW + 2 * kR;

__device__ __forceinline__ int mirror(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// grid (ceil(W / kTW), ceil(H / kTH), B), block (kTW, kTH).
template <typename T>
__global__ void __launch_bounds__(kTW * kTH)
    conv7_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const T* __restrict__ bias, T* __restrict__ y, int H,
                 int W, int Cin, int Cout, int reflect) {
  __shared__ float tile[kCK][kIH][kIW];
  __shared__ float4 wsm[49][kCK];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTW + tx;
  const int b = blockIdx.z;
  const int ox = blockIdx.x * kTW + tx;
  const int oy = blockIdx.y * kTH + ty;
  const int gx0 = blockIdx.x * kTW - kR;
  const int gy0 = blockIdx.y * kTH - kR;
  const T* xb = x + (size_t)b * H * W * Cin;

  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
  for (int c0 = 0; c0 < Cin; c0 += kCK) {
    const int ck = min(kCK, Cin - c0);
    for (int i = tid; i < kIH * kIW * kCK; i += kTW * kTH) {
      const int c = i % kCK;
      const int pix = i / kCK;
      const int r = pix / kIW;
      const int col = pix - r * kIW;
      float v = 0.f;
      if (c < ck) {
        int gy = gy0 + r;
        int gx = gx0 + col;
        if (reflect) {
          gy = mirror(gy, H);
          gx = mirror(gx, W);
        }
        // Past the far edge of a ragged last tile even a mirrored index can
        // fall outside; those cells feed only masked outputs.
        if (gy >= 0 && gy < H && gx >= 0 && gx < W)
          v = to_f32(xb[((size_t)gy * W + gx) * Cin + c0 + c]);
      }
      tile[c][r][col] = v;
    }
    for (int i = tid; i < 49 * kCK; i += kTW * kTH) {
      const int c = i % kCK;
      const int t = i / kCK;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < ck) {
        const T* wp = w + ((size_t)t * Cin + c0 + c) * Cout;
        v.x = to_f32(wp[0]);
        if (Cout > 1) v.y = to_f32(wp[1]);
        if (Cout > 2) v.z = to_f32(wp[2]);
        if (Cout > 3) v.w = to_f32(wp[3]);
      }
      wsm[t][c] = v;
    }
    __syncthreads();
    for (int c = 0; c < ck; ++c) {
#pragma unroll
      for (int dy = 0; dy < 7; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 7; ++dx) {
          const float v = tile[c][ty + dy][tx + dx];
          const float4 wv = wsm[dy * 7 + dx][c];
          acc0 = fmaf(v, wv.x, acc0);
          acc1 = fmaf(v, wv.y, acc1);
          acc2 = fmaf(v, wv.z, acc2);
          acc3 = fmaf(v, wv.w, acc3);
        }
      }
    }
    __syncthreads();
  }
  if (ox < W && oy < H) {
    T* yp = y + (((size_t)b * H + oy) * W + ox) * Cout;
    yp[0] = from_f32<T>(acc0 + to_f32(bias[0]));
    if (Cout > 1) yp[1] = from_f32<T>(acc1 + to_f32(bias[1]));
    if (Cout > 2) yp[2] = from_f32<T>(acc2 + to_f32(bias[2]));
    if (Cout > 3) yp[3] = from_f32<T>(acc3 + to_f32(bias[3]));
  }
}

template <typename T>
cudaError_t fwd(const void* x, const void* w, const void* bias, void* y,
                int B, int H, int W, int Cin, int Cout, int reflect,
                cudaStream_t stream) {
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  conv7_kernel<T><<<grid, dim3(kTW, kTH), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(y), H, W, Cin, Cout,
      reflect);
  return cudaGetLastError();
}

}  // namespace

// The tensor-core kernel of csrc/conv7_tc.cu (bf16).
cudaError_t conv7_fwd_bf16_mma(const void* x, const void* w, const void* bias,
                               void* y, int B, int H, int W, int Cin,
                               int Cout, int reflect, cudaStream_t stream);

// x: (B, H, W, Cin); w: HWIO (7, 7, Cin, Cout), Cout <= 4; bias: (Cout,);
// y: (B, H, W, Cout); all fp32 (FMA), or all bf16 when is_bf16 (mma.sync;
// Cin % 4 == 0, Cin <= 256). Reflect needs H, W >= 4.
extern "C" cudaError_t uig_conv7_fwd(const void* x, const void* w,
                                     const void* bias, void* y, int B, int H,
                                     int W, int Cin, int Cout, int reflect,
                                     int is_bf16, cudaStream_t stream) {
  return is_bf16 ? conv7_fwd_bf16_mma(x, w, bias, y, B, H, W, Cin, Cout,
                                      reflect, stream)
                 : fwd<float>(x, w, bias, y, B, H, W, Cin, Cout, reflect,
                              stream);
}
