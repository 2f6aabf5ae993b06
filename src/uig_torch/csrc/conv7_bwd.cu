// Backward of the 7x7 stride-1 pad-3 conv (reflect or zeros) over NHWC fp32
// or bf16 for few output channels (the generator head, Cin 64 -> Cout 3):
//   dgrad: dy (B, H, W, Cout), w (7, 7, Cin, Cout) -> dx (B, H, W, Cin)
//   wgrad: x (B, H, W, Cin), dy (B, H, W, Cout) -> dw (7, 7, Cin, Cout)
//
// Replaces: src/uig/kernels/conv_pallas.py, _conv5_impl with fold=True (the
// dgrad: a full correlation of the padded dy with flipped weights, then
// _fold_block adds the gradient of the reflect ring onto its mirrored
// sources in VMEM) and _wgrad5_impl -> _wgrad5_kernel (patch^T . dy
// accumulated across the sequential grid into a VMEM-resident block).
//
// Bound on this card: operations, for both. Each is 2 * B * H * W * 49 * Cin
// * Cout FLOP, the forward's count: 9.87 GFLOP at B = 8 and 256^2, about
// 0.147 ms at the H100 SXM data-sheet 67 TFLOP/s fp32 (700 W). The dgrad's
// dx write (134 MB at B = 8) takes ~0.040 ms at 3.35 TB/s.
//
// bf16: both run on the tensor cores, which uig_conv7_dgrad and
// uig_conv7_wgrad launch for bf16: the dgrad in csrc/conv7_bwd_tc.cu, the
// wgrad in csrc/conv7_wgrad_tc.cu (fp32 sums, dw rounded once to bf16, the
// cotangent of JAX's weight cast). The kernels below run fp32 only.
//
// dgrad design (fp32): one thread per dx pixel and 32 input channels (32 sums in
// registers); a 32 x 8 block stages the dy tile plus a 3-pixel halo in
// shared memory (Cout padded to a float4, zero outside the image) and the
// chunk's 7 x 7 x 32 weights as float4 broadcasts. The padded gradient at
// padded position p is sum_k dy[p - k] * w[k]; in reflect mode a dx pixel
// within 3 of an edge also receives the padded positions that mirror onto
// it (up to two more rows and columns), summed in a fixed order: the fold
// happens in registers, so no padded gradient is ever written. Every dy
// value a mirrored position needs lies in the same halo tile.
//
// wgrad design (fp32): a 9408-output reduction over B * H * W pixels. A block owns
// 32 input channels (lanes) x 7 kernel rows (warps) and walks a contiguous
// run of 8 x 16 pixel tiles; each thread keeps its 7 x Cout sums for one
// (ky, channel) in registers and slides a window of 7 x values along a tile
// row, so each FMA group needs one shared load of x and one broadcast of dy.
// The x tile is read with reflect mirroring (or zeros) in the loader: the
// plane the forward saw. Each block writes its partial dw; a second pass
// sums the partials in block order. No atomics: repeat runs are bit-equal.
#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

constexpr int kR = 3;  // halo of a 7x7 window

__device__ __forceinline__ int mirror(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

template <typename T>
__device__ __forceinline__ float4 pick(const T* p, int cout) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  v.x = to_f32(p[0]);
  if (cout > 1) v.y = to_f32(p[1]);
  if (cout > 2) v.z = to_f32(p[2]);
  if (cout > 3) v.w = to_f32(p[3]);
  return v;
}

// ---------------------------------------------------------------- dgrad --
constexpr int kDW = 32;  // dx columns per block
constexpr int kDH = 8;   // dx rows per block
constexpr int kDC = 32;  // input channels per block
constexpr int kDIH = kDH + 2 * kR;
constexpr int kDIW = kDW + 2 * kR;

template <int CO>
__device__ __forceinline__ void dot_acc(float (&acc)[kDC], const float4 v,
                                        const float4* __restrict__ wrow) {
#pragma unroll
  for (int c = 0; c < kDC; ++c) {
    const float4 wv = wrow[c];
    float a = acc[c];
    a = fmaf(v.x, wv.x, a);
    if (CO > 1) a = fmaf(v.y, wv.y, a);
    if (CO > 2) a = fmaf(v.z, wv.z, a);
    if (CO > 3) a = fmaf(v.w, wv.w, a);
    acc[c] = a;
  }
}

// Padded rows (or columns) whose reflect mirror is dx row i, besides the
// main one i + 3: top ring rows 0..2 (row 3 - i) and bottom ring rows
// (row 2n + 1 - i). Returns how many were written to out[].
__device__ __forceinline__ int ring_sources(int i, int n, int* out) {
  int k = 0;
  if (i >= 1 && i <= kR) out[k++] = kR - i;
  if (i >= n - 1 - kR && i <= n - 2) out[k++] = 2 * n + 1 - i;
  return k;
}

// grid (ceil(W / kDW), ceil(H / kDH), B * ceil(Cin / kDC)), block (kDW, kDH).
template <typename T, int CO>
__global__ void __launch_bounds__(kDW * kDH)
    conv7_dgrad_kernel(const T* __restrict__ dy,
                       const T* __restrict__ w, T* __restrict__ dx,
                       int H, int W, int Cin, int reflect) {
  __shared__ float4 dyt[kDIH][kDIW];
  __shared__ float4 wsm[49][kDC];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kDW + tx;
  const int groups = (Cin + kDC - 1) / kDC;
  const int b = blockIdx.z / groups;
  const int c0 = (blockIdx.z - b * groups) * kDC;
  const int i0 = blockIdx.y * kDH, j0 = blockIdx.x * kDW;
  const T* dyb = dy + (size_t)b * H * W * CO;

  for (int q = tid; q < kDIH * kDIW; q += kDW * kDH) {
    const int r = q / kDIW, col = q - r * kDIW;
    const int gy = i0 - kR + r, gx = j0 - kR + col;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = pick(dyb + ((size_t)gy * W + gx) * CO, CO);
    dyt[r][col] = v;
  }
  for (int q = tid; q < 49 * kDC; q += kDW * kDH) {
    const int c = q % kDC, t = q / kDC;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c0 + c < Cin) v = pick(w + ((size_t)t * Cin + c0 + c) * CO, CO);
    wsm[t][c] = v;
  }
  __syncthreads();

  const int i = i0 + ty, j = j0 + tx;
  float acc[kDC];
#pragma unroll
  for (int c = 0; c < kDC; ++c) acc[c] = 0.f;
  // main source: padded position (i + 3, j + 3); dy row i + 3 - ky sits at
  // tile row ty + 6 - ky
#pragma unroll 1
  for (int ky = 0; ky < 7; ++ky)
#pragma unroll 1
    for (int kx = 0; kx < 7; ++kx)
      dot_acc<CO>(acc, dyt[ty + 6 - ky][tx + 6 - kx], wsm[ky * 7 + kx]);
  if (reflect) {
    // the ring: padded rows x padded columns that mirror onto (i, j), each
    // pair except (main, main), in a fixed order
    int rows[3], cols[3];
    rows[0] = i + kR;
    cols[0] = j + kR;
    const int nr = 1 + ring_sources(i, H, rows + 1);
    const int nc = 1 + ring_sources(j, W, cols + 1);
    for (int a = 0; a < nr; ++a)
      for (int e = 0; e < nc; ++e) {
        if (a == 0 && e == 0) continue;
        for (int ky = 0; ky < 7; ++ky) {
          const int tr = rows[a] - ky - i0 + kR;
          if (tr < 0 || tr >= kDIH) continue;
          for (int kx = 0; kx < 7; ++kx) {
            const int tc = cols[e] - kx - j0 + kR;
            if (tc < 0 || tc >= kDIW) continue;
            dot_acc<CO>(acc, dyt[tr][tc], wsm[ky * 7 + kx]);
          }
        }
      }
  }
  if (i < H && j < W) {
    T* o = dx + (((size_t)b * H + i) * W + j) * Cin + c0;
    const int n = min(kDC, Cin - c0);  // a multiple of 4
#pragma unroll
    for (int c = 0; c < kDC; c += 4)
      if (c < n)
        store4(o + c, make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]));
  }
}

// ---------------------------------------------------------------- wgrad --
constexpr int kWW = 16;  // pixel columns per tile
constexpr int kWH = 8;   // pixel rows per tile
constexpr int kWC = 32;  // input channels per block (lanes)
constexpr int kWIH = kWH + 2 * kR;
constexpr int kWIW = kWW + 2 * kR;

// grid (chunks, ceil(Cin / kWC)), block (kWC, 7). Block `chunk` walks tiles
// [chunk * tiles_per_chunk, ...) of the (B, ceil(H / kWH), ceil(W / kWW))
// tile grid and writes part[chunk] as (49, Cin, CO).
template <typename T, int CO>
__global__ void __launch_bounds__(kWC * 7)
    conv7_wgrad_kernel(const T* __restrict__ x,
                       const T* __restrict__ dy, float* __restrict__ part,
                       int B, int H, int W, int Cin, int reflect,
                       int tiles_per_chunk) {
  __shared__ float xs[kWIH][kWIW][kWC];
  __shared__ float4 dys[kWH][kWW];

  const int lane = threadIdx.x, ky = threadIdx.y;
  const int tid = ky * kWC + lane;
  const int nthreads = kWC * 7;
  const int c0 = blockIdx.y * kWC;
  const int tiles_x = (W + kWW - 1) / kWW;
  const int tiles_y = (H + kWH - 1) / kWH;
  const int tiles = B * tiles_y * tiles_x;
  const int t0 = blockIdx.x * tiles_per_chunk;
  const int t1 = min(t0 + tiles_per_chunk, tiles);

  float acc[7][CO];
#pragma unroll
  for (int kx = 0; kx < 7; ++kx)
#pragma unroll
    for (int o = 0; o < CO; ++o) acc[kx][o] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const int b = t / (tiles_y * tiles_x);
    const int rem = t - b * tiles_y * tiles_x;
    const int py0 = (rem / tiles_x) * kWH;
    const int px0 = (rem % tiles_x) * kWW;
    const T* xb = x + (size_t)b * H * W * Cin;
    __syncthreads();  // the previous tile's reads are done
    for (int q = tid; q < kWIH * kWIW * kWC; q += nthreads) {
      const int c = q % kWC;
      const int pix = q / kWC;
      const int r = pix / kWIW, col = pix - r * kWIW;
      int gy = py0 - kR + r, gx = px0 - kR + col;
      if (reflect) {
        gy = mirror(gy, H);
        gx = mirror(gx, W);
      }
      float v = 0.f;
      // past the far edge of a ragged tile even a mirrored index can fall
      // outside; those cells meet only dy = 0
      if (c0 + c < Cin && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = to_f32(xb[((size_t)gy * W + gx) * Cin + c0 + c]);
      xs[r][col][c] = v;
    }
    for (int q = tid; q < kWH * kWW; q += nthreads) {
      const int r = q / kWW, col = q - r * kWW;
      const int gy = py0 + r, gx = px0 + col;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gy < H && gx < W)
        v = pick(dy + (((size_t)b * H + gy) * W + gx) * CO, CO);
      dys[r][col] = v;
    }
    __syncthreads();
#pragma unroll 1
    for (int py = 0; py < kWH; ++py) {
      float xw[kWIW];
#pragma unroll
      for (int q = 0; q < kWIW; ++q) xw[q] = xs[py + ky][q][lane];
#pragma unroll
      for (int px = 0; px < kWW; ++px) {
        const float4 d = dys[py][px];
        const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
        for (int kx = 0; kx < 7; ++kx)
#pragma unroll
          for (int o = 0; o < CO; ++o)
            acc[kx][o] = fmaf(xw[px + kx], dv[o], acc[kx][o]);
      }
    }
  }
  if (c0 + lane < Cin) {
    float* p = part + (size_t)blockIdx.x * 49 * Cin * CO;
#pragma unroll
    for (int kx = 0; kx < 7; ++kx)
#pragma unroll
      for (int o = 0; o < CO; ++o)
        p[((size_t)(ky * 7 + kx) * Cin + c0 + lane) * CO + o] = acc[kx][o];
  }
}

// dw[e] = sum over chunks, in order, of part[chunk][e], rounded once to T.
template <typename T>
__global__ void conv7_wgrad_reduce_kernel(const float* __restrict__ part,
                                          T* __restrict__ dw, int n,
                                          int chunks) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int k = 0; k < chunks; ++k) s += part[(size_t)k * n + e];
  dw[e] = from_f32<T>(s);
}

template <typename T, int CO>
cudaError_t dgrad(const void* dy, const void* w, void* dx, int B, int H,
                  int W, int Cin, int reflect, cudaStream_t stream) {
  const int groups = (Cin + kDC - 1) / kDC;
  const dim3 grid((W + kDW - 1) / kDW, (H + kDH - 1) / kDH, B * groups);
  conv7_dgrad_kernel<T, CO><<<grid, dim3(kDW, kDH), 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(w),
      static_cast<T*>(dx), H, W, Cin, reflect);
  return cudaGetLastError();
}

template <typename T, int CO>
cudaError_t wgrad(const void* x, const void* dy, float* part, void* dw,
                  int B, int H, int W, int Cin, int reflect, int chunks,
                  int tiles_per_chunk, cudaStream_t stream) {
  const dim3 grid(chunks, (Cin + kWC - 1) / kWC);
  conv7_wgrad_kernel<T, CO><<<grid, dim3(kWC, 7), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), part, B, H, W, Cin,
      reflect, tiles_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = 49 * Cin * CO;
  conv7_wgrad_reduce_kernel<T><<<(n + 255) / 256, 256, 0, stream>>>(
      part, static_cast<T*>(dw), n, chunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dgrad_co(const void* dy, const void* w, void* dx, int B, int H,
                     int W, int Cin, int Cout, int reflect,
                     cudaStream_t stream) {
  switch (Cout) {
    case 1: return dgrad<T, 1>(dy, w, dx, B, H, W, Cin, reflect, stream);
    case 2: return dgrad<T, 2>(dy, w, dx, B, H, W, Cin, reflect, stream);
    case 3: return dgrad<T, 3>(dy, w, dx, B, H, W, Cin, reflect, stream);
    case 4: return dgrad<T, 4>(dy, w, dx, B, H, W, Cin, reflect, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t wgrad_co(const void* x, const void* dy, float* part, void* dw,
                     int B, int H, int W, int Cin, int Cout, int reflect,
                     int chunks, int tiles_per_chunk, cudaStream_t stream) {
  switch (Cout) {
    case 1: return wgrad<T, 1>(x, dy, part, dw, B, H, W, Cin, reflect, chunks,
                               tiles_per_chunk, stream);
    case 2: return wgrad<T, 2>(x, dy, part, dw, B, H, W, Cin, reflect, chunks,
                               tiles_per_chunk, stream);
    case 3: return wgrad<T, 3>(x, dy, part, dw, B, H, W, Cin, reflect, chunks,
                               tiles_per_chunk, stream);
    case 4: return wgrad<T, 4>(x, dy, part, dw, B, H, W, Cin, reflect, chunks,
                               tiles_per_chunk, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// csrc/conv7_bwd_tc.cu and csrc/conv7_wgrad_tc.cu
cudaError_t conv7_dgrad_bf16_wgmma(const void* dy, const void* w, void* dx,
                                   int B, int H, int W, int Cin, int Cout,
                                   int reflect, cudaStream_t stream);
cudaError_t conv7_wgrad_bf16_wgmma(const void* x, const void* dy, float* part,
                                   void* dw, int B, int H, int W, int Cin,
                                   int Cout, int reflect, int chunks,
                                   cudaStream_t stream);

// dy: (B, H, W, Cout), w: HWIO (7, 7, Cin, Cout), dx: (B, H, W, Cin); all
// fp32 (the FMA kernel), or all bf16 when is_bf16 (the wgmma kernel).
// 1 <= Cout <= 4, Cin % 4 == 0, reflect needs H, W >= 4.
extern "C" cudaError_t uig_conv7_dgrad(const void* dy, const void* w,
                                       void* dx, int B, int H, int W,
                                       int Cin, int Cout, int reflect,
                                       int is_bf16, cudaStream_t stream) {
  if (Cout < 1 || Cout > 4) return cudaErrorInvalidValue;
  return is_bf16 ? conv7_dgrad_bf16_wgmma(dy, w, dx, B, H, W, Cin, Cout,
                                          reflect, stream)
                 : dgrad_co<float>(dy, w, dx, B, H, W, Cin, Cout, reflect,
                                   stream);
}

// x: (B, H, W, Cin), dy: (B, H, W, Cout), dw: (7, 7, Cin, Cout); part:
// (chunks, 49, Cin, Cout) fp32 scratch. All fp32 (the FMA kernel):
// chunks * tiles_per_chunk >= the number of 8 x 16 tiles, B * ceil(H / 8) *
// ceil(W / 16). Or all bf16 when is_bf16 (the wgmma kernel): chunks
// persistent blocks a 64-channel slice, tiles_per_chunk unused; Cin % 4 ==
// 0, Cin <= 256.
extern "C" cudaError_t uig_conv7_wgrad(const void* x, const void* dy,
                                       float* part, void* dw, int B, int H,
                                       int W, int Cin, int Cout, int reflect,
                                       int chunks, int tiles_per_chunk,
                                       int is_bf16, cudaStream_t stream) {
  return is_bf16 ? conv7_wgrad_bf16_wgmma(x, dy, part, dw, B, H, W, Cin, Cout,
                                          reflect, chunks, stream)
                 : wgrad_co<float>(x, dy, part, dw, B, H, W, Cin, Cout,
                                   reflect, chunks, tiles_per_chunk, stream);
}
