// K4s in bf16 on Hopper's tensor cores: the forward, the input gradient and
// the weight gradient of the square k x k conv with zero padding and a
// stride over NHWC bf16 (the generator's 3x3 stride-2 pad-1 downsamples
// d128: 64 -> 128 channels at 256^2, d256: 128 -> 256 at 128^2; with stride
// 1 and no padding the generic VALID conv). In fp32 the forward runs the FMA
// core of csrc/conv3s2.cu and the dgrad and wgrad the three-term TF32 split
// of csrc/conv3s2_tf32.cu; csrc/conv3s2.cu's entry points launch all three
// designs.
//   fwd:   x (B, H, W, C), w (k, k, C, F) [+ bias (F,)] -> y (B, Ho, Wo, F)
//   dgrad: dy (B, Ho, Wo, F), wt (k, k, F, C) -> dx (B, H, W, C)
//   wgrad: x, dy (B, Ho, Wo, F) -> dw (k, k, C, F)
//
// Replaces: src/uig/kernels/conv_pallas.py, conv3s2_s2d and conv_core
// through _conv5_impl -> _conv5_kernel (fwd; dgrad: the same kernel on the
// padded dy with _dgrad_weights, from _make_conv5's backward) and
// _wgrad5_impl -> _wgrad5_kernel (wgrad).
//
// Bound on this card (H100 SXM data sheet, 700 W): each path shape at batch
// 16 is 2 * 16 * 128^2 * 128 * 9 * 64 = 3.87e10 FLOP, 0.039 ms at the
// 989 TFLOP/s bf16 tensor-core rate, for each of the three. d128 moves 201
// MB (x or dx 134 MB, y or dy 67 MB), 0.060 ms at 3.35 TB/s: bytes bound
// it. d256 moves 101 MB, 0.030 ms: operations bound it. On fp32 FMAs the
// same FLOPs take 0.58 ms, so the kernels issue wgmma (bf16 products,
// exact in fp32, summed into fp32 accumulators in registers) and keep the
// tensor cores fed from a ring of shared-memory stages that the loads fill
// while the products run.
//
// Design: implicit GEMM on the ring of csrc/wgmma.cuh (mainloop), K in
// chunks of 64 channels of one tap (a ragged channel count is a chunk whose
// missing channels are zero). A block is two consumer warpgroups (256
// threads); each issues wgmma.mma_async.m64nNk16.f32.bf16.bf16 (N = 128, or
// 64 for the dgrad where C <= 64) on 128-byte-swizzled tiles of a
// kStages-deep ring. The A side is a gather: cp.async with src-size zero
// fill for padding, ragged edges and missing channels, 16-byte pieces when
// A's channel count is a multiple of 8 and 8-byte pieces otherwise. The B
// side is a plain row-major matrix: TMA (cp.async.bulk.tensor, 64 x 64
// boxes, completion on an mbarrier) when its row length is a multiple of 8,
// which covers the path; cp.async otherwise. TMA leaves the threads' issue
// slots to the A gather: on an H100 the forward and wgrad ran 10-15% faster
// at the path shapes than with B by 16-byte cp.async. The three kernels
// run one ring and differ in their loaders and epilogues. The order of
// every sum is fixed, no atomics: repeats are bit-equal.
//   fwd:   M = output pixels of the whole batch (128 a block), N = F (128 a
//          block), K = (tap, c): A is K-major (a row is one output pixel's
//          64 channels of the tap), B is the HWIO weight as a (k k C, F)
//          row-major matrix, N-major (imm-trans-b). Epilogue: acc + bias in
//          fp32, one round to nearest even, masked store of the edge.
//   dgrad: the adjoint, gathered by stride-parity class as the fp32 dgrad
//          of csrc/conv3s2_tf32.cu: a dx pixel (i, j) receives the outputs whose
//          window holds it, through the taps di with stride | (i + pad -
//          di), which depend only on (i mod s, j mod s). A block owns one
//          class: M = the class's dx pixels of the whole batch, N = C, K =
//          (tap of the class, 64-channel chunk of F); A rows are dy pixels
//          at the tap's offset, zero outside dy; B is the rows of wt. The
//          3x3 stride-2 classes have 1, 2, 2 and 4 taps: no zero-stuffed dy
//          and no product with a structural zero. Their K is short (2-8
//          stages at d128, 4-16 at d256): the ring's prologue loads only
//          the stages that exist, and a block's epilogue overlaps the next
//          resident block's loads (two blocks an SM).
//   wgrad: M = (tap, c): each warpgroup owns a slice of 64 channels of one
//          tap (two slices a block), N = F, K = pixels of the whole batch,
//          cut into ordered chunks of a multiple of 64 pixels. A (a strided
//          gather of x at the slice's tap) and B (rows of dy) are both
//          MN-major in shared memory and read transposed (imm-trans-a/b).
//          Each block writes its fp32 partial (chunks, k k C, F); the
//          reduce kernel of csrc/conv3s2.cu sums the chunks in order and
//          rounds once.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kMaxTaps = 49;  // k <= 7, as csrc/conv3s2.cu checks

// ------------------------------------------------------------------ fwd --
// grid (ceil(B Ho Wo / 128), ceil(F / 128)), block 256, kSmemBytes<128>
// dynamic.
// Stage layout: A rows 0..127 (2 tiles: one per warpgroup), then B's two
// N-major tiles.
template <int VA, bool TMA_B>
__global__ void __launch_bounds__(kThreads, 2)
    conv_fwd_wgmma_kernel(const bf16* __restrict__ x,
                          const bf16* __restrict__ w,
                          const bf16* __restrict__ bias, bf16* __restrict__ y,
                          const __grid_constant__ CUtensorMap w_map, int B,
                          int H, int W, int C, int F, int Ho, int Wo, int k,
                          int stride, int pad) {
  constexpr int kPieces = 128 / VA;             // pieces of a 128-byte row
  constexpr int kRowsPerPass = kThreads / kPieces;
  constexpr int kPasses = 128 / kRowsPerPass;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;

  const int tid = threadIdx.x;
  const int M = B * Ho * Wo;
  const int m0 = blockIdx.x * 128;
  const int n0 = blockIdx.y * 128;
  const int cchunks = (C + 63) / 64;

  // the thread's A rows: output pixel -> first pixel of its image, top-left
  // input corner
  const int piece = tid % kPieces;
  const int ce = piece * (VA / 2);  // first channel of the piece in a chunk
  int a_img[kPasses], a_iy[kPasses], a_ix[kPasses];
#pragma unroll
  for (int q = 0; q < kPasses; ++q) {
    const int m = m0 + tid / kPieces + q * kRowsPerPass;
    const bool ok = m < M;
    const int mm = ok ? m : 0;
    const int b = mm / (Ho * Wo);
    const int r = mm - b * Ho * Wo;
    const int oy = r / Wo;
    a_img[q] = b * H * W;
    // an out-of-range row gets a corner that no tap brings inside the image
    a_iy[q] = ok ? oy * stride - pad : -(1 << 20);
    a_ix[q] = (r - oy * Wo) * stride - pad;
  }

  auto load = [&](int kc, int s, uint64_t* bar) {
    const int tap = kc / cchunks;
    const int c0 = (kc - tap * cchunks) * 64;
    const int di = tap / k, dj = tap - di * k;
    const uint32_t st = base + s * kStageBytes<128>;
    const int c = c0 + ce;
#pragma unroll
    for (int q = 0; q < kPasses; ++q) {
      const int row = tid / kPieces + q * kRowsPerPass;
      const int iy = a_iy[q] + di, ix = a_ix[q] + dj;
      const bool ok = c < C && iy >= 0 && iy < H && ix >= 0 && ix < W;
      const bf16* src =
          ok ? x + ((size_t)a_img[q] + iy * W + ix) * C + c : x;
      const uint32_t off = VA == 16 ? swz(row, piece)
                                    : swz(row, piece >> 1) + (piece & 1) * 8;
      cp_async<VA>(st + off, src, ok ? VA : 0);
    }
    load_b<128, TMA_B>(st + 2 * kTileBytes, &w_map, bar, w, tap * C + c0,
                       tap * C + min(c0 + 64, C), F, n0, tid);
    cp_async_commit();
  };

  const int wg = tid / 128, t = tid % 128;
  float d[64];
  mainloop<128, TMA_B, false>(d, base, k * k * cchunks, wg, load);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + wg * 64 + acc_row(t, h);
    if (m >= M) continue;
    bf16* yr = y + (size_t)m * F;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + acc_col(t, j);
      if (n >= F) continue;  // F % 4 == 0: n and n + 1 are both in or out
      float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
      if (bias != nullptr) {
        v0 += __bfloat162float(bias[n]);
        v1 += __bfloat162float(bias[n + 1]);
      }
      *reinterpret_cast<__nv_bfloat162*>(yr + n) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

// ---------------------------------------------------------------- wgrad --
// grid (ceil(k k ceil(C / 64) / 2), ceil(F / 128), chunks), block 256,
// kSmemBytes<128> dynamic. Warpgroup g of block x owns slice 2 x + g: tap
// slice / ceil(C / 64), channels 64 (slice % ceil(C / 64)) + 0..63. Block z
// sums pixels [z per_chunk, (z + 1) per_chunk) of the batch's B Ho Wo
// outputs, 64 a stage, and writes part[z] as (k k C, F) in fp32. Stage
// layout: the two slices' A tiles (64 pixels x 64 channels, channels
// contiguous), then B's two F-contiguous tiles (64 pixels x 64 of F).
template <int VA, bool TMA_B>
__global__ void __launch_bounds__(kThreads, 2)
    conv_wgrad_wgmma_kernel(const bf16* __restrict__ x,
                            const bf16* __restrict__ dy,
                            float* __restrict__ part,
                            const __grid_constant__ CUtensorMap dy_map, int B,
                            int H, int W, int C, int F, int Ho, int Wo, int k,
                            int stride, int pad, int per_chunk) {
  constexpr int kPieces = 128 / VA;
  constexpr int kRowsPerPass = kThreads / kPieces;
  constexpr int kPasses = 64 / kRowsPerPass;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;

  const int tid = threadIdx.x;
  const int HWo = Ho * Wo;
  const int P = B * HWo;
  const int p0 = blockIdx.z * per_chunk;
  const int p1 = min(p0 + per_chunk, P);
  const int n0 = blockIdx.y * 128;
  const int spt = (C + 63) / 64;  // slices a tap
  const int nslices = k * k * spt;

  // the two slices: tap offsets and the thread's channel in each
  const int piece = tid % kPieces;
  int s_di[2], s_dj[2], s_c[2];
  bool s_ok[2];
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int slice = 2 * blockIdx.x + g;
    const int tap = slice / spt;
    s_di[g] = tap / k;
    s_dj[g] = tap - s_di[g] * k;
    s_c[g] = (slice - tap * spt) * 64 + piece * (VA / 2);
    s_ok[g] = slice < nslices && s_c[g] < C;
  }

  auto load = [&](int kc, int s, uint64_t* bar) {
    const uint32_t st = base + s * kStageBytes<128>;
    const int pk = p0 + kc * 64;
#pragma unroll
    for (int q = 0; q < kPasses; ++q) {
      const int row = tid / kPieces + q * kRowsPerPass;
      const int p = pk + row;
      const bool p_ok = p < p1;
      const int pp = p_ok ? p : p0;
      const int b = pp / HWo;
      const int r = pp - b * HWo;
      const int oy = r / Wo;
      const int iy0 = oy * stride - pad, ix0 = (r - oy * Wo) * stride - pad;
      const bf16* img = x + (size_t)b * H * W * C;
      const uint32_t off = VA == 16 ? swz(row, piece)
                                    : swz(row, piece >> 1) + (piece & 1) * 8;
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int iy = iy0 + s_di[g], ix = ix0 + s_dj[g];
        const bool ok = p_ok && s_ok[g] && iy >= 0 && iy < H && ix >= 0 &&
                        ix < W;
        const bf16* src = ok ? img + ((size_t)iy * W + ix) * C + s_c[g] : x;
        cp_async<VA>(st + g * kTileBytes + off, src, ok ? VA : 0);
      }
    }
    load_b<128, TMA_B>(st + 2 * kTileBytes, &dy_map, bar, dy, pk, p1, F, n0,
                       tid);
    cp_async_commit();
  };

  const int wg = tid / 128, t = tid % 128;
  float d[64];
  mainloop<128, TMA_B, true>(d, base, (p1 - p0 + 63) / 64, wg, load);

  const int slice = 2 * blockIdx.x + wg;
  if (slice >= nslices) return;
  const int tap = slice / spt;
  const int c0 = (slice - tap * spt) * 64;
  float* pz = part + (size_t)blockIdx.z * k * k * C * F;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = c0 + acc_row(t, h);
    if (c >= C) continue;
    float* pr = pz + ((size_t)tap * C + c) * F;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + acc_col(t, j);
      if (n >= F) continue;
      *reinterpret_cast<float2*>(pr + n) =
          make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------- dgrad --
// grid (ceil(B ceil(H / s) ceil(W / s) / 128), ceil(C / BN), s^2), block
// 256, kSmemBytes<BN> dynamic. Block z owns the stride-parity class z =
// (i mod s) s + (j mod s) of dx pixels (i, j); M = the class's pixels of
// the whole batch (128 a block), N = C (BN a block), K = (tap of the
// class, 64-channel chunk of F). A row is one dx pixel's 64 channels of dy
// at the tap's output pixel (K-major, zero outside dy); B is wt as a
// (k k F, C) row-major matrix, N-major. Stage layout as the forward's,
// with BN / 64 B tiles.
template <int BN, int VA, bool TMA_B>
__global__ void __launch_bounds__(kThreads, 2)
    conv_dgrad_wgmma_kernel(const bf16* __restrict__ dy,
                            const bf16* __restrict__ wt,
                            bf16* __restrict__ dx,
                            const __grid_constant__ CUtensorMap wt_map, int B,
                            int H, int W, int C, int F, int Ho, int Wo, int k,
                            int stride, int pad) {
  constexpr int kPieces = 128 / VA;  // pieces of a 128-byte row
  constexpr int kRowsPerPass = kThreads / kPieces;
  constexpr int kPasses = 128 / kRowsPerPass;
  __shared__ int tap_row[kMaxTaps];  // (di k + dj) F: the tap's rows of wt
  __shared__ int tap_oy[kMaxTaps];   // oy - a for dx row i = s a + pi
  __shared__ int tap_ox[kMaxTaps];   // ox - e for dx column j = s e + pj
  __shared__ int n_taps;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;

  const int tid = threadIdx.x;
  const int s = stride;
  const int pi = blockIdx.z / s, pj = blockIdx.z - pi * s;
  const int Hc = (H - pi + s - 1) / s, Wc = (W - pj + s - 1) / s;
  const int HWc = Hc * Wc;
  const int M = B * HWc;
  const int m0 = blockIdx.x * 128;
  const int n0 = blockIdx.y * BN;
  if (m0 >= M) return;  // the whole block: this class has fewer pixels

  // the class's taps, rows then columns ascending: the fixed order of sums
  if (tid == 0) {
    int nt = 0;
    for (int di = 0; di < k; ++di) {
      const int ry = pi + pad - di;
      if (((ry % s) + s) % s) continue;
      for (int dj = 0; dj < k; ++dj) {
        const int rx = pj + pad - dj;
        if (((rx % s) + s) % s) continue;
        tap_row[nt] = (di * k + dj) * F;
        tap_oy[nt] = ry / s;  // exact: s divides ry
        tap_ox[nt] = rx / s;
        ++nt;
      }
    }
    n_taps = nt;
  }
  __syncthreads();
  const int fchunks = (F + 63) / 64;

  // the thread's A rows: dx pixel -> first pixel of its image in dy, and
  // its class coordinates (a, e)
  const int piece = tid % kPieces;
  const int ce = piece * (VA / 2);  // first channel of the piece in a chunk
  int a_img[kPasses], a_a[kPasses], a_e[kPasses];
#pragma unroll
  for (int q = 0; q < kPasses; ++q) {
    const int m = m0 + tid / kPieces + q * kRowsPerPass;
    const bool ok = m < M;
    const int mm = ok ? m : 0;
    const int b = mm / HWc;
    const int r = mm - b * HWc;
    const int a = r / Wc;
    a_img[q] = b * Ho * Wo;
    // an out-of-range row gets a class row that no tap brings inside dy
    a_a[q] = ok ? a : -(1 << 20);
    a_e[q] = r - a * Wc;
  }

  auto load = [&](int kc, int st_idx, uint64_t* bar) {
    const int tp = kc / fchunks;
    const int o0 = (kc - tp * fchunks) * 64;
    const uint32_t st = base + st_idx * kStageBytes<BN>;
    const int o = o0 + ce;
    const int oy0 = tap_oy[tp], ox0 = tap_ox[tp];
#pragma unroll
    for (int q = 0; q < kPasses; ++q) {
      const int row = tid / kPieces + q * kRowsPerPass;
      const int oy = a_a[q] + oy0, ox = a_e[q] + ox0;
      const bool ok = o < F && oy >= 0 && oy < Ho && ox >= 0 && ox < Wo;
      const bf16* src =
          ok ? dy + ((size_t)a_img[q] + oy * Wo + ox) * F + o : dy;
      const uint32_t off = VA == 16 ? swz(row, piece)
                                    : swz(row, piece >> 1) + (piece & 1) * 8;
      cp_async<VA>(st + off, src, ok ? VA : 0);
    }
    load_b<BN, TMA_B>(st + 2 * kTileBytes, &wt_map, bar, wt, tap_row[tp] + o0,
                      tap_row[tp] + min(o0 + 64, F), C, n0, tid);
    cp_async_commit();
  };

  const int wg = tid / 128, t = tid % 128;
  float d[BN / 2];
  mainloop<BN, TMA_B, false>(d, base, n_taps * fchunks, wg, load);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + wg * 64 + acc_row(t, h);
    if (m >= M) continue;
    const int b = m / HWc;
    const int r = m - b * HWc;
    const int a = r / Wc, e = r - (r / Wc) * Wc;
    bf16* o = dx + (((size_t)b * H + s * a + pi) * W + s * e + pj) * C;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + acc_col(t, j);
      if (n >= C) continue;  // C % 4 == 0: n and n + 1 are both in or out
      *reinterpret_cast<__nv_bfloat162*>(o + n) =
          __floats2bfloat162_rn(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
    }
  }
}

// ------------------------------------------------------------------ host --
template <int VA, bool TMA_B>
cudaError_t fwd(const void* x, const void* w, const void* bias, void* y,
                const CUtensorMap& map, int B, int H, int W, int C, int F,
                int k, int stride, int pad, cudaStream_t stream) {
  const auto kernel = conv_fwd_wgmma_kernel<VA, TMA_B>;
  cudaError_t err = allow_smem<128>(kernel);
  if (err != cudaSuccess) return err;
  const int Ho = (H + 2 * pad - k) / stride + 1;
  const int Wo = (W + 2 * pad - k) / stride + 1;
  const long long M = (long long)B * Ho * Wo;
  const dim3 grid((unsigned)((M + 127) / 128), (F + 127) / 128);
  kernel<<<grid, kThreads, kSmemBytes<128>, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(bias), static_cast<bf16*>(y), map, B, H, W, C,
      F, Ho, Wo, k, stride, pad);
  return cudaGetLastError();
}

template <int VA, bool TMA_B>
cudaError_t wgrad(const void* x, const void* dy, float* part,
                  const CUtensorMap& map, int B, int H, int W, int C, int F,
                  int k, int stride, int pad, int chunks, int per_chunk,
                  cudaStream_t stream) {
  const auto kernel = conv_wgrad_wgmma_kernel<VA, TMA_B>;
  cudaError_t err = allow_smem<128>(kernel);
  if (err != cudaSuccess) return err;
  const int Ho = (H + 2 * pad - k) / stride + 1;
  const int Wo = (W + 2 * pad - k) / stride + 1;
  const int nslices = k * k * ((C + 63) / 64);
  const dim3 grid((nslices + 1) / 2, (F + 127) / 128, chunks);
  kernel<<<grid, kThreads, kSmemBytes<128>, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), part, map, B,
      H, W, C, F, Ho, Wo, k, stride, pad, per_chunk);
  return cudaGetLastError();
}

template <int BN, int VA, bool TMA_B>
cudaError_t dgrad(const void* dy, const void* wt, void* dx,
                  const CUtensorMap& map, int B, int H, int W, int C, int F,
                  int k, int stride, int pad, cudaStream_t stream) {
  const auto kernel = conv_dgrad_wgmma_kernel<BN, VA, TMA_B>;
  cudaError_t err = allow_smem<BN>(kernel);
  if (err != cudaSuccess) return err;
  const int Ho = (H + 2 * pad - k) / stride + 1;
  const int Wo = (W + 2 * pad - k) / stride + 1;
  const int s = stride;
  const long long mc = (long long)B * ((H + s - 1) / s) * ((W + s - 1) / s);
  const dim3 grid((unsigned)((mc + 127) / 128), (C + BN - 1) / BN, s * s);
  kernel<<<grid, kThreads, kSmemBytes<BN>, stream>>>(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(wt),
      static_cast<bf16*>(dx), map, B, H, W, C, F, Ho, Wo, k, stride, pad);
  return cudaGetLastError();
}

}  // namespace

// bf16 forward, called by uig_conv_fwd (csrc/conv3s2.cu) with its shape
// checks done: x (B, H, W, C), w (k, k, C, F), bias (F,) or null, y (B, Ho,
// Wo, F).
cudaError_t conv_fwd_bf16_wgmma(const void* x, const void* w,
                                const void* bias, void* y, int B, int H,
                                int W, int C, int F, int k, int stride,
                                int pad, cudaStream_t stream) {
  CUtensorMap map = {};
  cudaError_t err;
  const bool tma = b_map(&map, w, k * k * C, F, &err);
  if (err != cudaSuccess) return err;
  return dispatch(C, tma, [&](auto va, auto tma_b) {
    return fwd<decltype(va)::value, decltype(tma_b)::value>(
        x, w, bias, y, map, B, H, W, C, F, k, stride, pad, stream);
  });
}

// bf16 weight gradient's first pass, called by uig_conv_wgrad: x (B, H, W,
// C), dy (B, Ho, Wo, F) -> part (chunks, k k C, F) fp32, chunk z summing
// pixels [z per_chunk, (z + 1) per_chunk).
cudaError_t conv_wgrad_bf16_wgmma(const void* x, const void* dy, float* part,
                                  int B, int H, int W, int C, int F, int k,
                                  int stride, int pad, int chunks,
                                  int per_chunk, cudaStream_t stream) {
  const int Ho = (H + 2 * pad - k) / stride + 1;
  const int Wo = (W + 2 * pad - k) / stride + 1;
  CUtensorMap map = {};
  cudaError_t err;
  const bool tma = b_map(&map, dy, B * Ho * Wo, F, &err);
  if (err != cudaSuccess) return err;
  return dispatch(C, tma, [&](auto va, auto tma_b) {
    return wgrad<decltype(va)::value, decltype(tma_b)::value>(
        x, dy, part, map, B, H, W, C, F, k, stride, pad, chunks, per_chunk,
        stream);
  });
}

// bf16 input gradient, called by uig_conv_dgrad: dy (B, Ho, Wo, F), wt (k,
// k, F, C) -> dx (B, H, W, C). N = C in 64-wide tiles (wgmma m64n64k16)
// when C <= 64, else 128-wide; A's pieces follow F, the channels it reads.
cudaError_t conv_dgrad_bf16_wgmma(const void* dy, const void* wt, void* dx,
                                  int B, int H, int W, int C, int F, int k,
                                  int stride, int pad, cudaStream_t stream) {
  CUtensorMap map = {};
  cudaError_t err;
  const bool tma = b_map(&map, wt, k * k * F, C, &err);
  if (err != cudaSuccess) return err;
  return dispatch(F, tma, [&](auto va, auto tma_b) {
    constexpr int VA = decltype(va)::value;
    constexpr bool TMA_B = decltype(tma_b)::value;
    return C <= 64 ? dgrad<64, VA, TMA_B>(dy, wt, dx, map, B, H, W, C, F, k,
                                          stride, pad, stream)
                   : dgrad<128, VA, TMA_B>(dy, wt, dx, map, B, H, W, C, F, k,
                                           stride, pad, stream);
  });
}
