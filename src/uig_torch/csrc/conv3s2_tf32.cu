// K4s's fp32 forward, input and weight gradients on Hopper's tensor cores,
// in the three-term TF32 split (csrc/tf32_wgmma.cuh states the numerics):
// the square k x k conv with zero padding and a stride over NHWC fp32 and
// its adjoints, for the generator's 3x3 stride-2 pad-1 downsamples (d128:
// 64 -> 128 channels at 256^2, d256: 128 -> 256 at 128^2; 8 launches of
// each a fp32 training step of cyclegan256_dp, 2 forwards a translate
// apply) and, with stride 1 and no padding, the generic VALID conv.
//   fwd:   x (B, H, W, C), w (k, k, C, F) [+ bias (F,)] -> y (B, Ho, Wo, F)
//   dgrad: dy (B, Ho, Wo, F), w (k, k, C, F) -> dx (B, H, W, C)
//   wgrad: x (B, H, W, C), dy -> part (chunks, k k C, F), summed in chunk
//          order by csrc/conv3s2.cu's conv_wgrad_reduce_kernel
// csrc/conv3s2.cu's entry points launch these and state the TPU kernels
// they replace.
//
// Bound on this card (H100 SXM data sheet, 700 W): each path shape at batch
// 16 is 2 * 16 * 128^2 * 128 * 9 * 64 = 3.87e10 FLOP; as 3 TF32 products
// at 495 TFLOP/s that is 0.2345 ms, against d128's 201 MB (0.060 ms at
// 3.35 TB/s): operations bound all three. On fp32 FMAs (67 TFLOP/s) the
// same FLOPs take 0.578 ms, so the products run on the tensor cores.
//
// fwd: an implicit GEMM on K3's ring (tf32_ring, 4 stages, one block an
//   SM): M = 128 output pixels of one image a block (two consumer
//   warpgroups of 64 rows), N = F (BN = 64 where F <= 64, else 128), K =
//   (tap, 32-channel chunk of C), 9 taps x 2 or 4 chunks at d128 and d256.
//   A rows are x at the tap's strided window, 32 channels in a 128-byte
//   row, gathered by cp.async into the 128B swizzle with zero fill for the
//   padding, for rows past the image's pixels and for the channels missing
//   from a ragged last chunk, and split in registers while the previous
//   stage's products run (K3's gather, with zeros for reflect's mirror and
//   the stride in the index). B: tf32 wgmma reads K-major operands only,
//   and the HWIO weight read as (k k C, F) is N-major, so
//   conv_fwd_wsplit_kernel (wt_split_tile, K3's transposing split for k k
//   taps) first writes W^T's hi and lo planes, (F, k k Cp) fp32 each, into
//   a scratch the wrapper allocates; TMA loads each stage's (32 x BN)
//   boxes (zeros past F). The epilogue adds the bias in fp32 and stores
//   fp32. The tensor core's accumulator takes partials of kFwDepth stages
//   (UIG_K4S_FWD_DEPTH, two stages of 32 channels by default, K3's 64:
//   tools/k4s_depths.py read 0.33-0.51x the plain version's error from
//   float64 at the path shapes; 32 channels 0.25-0.32x at 2-3 % more
//   time; 256 channels 1.11-1.67x at 2 % less, 15 % under the 2x gate
//   every fp32 case is held to; all of K 3.9-6.1x).
// dgrad: an implicit GEMM by stride-parity class, as the bf16 kernel of
//   csrc/conv3s2_tc.cu: a dx pixel (i, j) receives the outputs whose window
//   holds it, through the taps di with stride | (i + pad - di), which depend
//   only on (i mod s, j mod s). A block owns one class: M = 128 of the
//   class's dx pixels over the batch, N = C (BN = 64 where C <= 64, else
//   128), K = (tap of the class, 32-channel chunk of F): 1, 2, 2 and 4 taps
//   for the 3x3 stride-2 classes, no zero-stuffed dy and no product with a
//   structural zero. It runs K3's ring (tf32_ring, 4 stages, one block an
//   SM): A rows are dy pixels at the tap's offset, 32 channels in a
//   128-byte row, gathered by cp.async into the 128B swizzle with zero fill
//   outside dy and past F, and split in registers while the previous
//   stage's products run. B needs no transpose: tf32 wgmma reads K-major
//   operands only, and the K-major form of the dgrad's B, B^T[c][(tap, o)],
//   is the forward's HWIO weight w[tap][c][o] as it lies. conv_wsplit_kernel
//   writes its hi and lo planes, (k k C, Fp) fp32 each (Fp = F rounded up to
//   32, zeros past F, each 32-chunk of o in chunk_channel order), into a
//   scratch the wrapper allocates; TMA loads (32 o x BN c) boxes at the
//   class's taps (the rows past C of a tap belong to the next tap or lie
//   outside and are zeros: they feed only the output columns past C, which
//   are not stored). Blocks take the classes with the most taps first. The
//   tensor core's accumulator takes partials of kDgDepth stages
//   (UIG_K4S_DGRAD_DEPTH, one stage of 32 channels of o by default:
//   tools/k4s_depths.py read 0.83-1.18x the plain version's error from
//   float64 at the path shapes, 1.18-1.64x with 64 channels, at the same
//   speed).
// wgrad: M = (tap, c): each warpgroup owns a slice of 64 channels of one tap
//   (two slices a block), N = F (128 a block), K = the batch's pixels, cut
//   into ordered chunks of whole 32-pixel stages; each block writes its
//   chunk's fp32 partial. Both operands are pixel-major in memory, and tf32
//   wgmma has no transpose, so neither goes to wgmma as it lies:
//   - A, x's strided gather at the slice's tap, is staged by cp.async as
//     32 pixel rows of 64 channels (a 320-byte pitch, so that the four
//     pixel rows of a warp's fragment load fall on both halves of the
//     banks) and goes to wgmma from registers. The order of M's rows within
//     a slice is free (the epilogue writes each row to its own dw row): M
//     row 16 w + g + 8 h is channel 16 w + 2 g + h, so each thread reads
//     its two rows' values of a pixel with one 8-byte load, 8 a stage.
//   - B, dy^T (pixels contiguous), is built by the threads: the stage's raw
//     dy tile (32 pixels x 128 of F, by cp.async) is read down its columns,
//     split, and written as the hi and lo planes of a K-major 128B-swizzled
//     tile in 16-byte pieces of 4 pixels, into one of two buffers, while the
//     other buffer's products run. That costs shared-memory traffic and no
//     device-memory bytes (a pre-pass writing dy^T's planes would add ~2.4
//     GB, ~0.72 ms, a fp32 step).
//   The tensor core's accumulator takes partials of kWgDepth stages
//   (UIG_K4S_WGRAD_DEPTH, 64 pixels by default: 0.40-0.51x the plain
//   version's error from float64; 32 pixels read 0.27-0.40x and ran 1-5 %
//   slower); a 4-stage ring of raw
//   tiles (36 KB a stage) and the two B buffers (32 KB each) hold one block
//   an SM.
// Fixed order everywhere, no atomics: repeats are bit-equal.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_wgmma.cuh"

namespace {

constexpr int kMaxTaps = 49;  // k <= 7, as csrc/conv3s2.cu checks
constexpr int kFwStages = 4;
constexpr int kDgStages = 4;
#ifndef UIG_K4S_FWD_DEPTH
#define UIG_K4S_FWD_DEPTH 2
#endif
#ifndef UIG_K4S_DGRAD_DEPTH
#define UIG_K4S_DGRAD_DEPTH 1
#endif
#ifndef UIG_K4S_WGRAD_DEPTH
#define UIG_K4S_WGRAD_DEPTH 2
#endif
constexpr int kFwDepth = UIG_K4S_FWD_DEPTH;  // K stages a partial sum
constexpr int kDgDepth = UIG_K4S_DGRAD_DEPTH;
constexpr int kWgDepth = UIG_K4S_WGRAD_DEPTH;

// wgrad shared memory: the two B buffers (hi plane, then lo, 128 rows of
// 128 bytes each), then the ring of raw stages (the two slices' A tiles,
// then the raw dy tile).
constexpr int kWgStages = 4;
constexpr int kWgPitch = 320;  // bytes a pixel row of an A tile
constexpr int kWgATile = 32 * kWgPitch;
constexpr int kWgDPitch = 512;  // bytes a pixel row of the raw dy tile
constexpr int kWgStageBytes = 2 * kWgATile + 32 * kWgDPitch;
constexpr int kWgBPlane = 128 * 128;
constexpr int kWgBBytes = 2 * kWgBPlane;
constexpr int kWgSmemBytes = 2 * kWgBBytes + kWgStages * kWgStageBytes + 1024;

// ws: (2, rows, Fp), the hi and then the lo plane of w (rows, F): position
// col of a row holds o = 32 (col / 32) + chunk_channel(col % 32), zero
// where o >= F. One thread an element.
__global__ void conv_wsplit_kernel(const float* __restrict__ w,
                                   float* __restrict__ ws, int rows, int F,
                                   int Fp) {
  const size_t n = (size_t)rows * Fp;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int row = (int)(i / Fp);
  const int col = (int)(i - (size_t)row * Fp);
  const int o = (col & ~31) + chunk_channel(col & 31);
  uint32_t hi = 0, lo = 0;
  if (o < F) split_tf32(w[(size_t)row * F + o], hi, lo);
  ws[i] = __uint_as_float(hi);
  ws[n + i] = __uint_as_float(lo);
}

// ------------------------------------------------------------------ fwd --
// wt: (2, F, taps Cp), hi and lo of W^T from w (taps C, F) (wt_split_tile).
__global__ void conv_fwd_wsplit_kernel(const float* __restrict__ w,
                                       float* __restrict__ wt, int taps,
                                       int C, int F, int Cp) {
  wt_split_tile(w, wt, taps, C, F, Cp);
}

// grid (ceil(Ho Wo / 128), ceil(F / BN), B), block 256,
// kTfSmemBytes<BN, kFwStages> dynamic.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    conv_fwd_tf32_kernel(const float* __restrict__ x,
                         const float* __restrict__ bias,
                         float* __restrict__ y,
                         const __grid_constant__ CUtensorMap hi_map,
                         const __grid_constant__ CUtensorMap lo_map, int H,
                         int W, int C, int F, int Ho, int Wo, int k,
                         int stride, int pad) {
  constexpr int kPasses = 128 * 8 / kThreads;  // 16-byte pieces a thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint8_t* sbase = smem_raw + (base - smem_u32(smem_raw));

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int M = Ho * Wo;
  const int m0 = blockIdx.x * 128;
  const int n0 = blockIdx.y * BN;
  const int cchunks = (C + 31) / 32;
  const int nk = k * k * cchunks;
  const float* xb = x + (size_t)b * H * W * C;

  // the thread's A rows: the top-left corner of output pixel m's window
  const int piece = tid & 7;
  int a_iy[kPasses], a_ix[kPasses];
  bool a_ok[kPasses];
#pragma unroll
  for (int q = 0; q < kPasses; ++q) {
    const int m = m0 + (tid >> 3) + q * (kThreads / 8);
    a_ok[q] = m < M;
    const int mm = a_ok[q] ? m : 0;
    const int oy = mm / Wo;
    a_iy[q] = oy * stride - pad;
    a_ix[q] = (mm - oy * Wo) * stride - pad;
  }

  auto load = [&](int kc, int slot, uint64_t* bar) {
    const int tap = kc / cchunks;
    const int c0 = (kc - tap * cchunks) * 32;
    const int di = tap / k, dj = tap - di * k;
    const uint32_t st = base + slot * kTfStageBytes<BN>;
    const int c = c0 + piece * 4;
#pragma unroll
    for (int q = 0; q < kPasses; ++q) {
      const int row = (tid >> 3) + q * (kThreads / 8);
      const int sy = a_iy[q] + di, sx = a_ix[q] + dj;
      const bool ok = a_ok[q] && c < C && sy >= 0 && sy < H && sx >= 0 &&
                      sx < W;
      const float* src = ok ? xb + ((size_t)sy * W + sx) * C + c : x;
      cp_async<16>(st + swz(row, piece), src, ok ? 16 : 0);
    }
    if (tid == 0) {
      mbar_expect_tx(bar, 2 * BN * 128);
      const int kk = tap * cchunks * 32 + c0;
      tma_load_2d(st + kTfTile, &hi_map, bar, kk, n0);
      tma_load_2d(st + kTfTile + BN * 128, &lo_map, bar, kk, n0);
    }
    cp_async_commit();
  };

  float sum[BN / 2];
  tf32_ring<BN, kFwStages, kFwDepth>(sum, base, sbase, nk, load);

  const int wg = tid >> 7, t = tid & 127;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + wg * 64 + acc_row(t, h);
    if (m >= M) continue;
    float* o = y + ((size_t)b * M + m) * F;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + acc_col(t, j);
      if (n >= F) continue;  // F % 4 == 0: n and n + 1 are both in or out
      const float b0 = bias != nullptr ? bias[n] : 0.f;
      const float b1 = bias != nullptr ? bias[n + 1] : 0.f;
      *reinterpret_cast<float2*>(o + n) =
          make_float2(sum[4 * j + 2 * h] + b0, sum[4 * j + 2 * h + 1] + b1);
    }
  }
}

// ---------------------------------------------------------------- dgrad --
// grid (ceil(B ceil(H / s) ceil(W / s) / 128), ceil(C / BN), s^2), block
// 256, kTfSmemBytes<BN, kDgStages> dynamic. Block z owns the stride-parity
// class cls = s^2 - 1 - z = (i mod s) s + (j mod s) of dx pixels (i, j).
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    conv_dgrad_tf32_kernel(const float* __restrict__ dy,
                           float* __restrict__ dx,
                           const __grid_constant__ CUtensorMap hi_map,
                           const __grid_constant__ CUtensorMap lo_map, int B,
                           int H, int W, int C, int F, int Ho, int Wo, int k,
                           int stride, int pad) {
  constexpr int kPasses = 128 * 8 / kThreads;  // 16-byte pieces a thread
  __shared__ int tap_row[kMaxTaps];  // (di k + dj) C: the tap's plane rows
  __shared__ int tap_oy[kMaxTaps];   // oy - a for dx row i = s a + pi
  __shared__ int tap_ox[kMaxTaps];   // ox - e for dx column j = s e + pj
  __shared__ int n_taps;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint8_t* sbase = smem_raw + (base - smem_u32(smem_raw));

  const int tid = threadIdx.x;
  const int s = stride;
  const int cls = s * s - 1 - blockIdx.z;
  const int pi = cls / s, pj = cls - pi * s;
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
        tap_row[nt] = (di * k + dj) * C;
        tap_oy[nt] = ry / s;  // exact: s divides ry
        tap_ox[nt] = rx / s;
        ++nt;
      }
    }
    n_taps = nt;
  }
  __syncthreads();
  const int fchunks = (F + 31) / 32;
  const int nk = n_taps * fchunks;

  // the thread's A rows: dx pixel -> first pixel of its image in dy, and
  // its class coordinates (a, e)
  const int piece = tid & 7;
  int a_img[kPasses], a_a[kPasses], a_e[kPasses];
#pragma unroll
  for (int q = 0; q < kPasses; ++q) {
    const int m = m0 + (tid >> 3) + q * (kThreads / 8);
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

  auto load = [&](int kc, int slot, uint64_t* bar) {
    const int tp = kc / fchunks;
    const int o0 = (kc - tp * fchunks) * 32;
    const uint32_t st = base + slot * kTfStageBytes<BN>;
    const int o = o0 + piece * 4;
    const int oy0 = tap_oy[tp], ox0 = tap_ox[tp];
#pragma unroll
    for (int q = 0; q < kPasses; ++q) {
      const int row = (tid >> 3) + q * (kThreads / 8);
      const int oy = a_a[q] + oy0, ox = a_e[q] + ox0;
      const bool ok = o < F && oy >= 0 && oy < Ho && ox >= 0 && ox < Wo;
      const float* src =
          ok ? dy + ((size_t)a_img[q] + oy * Wo + ox) * F + o : dy;
      cp_async<16>(st + swz(row, piece), src, ok ? 16 : 0);
    }
    if (tid == 0) {
      mbar_expect_tx(bar, 2 * BN * 128);
      tma_load_2d(st + kTfTile, &hi_map, bar, o0, tap_row[tp] + n0);
      tma_load_2d(st + kTfTile + BN * 128, &lo_map, bar, o0,
                  tap_row[tp] + n0);
    }
    cp_async_commit();
  };

  float sum[BN / 2];
  if (nk > 0) {
    tf32_ring<BN, kDgStages, kDgDepth>(sum, base, sbase, nk, load);
  } else {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sum[i] = 0.f;
  }

  const int wg = tid >> 7, t = tid & 127;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + wg * 64 + acc_row(t, h);
    if (m >= M) continue;
    const int b = m / HWc;
    const int r = m - b * HWc;
    const int a = r / Wc, e = r - (r / Wc) * Wc;
    float* o = dx + (((size_t)b * H + s * a + pi) * W + s * e + pj) * C;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + acc_col(t, j);
      if (n >= C) continue;  // C % 4 == 0: n and n + 1 are both in or out
      *reinterpret_cast<float2*>(o + n) =
          make_float2(sum[4 * j + 2 * h], sum[4 * j + 2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------- wgrad --
// grid (ceil(k k ceil(C / 64) / 2), ceil(F / 128), chunks), block 256,
// kWgSmemBytes dynamic. Warpgroup g of block x owns slice 2 x + g: tap
// slice / ceil(C / 64), channels 64 (slice % ceil(C / 64)) + 0..63. Block z
// sums pixels [z per_chunk, (z + 1) per_chunk) of the batch's B Ho Wo
// outputs, 32 a stage, and writes part[z] as (k k C, F).
__global__ void __launch_bounds__(kThreads, 1)
    conv_wgrad_tf32_kernel(const float* __restrict__ x,
                           const float* __restrict__ dy,
                           float* __restrict__ part, int B, int H, int W,
                           int C, int F, int Ho, int Wo, int k, int stride,
                           int pad, int per_chunk) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint8_t* sbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t ring = base + 2 * kWgBBytes;
  const uint8_t* sring = sbase + 2 * kWgBBytes;

  const int tid = threadIdx.x;
  const int HWo = Ho * Wo;
  const int P = B * HWo;
  const int p0 = blockIdx.z * per_chunk;
  const int p1 = min(p0 + per_chunk, P);
  const int n0 = blockIdx.y * 128;
  const int spt = (C + 63) / 64;  // slices a tap
  const int nslices = k * k * spt;
  const int nk = (p1 - p0 + 31) / 32;

  // A loader: 16-byte piece apiece of pixel rows tid / 16 and + 16 of both
  // slices' tiles
  const int apiece = tid & 15;
  int s_di[2], s_dj[2], s_c[2];
  bool s_ok[2];
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int slice = 2 * blockIdx.x + g;
    const int tap = slice / spt;
    s_di[g] = tap / k;
    s_dj[g] = tap - s_di[g] * k;
    s_c[g] = (slice - tap * spt) * 64 + apiece * 4;
    s_ok[g] = slice < nslices && s_c[g] < C;
  }
  // dy loader: 16-byte piece dpiece (4 of F) of pixel rows tid / 32 + 8 q
  const int dpiece = tid & 31;
  const int dn = n0 + dpiece * 4;
  const bool dn_ok = dn < F;

  auto load = [&](int kc, int slot) {
    const uint32_t st = ring + slot * kWgStageBytes;
    const int pk = p0 + kc * 32;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int row = (tid >> 4) + 16 * q;
      const int p = pk + row;
      const bool p_ok = p < p1;
      const int pp = p_ok ? p : p0;
      const int b = pp / HWo;
      const int r = pp - b * HWo;
      const int oy = r / Wo;
      const int iy0 = oy * stride - pad, ix0 = (r - oy * Wo) * stride - pad;
      const float* img = x + (size_t)b * H * W * C;
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int iy = iy0 + s_di[g], ix = ix0 + s_dj[g];
        const bool ok = p_ok && s_ok[g] && iy >= 0 && iy < H && ix >= 0 &&
                        ix < W;
        const float* src = ok ? img + ((size_t)iy * W + ix) * C + s_c[g] : x;
        cp_async<16>(st + g * kWgATile + row * kWgPitch + apiece * 16, src,
                     ok ? 16 : 0);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = (tid >> 5) + 8 * q;
      const int p = pk + row;
      const bool ok = dn_ok && p < p1;
      const float* src = ok ? dy + (size_t)p * F + dn : dy;
      cp_async<16>(st + 2 * kWgATile + row * kWgDPitch + dpiece * 16, src,
                   ok ? 16 : 0);
    }
    cp_async_commit();
  };

  // dy^T's hi and lo from slot's raw dy tile into B buffer buf: task (f, j)
  // = the block's column f of F and pixels 4 j .. 4 j + 3, read down the
  // column (a warp's 32 lanes on 32 consecutive f: no bank conflict),
  // split, and stored as a 16-byte piece of row f of each plane (the 8
  // rows of a quarter warp on 8 distinct swizzled pieces).
  auto convert = [&](int slot, int buf) {
    const float* d = reinterpret_cast<const float*>(
        sring + slot * kWgStageBytes + 2 * kWgATile);
    uint8_t* bh = const_cast<uint8_t*>(sbase) + buf * kWgBBytes;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int task = tid + q * kThreads;
      const int f = task & 127, j = task >> 7;
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_tf32(d[(4 * j + i) * (kWgDPitch / 4) + f], hi[i], lo[i]);
      const uint32_t off = swz(f, j);
      *reinterpret_cast<uint4*>(bh + off) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(bh + kWgBPlane + off) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  };

  // the thread's fragments: M rows 16 w + g (+ 8) are channels fch (+ 1)
  // of its warpgroup's slice; K column c of k8 step kk is pixel 8 kk + c
  const int wg = tid >> 7, t = tid & 127, lane = tid & 31;
  const int fch = 16 * ((t >> 5) & 3) + 2 * (lane >> 2);
  const int ft = lane & 3;
  auto frags = [&](int slot, uint32_t (&ah)[4][4], uint32_t (&al)[4][4]) {
    const uint8_t* a =
        sring + slot * kWgStageBytes + wg * kWgATile + fch * 4;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float2 u =
          *reinterpret_cast<const float2*>(a + (8 * kk + ft) * kWgPitch);
      const float2 v =
          *reinterpret_cast<const float2*>(a + (8 * kk + ft + 4) * kWgPitch);
      split_tf32(u.x, ah[kk][0], al[kk][0]);
      split_tf32(u.y, ah[kk][1], al[kk][1]);
      split_tf32(v.x, ah[kk][2], al[kk][2]);
      split_tf32(v.y, ah[kk][3], al[kk][3]);
    }
  };

  float sum[64], acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) sum[i] = acc[i] = 0.f;
#pragma unroll
  for (int s = 0; s < kWgStages - 1; ++s) {
    if (s < nk) load(s, s);
    else cp_async_commit();
  }
  uint32_t ah[4][4], al[4][4], nh[4][4], nl[4][4];
  cp_async_wait<kWgStages - 2>();
  __syncthreads();
  convert(0, 0);
  frags(0, ah, al);
  fence_proxy_async();
  __syncthreads();

  // Step kc issues its 12 products on B buffer kc % 2, refills the raw
  // slot that step kc - 1's conversion read, and while the products run
  // waits for stage kc + 1, builds its B in the other buffer and splits
  // its fragments; then it waits for its products, and a barrier makes
  // the new B visible to wgmma and frees the buffer just read.
  for (int kc = 0; kc < nk; ++kc) {
    wgmma_fence();
    tf32x3_stage<128>(acc, ah, al, base + (kc & 1) * kWgBBytes, kWgBPlane,
                      kc % kWgDepth == 0);
    wgmma_commit();
    const int next = kc + kWgStages - 1;
    if (next < nk) load(next, next % kWgStages);
    else cp_async_commit();
    if (kc + 1 < nk) {
      cp_async_wait<kWgStages - 2>();
      __syncthreads();
      convert((kc + 1) % kWgStages, (kc + 1) & 1);
      frags((kc + 1) % kWgStages, nh, nl);
    }
    wgmma_wait0(acc);
    pin(ah, al);
    fence_proxy_async();
    __syncthreads();
    if (kc + 1 < nk) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ah[kk][i] = nh[kk][i];
          al[kk][i] = nl[kk][i];
        }
    }
    if (kc % kWgDepth == kWgDepth - 1 || kc == nk - 1) {
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] += acc[i];
    }
  }

  const int slice = 2 * blockIdx.x + wg;
  if (slice >= nslices) return;
  const int tap = slice / spt;
  const int c0 = (slice - tap * spt) * 64;
  float* pz = part + (size_t)blockIdx.z * k * k * C * F;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = c0 + fch + h;
    if (c >= C) continue;
    float* pr = pz + ((size_t)tap * C + c) * F;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + acc_col(t, j);
      if (n >= F) continue;
      *reinterpret_cast<float2*>(pr + n) =
          make_float2(sum[4 * j + 2 * h], sum[4 * j + 2 * h + 1]);
    }
  }
}

template <int BN>
cudaError_t fwd(const float* x, const float* w, float* ws, const float* bias,
                float* y, int B, int H, int W, int C, int F, int k,
                int stride, int pad, cudaStream_t stream) {
  const int Ho = (H + 2 * pad - k) / stride + 1;
  const int Wo = (W + 2 * pad - k) / stride + 1;
  const int cp = (C + 31) / 32 * 32;
  const int cols = k * k * cp;
  conv_fwd_wsplit_kernel<<<dim3((F + 31) / 32, cols / 32), dim3(32, 8), 0,
                           stream>>>(w, ws, k * k, C, F, cp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap hi_map = {}, lo_map = {};
  if ((err = plane_map(&hi_map, ws, F, cols, BN)) != cudaSuccess) return err;
  if ((err = plane_map(&lo_map, ws + (size_t)F * cols, F, cols, BN)) !=
      cudaSuccess)
    return err;
  const auto kernel = conv_fwd_tf32_kernel<BN>;
  constexpr int smem = kTfSmemBytes<BN, kFwStages>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Ho * Wo + 127) / 128, (F + BN - 1) / BN, B);
  kernel<<<grid, kThreads, smem, stream>>>(x, bias, y, hi_map, lo_map, H, W,
                                           C, F, Ho, Wo, k, stride, pad);
  return cudaGetLastError();
}

template <int BN>
cudaError_t dgrad(const float* dy, const float* w, float* ws, float* dx,
                  int B, int H, int W, int C, int F, int k, int stride,
                  int pad, cudaStream_t stream) {
  const int Ho = (H + 2 * pad - k) / stride + 1;
  const int Wo = (W + 2 * pad - k) / stride + 1;
  const int fp = (F + 31) / 32 * 32;
  const int rows = k * k * C;
  const size_t n = (size_t)rows * fp;
  conv_wsplit_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      w, ws, rows, F, fp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap hi_map = {}, lo_map = {};
  if ((err = plane_map(&hi_map, ws, rows, fp, BN)) != cudaSuccess) return err;
  if ((err = plane_map(&lo_map, ws + n, rows, fp, BN)) != cudaSuccess)
    return err;
  const auto kernel = conv_dgrad_tf32_kernel<BN>;
  constexpr int smem = kTfSmemBytes<BN, kDgStages>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int s = stride;
  const long long mc = (long long)B * ((H + s - 1) / s) * ((W + s - 1) / s);
  const dim3 grid((unsigned)((mc + 127) / 128), (C + BN - 1) / BN, s * s);
  kernel<<<grid, kThreads, smem, stream>>>(dy, dx, hi_map, lo_map, B, H, W,
                                           C, F, Ho, Wo, k, stride, pad);
  return cudaGetLastError();
}

}  // namespace

// fp32 forward, called by uig_conv_fwd (csrc/conv3s2.cu) with its shape
// checks done: x (B, H, W, C), w (k, k, C, F), bias (F,) or null -> y (B,
// Ho, Wo, F); ws: the (2, F, k k Cp) fp32 scratch of W^T's split planes, Cp
// = C rounded up to 32. N = F in 64-wide tiles (m64n64k8) when F <= 64,
// else 128-wide.
cudaError_t conv_fwd_fp32_tf32(const void* x, const void* w, float* ws,
                               const void* bias, void* y, int B, int H,
                               int W, int C, int F, int k, int stride,
                               int pad, cudaStream_t stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  const auto* bf = static_cast<const float*>(bias);
  auto* o = static_cast<float*>(y);
  return F <= 64 ? fwd<64>(xf, wf, ws, bf, o, B, H, W, C, F, k, stride, pad,
                           stream)
                 : fwd<128>(xf, wf, ws, bf, o, B, H, W, C, F, k, stride, pad,
                            stream);
}

// fp32 input gradient, called by uig_conv_dgrad (csrc/conv3s2.cu) with its
// shape checks done: dy (B, Ho, Wo, F), w (k, k, C, F) -> dx (B, H, W, C);
// ws: the (2, k k C, Fp) fp32 scratch of w's split planes, Fp = F rounded
// up to 32. N = C in 64-wide tiles (m64n64k8) when C <= 64, else 128-wide.
cudaError_t conv_dgrad_fp32_tf32(const void* dy, const void* w, float* ws,
                                 void* dx, int B, int H, int W, int C, int F,
                                 int k, int stride, int pad,
                                 cudaStream_t stream) {
  const auto* d = static_cast<const float*>(dy);
  const auto* wf = static_cast<const float*>(w);
  auto* o = static_cast<float*>(dx);
  return C <= 64
             ? dgrad<64>(d, wf, ws, o, B, H, W, C, F, k, stride, pad, stream)
             : dgrad<128>(d, wf, ws, o, B, H, W, C, F, k, stride, pad,
                          stream);
}

// fp32 weight gradient's first pass, called by uig_conv_wgrad: x (B, H, W,
// C), dy (B, Ho, Wo, F) -> part (chunks, k k C, F), chunk z summing pixels
// [z per_chunk, (z + 1) per_chunk), per_chunk a multiple of 32.
cudaError_t conv_wgrad_fp32_tf32(const void* x, const void* dy, float* part,
                                 int B, int H, int W, int C, int F, int k,
                                 int stride, int pad, int chunks,
                                 int per_chunk, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv_wgrad_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kWgSmemBytes);
  if (err != cudaSuccess) return err;
  const int Ho = (H + 2 * pad - k) / stride + 1;
  const int Wo = (W + 2 * pad - k) / stride + 1;
  const int nslices = k * k * ((C + 63) / 64);
  const dim3 grid((nslices + 1) / 2, (F + 127) / 128, chunks);
  conv_wgrad_tf32_kernel<<<grid, kThreads, kWgSmemBytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy), part, B,
      H, W, C, F, Ho, Wo, k, stride, pad, per_chunk);
  return cudaGetLastError();
}
