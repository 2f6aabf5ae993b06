// K4d in fp32 on Hopper's tensor cores, in the three-term TF32 split: the
// input gradient of the 7x7 stride-1 pad-3 conv (reflect or zeros) for few
// output channels (the generator head, Cin 64 -> Cout 3), with the reflect
// ring folded onto its sources. csrc/conv7_bwd.cu's entry point launches it
// for fp32 and states the TPU kernel it replaces.
//   dy (B, H, W, Cout), w (7, 7, Cin, Cout) -> dx (B, H, W, Cin)
//
// Bound on this card (H100 SXM data sheet, 700 W): operations. At (16, 256,
// 256, 3) -> 64 the products are 2 * 16 * 256^2 * 64 * 147 = 19.7 GFLOP;
// the split runs each as three TF32 products, 59.2 GFLOP at 495 TFLOP/s
// dense TF32: 0.120 ms (the dx write, 268 MB, takes 0.080 ms at 3.35 TB/s).
//
// Numerics: each fp32 operand becomes hi = rna_tf32(v) and lo = rna_tf32(v
// - hi) (csrc/tf32.cuh), and each product is summed as lo_dy hi_w + hi_dy
// lo_w + hi_dy hi_w into fp32. The tensor core sums a partial of kDepth k8
// steps (UIG_K4D_DEPTH; one by default: 8 consecutive k of the window) in a
// fresh accumulator; each partial is added to the dx value's fp32 register
// sum with a rounded fp32 add, in K order, pass after pass.
// tools/k4d_k4w_depths.py measures the depths against float64 (PERF.md).
//
// Design: the bf16 kernel's (csrc/conv7_bwd_tc.cu) implicit GEMM, one
// m64n64 tile a warpgroup: M = a 4 x 16 patch of dx pixels, N = 64 input
// channels (a grid slice of Cin), K = the 49 taps x Cout in the order k =
// r L + u Cout + o (r, u = 0..6 the window's row and column, o the channel,
// L = 7 Cout), padded to whole k8 steps (147 -> 152 at Cout 3: 19 steps).
// Row m of A is dx pixel m's 7 x 7 window of dy, dy[i + r - 3, j + u - 3,
// o], and B[k, c] = w[6 - r, 6 - u, c, o], so dx = A B.
//   - A from registers (wgmma m64n64k8 tf32): tf32 wgmma reads only K-major
//     shared operands, and A's rows are windows of a halo; each thread
//     reads its fragment's four dy values of a k8 step (rows 16 w + g and
//     + 8, columns t and t + 4) straight from the warpgroup's fp32 dy halo
//     in shared memory and splits them in registers. A window row is L
//     contiguous halo values, so the offset of k is a constant of the
//     unrolled step, plus t, plus one row's jump where the step crosses a
//     window row at this thread's column (one select). No A tile is built.
//   - B (the flipped, regrouped w) as hi and lo K-major planes in the 128B
//     swizzle, built once a block (2 x 160 x 64 x 4 B = 80 KB at Cout 3).
//   - Persistent blocks of 3 warpgroups sharing B (168 registers a
//     thread, one block an SM), each warpgroup walking patches with the
//     grid's stride; the next patch's halo is copied by cp.async (4-byte
//     pieces, zero fill outside the image) into the warpgroup's second
//     halo buffer while the current one's products run. A step's
//     fragments are split while the step before runs, and two accumulator
//     sets take the partials in turn, so that a partial is added while the
//     next one's products run.
//   - The reflect fold, as in bf16: the padded gradient at padded position
//     (P, Q) is the same dot product with the window centred there, and dx
//     (i, j) sums it over P in {i + 3, 3 - i for 1 <= i <= 3, 2H + 1 - i for
//     H - 4 <= i <= H - 2} and Q likewise. A patch that holds ring pixels
//     runs extra K passes over the same B, one for each (row source, column
//     source) pair other than (main, main) that one of its pixels has, with
//     A's row zero for a pixel without that pair, summed into the same fp32
//     register sums. No padded gradient goes to device memory; no atomics,
//     so repeats are bit-equal.
//   - dx is stored from the register sums: 8-byte pieces where Cin is even,
//     4-byte ones where it is odd (any Cin up to the fp32 forward's 112).
//
// Shapes: every head the fp32 forward takes: Cout 1..4, any Cin (in 64-wide
// grid slices, zero in B past Cin and not stored), reflect with H, W >= 4,
// zeros with any H, W.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "tf32_wgmma.cuh"

namespace {

#ifndef UIG_K4D_DEPTH
#define UIG_K4D_DEPTH 1
#endif
constexpr int kDepth = UIG_K4D_DEPTH;  // k8 steps a partial
constexpr int kWgs = 3;                // warpgroups a block
constexpr int kBlockThreads = 128 * kWgs;

constexpr int kPH = 4, kPW = 16;        // a warpgroup's patch: 64 dx pixels
constexpr int kHR = kPH + 15;           // halo rows (row i0 - 6 + h)
constexpr int kHC = kPW + 16;           // halo columns (column j0 - 6 + h)
constexpr int kMainR0 = 3, kMainR1 = kPH + 9;   // main window rows [3, 13)
constexpr int kMainC0 = 3, kMainC1 = kPW + 10;  // and columns [3, 26)
constexpr int kBChunk = 64 * 128;  // 32 k of B's 64 rows, one plane

template <int CO>
struct Geo {
  static constexpr int L = 7 * CO;           // a window row's k
  static constexpr int K = 7 * L;            // k that carry a product
  static constexpr int KS = (K + 7) / 8;     // k8 steps
  static constexpr int KCH = (KS + 3) / 4;   // 32-wide K chunks of B
  static constexpr int RS = kHC * CO;        // halo row, in floats
  static constexpr int HALO = kHR * RS;      // a halo buffer, in floats
  static constexpr int HALO_BYTES = (HALO * 4 + 15) / 16 * 16;
  static constexpr int PLANE = KCH * kBChunk;  // B's hi (or lo) plane
  static constexpr int SMEM = 1024 + 2 * PLANE + kWgs * 2 * HALO_BYTES;
};

__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// A patch of the (B, ceil(H / 4), ceil(W / 16)) grid and the ring sources
// its pixels have (warpgroup-uniform).
struct Patch {
  int b, i0, j0;
  bool near_r, far_r, near_c, far_c, ring;
};

__device__ __forceinline__ Patch patch_of(int tile, int tiles_y, int tiles_x,
                                          int H, int W, int reflect) {
  Patch p;
  p.b = tile / (tiles_y * tiles_x);
  const int rem = tile - p.b * tiles_y * tiles_x;
  p.i0 = (rem / tiles_x) * kPH;
  p.j0 = (rem % tiles_x) * kPW;
  p.near_r = reflect && p.i0 <= 3 && p.i0 + kPH - 1 >= 1;
  p.far_r = reflect && p.i0 <= H - 2 && p.i0 + kPH - 1 >= H - 4;
  p.near_c = reflect && p.j0 <= 3 && p.j0 + kPW - 1 >= 1;
  p.far_c = reflect && p.j0 <= W - 2 && p.j0 + kPW - 1 >= W - 4;
  p.ring = p.near_r || p.far_r || p.near_c || p.far_c;
  return p;
}

// The halo, in floats a thread: rows [R0, R1) x columns [C0, C1), float q
// of the region to thread q % 128, slot q / 128.
template <int CO, int R0, int R1, int C0, int C1>
struct Region {
  static constexpr int kE = (C1 - C0) * CO;  // floats of a row's run
  static constexpr int N = (R1 - R0) * kE;
  static constexpr int SLOTS = (N + 127) / 128;
  static __device__ __forceinline__ int hr(int q) { return R0 + q / kE; }
  static __device__ __forceinline__ int ec(int q) { return C0 * CO + q % kE; }
};
template <int CO>
using RingRegion = Region<CO, 0, kHR, 0, kHC>;
template <int CO>
using MainRegion = Region<CO, kMainR0, kMainR1, kMainC0, kMainC1>;

// Copy patch p's halo region into the halo buffer at shared address dst
// (zero outside the image).
template <int CO, typename Rg>
__device__ __forceinline__ void load_halo(uint32_t dst,
                                          const float* __restrict__ dy,
                                          const Patch& p, int H, int W,
                                          int t) {
  const int lo = (6 - p.j0) * CO, hi = (W + 6 - p.j0) * CO;  // in the image
  // float (gy, ec) of the patch's halo rows is dy[base + gy W CO + ec]
  const long long base = ((long long)p.b * H * W + p.j0 - 6) * CO;
#pragma unroll
  for (int s = 0; s < Rg::SLOTS; ++s) {
    const int q = t + 128 * s;
    if (q >= Rg::N) break;
    const int hr = Rg::hr(q), ec = Rg::ec(q);
    const int gy = p.i0 - 6 + hr;
    const bool ok = gy >= 0 && gy < H && ec >= lo && ec < hi;
    cp_async<4>(dst + 4 * (hr * Geo<CO>::RS + ec),
                ok ? dy + base + (long long)gy * W * CO + ec : dy, ok ? 4 : 0);
  }
}

template <int CO>
__device__ __forceinline__ void load_patch(uint32_t dst,
                                           const float* __restrict__ dy,
                                           const Patch& p, int H, int W,
                                           int t) {
  if (p.ring)
    load_halo<CO, RingRegion<CO>>(dst, dy, p, H, W, t);
  else
    load_halo<CO, MainRegion<CO>>(dst, dy, p, H, W, t);
}

// The padded row (or column) whose window pass `src` adds to dx row i of a
// plane of n: 0 main, 1 the near ring, 2 the far ring; -1 if none.
__device__ __forceinline__ int ring_src(int src, int i, int n) {
  if (src == 0) return i + 3;
  if (src == 1) return (i >= 1 && i <= 3) ? 3 - i : -1;
  return (i >= n - 4 && i <= n - 2) ? 2 * n + 1 - i : -1;
}

// The thread's A fragment of k8 step s, split: element 2 c + h is A's row
// h (16 w + g, + 8) at column 8 s + t + 4 c, k = C + t with C = 8 s + 4 c.
// a[h] points at the row's window in the halo, plus t; jump[j] is the step
// from one window row to the next (RS - L) where t >= j, else 0. Zero past
// K, and for a row that has no window in this pass.
template <int CO>
__device__ __forceinline__ void frag(int s, const float* const (&a)[2],
                                     const bool (&live)[2],
                                     const int (&jump)[4], int t,
                                     uint32_t (&ah)[4], uint32_t (&al)[4]) {
  using G = Geo<CO>;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int C = 8 * s + 4 * c;
    const int r = C / G::L, rem = C % G::L;
    int off = r * G::RS + rem;
    if (rem + 3 >= G::L) off += jump[G::L - rem];
    const bool in_k = C + 3 < G::K || (C < G::K && t < G::K - C);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v = in_k && live[h] ? a[h][off] : 0.f;
      split_tf32(v, ah[2 * c + h], al[2 * c + h]);
    }
  }
}

// One K pass over B (hi plane at shared address sb, lo plane PLANE bytes
// further) for the window rows a[0], a[1], summed into sum in partials of
// kDepth steps. Step s's fragments are split while step s - 1 runs; the
// partials take two accumulator sets in turn, so that a partial is added
// to sum while the next one's first products run.
template <int CO>
__device__ __forceinline__ void k_pass(float (&sum)[32],
                                       const float* const (&a)[2],
                                       const bool (&live)[2],
                                       const int (&jump)[4], int t,
                                       uint32_t sb) {
  using G = Geo<CO>;
  float acc[2][32];
  uint32_t fh[2][4], fl[2][4];
  frag<CO>(0, a, live, jump, t, fh[0], fl[0]);
#pragma unroll
  for (int s = 0; s < G::KS; ++s) {
    const int cur = s & 1, set = (s / kDepth) & 1;
    const uint32_t b = sb + (s / 4) * kBChunk + (s % 4) * 32;
    const uint64_t bh = desc(b, 16, 1024);
    const uint64_t bl = desc(b + G::PLANE, 16, 1024);
    wgmma_fence();
    wgmma_tf32<64>(acc[set], fl[cur], bh, s % kDepth != 0);
    wgmma_tf32<64>(acc[set], fh[cur], bl, 1);
    wgmma_tf32<64>(acc[set], fh[cur], bh, 1);
    wgmma_commit();
    pin_acc(acc[set]);
    if (s > 0) {  // step s - 1 is done while step s runs
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      pin4(fh[cur ^ 1], fl[cur ^ 1]);
      if (s % kDepth == 0) {  // it ended the other set's partial
        pin_acc(acc[set ^ 1]);
#pragma unroll
        for (int i = 0; i < 32; ++i) sum[i] += acc[set ^ 1][i];
      }
    }
    if (s + 1 < G::KS) frag<CO>(s + 1, a, live, jump, t, fh[cur ^ 1],
                                fl[cur ^ 1]);
  }
  constexpr int last = (G::KS - 1) & 1, last_set = ((G::KS - 1) / kDepth) & 1;
  wgmma_wait0(acc[last_set]);
  pin4(fh[last], fl[last]);
#pragma unroll
  for (int i = 0; i < 32; ++i) sum[i] += acc[last_set][i];
}

// grid (persistent blocks, ceil(Cin / 64)), block kBlockThreads,
// Geo<CO>::SMEM dynamic. Warpgroup g of block x walks patches kWgs x + g,
// kWgs x + g + kWgs gridDim.x, ... of the (B, ceil(H / 4), ceil(W / 16))
// patch grid.
template <int CO>
__global__ void __launch_bounds__(kBlockThreads, 1)
    conv7_dgrad_tf32_kernel(const float* __restrict__ dy,
                            const float* __restrict__ w,
                            float* __restrict__ dx, int B, int H, int W,
                            int Cin, int reflect) {
  using G = Geo<CO>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* sm = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t sb = smem_u32(sm);
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int n0 = blockIdx.y * 64;

  // B's hi and lo planes: element (k, n) at chunk k / 32, row n, 16-byte
  // piece (k % 32) / 4 in the 128B swizzle
  for (int idx = tid; idx < G::KCH * 64 * 8; idx += kBlockThreads) {
    const int n = idx % 64, piece = (idx / 64) % 8, ch = idx / 512;
    const int c = n0 + n;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 32 * ch + 4 * piece + e;
      const int r = k / G::L, q = k % G::L, u = q / CO, o = q % CO;
      const float v = k < G::K && c < Cin
                          ? w[((size_t)((6 - r) * 7 + 6 - u) * Cin + c) * CO +
                              o]
                          : 0.f;
      split_tf32(v, hi[e], lo[e]);
    }
    const uint32_t off = ch * kBChunk + swz(n, piece);
    *reinterpret_cast<uint4*>(sm + off) = make_uint4(hi[0], hi[1], hi[2],
                                                     hi[3]);
    *reinterpret_cast<uint4*>(sm + G::PLANE + off) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  fence_proxy_async();
  __syncthreads();

  const uint32_t halo_sa = sb + 2 * G::PLANE + wg * 2 * G::HALO_BYTES;
  const float* halo =
      reinterpret_cast<const float*>(sm + 2 * G::PLANE +
                                     wg * 2 * G::HALO_BYTES);
  const int warp = t / 32, lane = t % 32, g = lane / 4, tq = lane % 4;
  int jump[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) jump[j] = tq >= j ? G::RS - G::L : 0;
  const int tiles_y = (H + kPH - 1) / kPH, tiles_x = (W + kPW - 1) / kPW;
  const int tiles = B * tiles_y * tiles_x;
  const int stride = gridDim.x * kWgs;

  int tile = blockIdx.x * kWgs + wg;
  Patch p = patch_of(tile, tiles_y, tiles_x, H, W, reflect);
  if (tile < tiles) load_patch<CO>(halo_sa, dy, p, H, W, t);
  cp_async_commit();
  for (int buf = 0; tile < tiles; tile += stride, buf ^= 1) {
    const Patch cur = p;
    cp_async_wait<0>();
    wg_sync(wg);  // cur's halo landed; the patch before read its last
    if (tile + stride < tiles) {
      p = patch_of(tile + stride, tiles_y, tiles_x, H, W, reflect);
      load_patch<CO>(halo_sa + (buf ^ 1) * G::HALO_BYTES, dy, p, H, W, t);
    }
    cp_async_commit();
    const float* hb = halo + buf * (G::HALO_BYTES / 4);

    float sum[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) sum[k] = 0.f;
    // the thread's A rows: pixels (i, j[h]) of the patch
    const int i = cur.i0 + warp;
    const int j[2] = {cur.j0 + g, cur.j0 + g + 8};
#pragma unroll 1
    for (int rs = 0; rs < 3; ++rs) {
      if ((rs == 1 && !cur.near_r) || (rs == 2 && !cur.far_r)) continue;
#pragma unroll 1
      for (int cs = 0; cs < 3; ++cs) {
        if ((cs == 1 && !cur.near_c) || (cs == 2 && !cur.far_c)) continue;
        const int P = ring_src(rs, i, H);
        const float* a[2];
        bool live[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int Q = ring_src(cs, j[h], W);
          live[h] = P >= 0 && Q >= 0;
          a[h] = hb + tq +
                 (live[h] ? (P - cur.i0) * G::RS + (Q - cur.j0) * CO : 0);
        }
        k_pass<CO>(sum, a, live, jump, tq, sb);
      }
    }

    // dx from the sums: row acc_row(t, h) is patch pixel (warp, g + 8 h)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int y = i, x = j[h];
      if (y >= H || x >= W) continue;
      float* o = dx + (((size_t)cur.b * H + y) * W + x) * Cin;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int n = n0 + acc_col(t, jj);
        const float v0 = sum[4 * jj + 2 * h], v1 = sum[4 * jj + 2 * h + 1];
        if (Cin % 2 == 0) {
          if (n < Cin) *reinterpret_cast<float2*>(o + n) = make_float2(v0, v1);
        } else {
          if (n < Cin) o[n] = v0;
          if (n + 1 < Cin) o[n + 1] = v1;
        }
      }
    }
  }
}

template <int CO>
cudaError_t dgrad(const float* dy, const float* w, float* dx, int B, int H,
                  int W, int Cin, int reflect, cudaStream_t stream) {
  const auto kernel = conv7_dgrad_tf32_kernel<CO>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<CO>::SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles =
      (long long)B * ((H + kPH - 1) / kPH) * ((W + kPW - 1) / kPW);
  if (tiles == 0) return cudaSuccess;
  const int groups = (Cin + 63) / 64;
  // one block an SM over the whole grid
  const long long per_group = (sms + groups - 1) / groups;
  const int blocks = (int)std::min((tiles + kWgs - 1) / kWgs,
                                   std::max(1LL, per_group));
  kernel<<<dim3(blocks, groups), kBlockThreads, Geo<CO>::SMEM, stream>>>(
      dy, w, dx, B, H, W, Cin, reflect);
  return cudaGetLastError();
}

}  // namespace

// fp32 input gradient, called by uig_conv7_dgrad (csrc/conv7_bwd.cu) with
// its shape checks done: dy (B, H, W, Cout), w (7, 7, Cin, Cout), dx (B, H,
// W, Cin); 1 <= Cout <= 4, any Cin, reflect needs H, W >= 4.
cudaError_t conv7_dgrad_fp32_tf32(const void* dy, const void* w, void* dx,
                                  int B, int H, int W, int Cin, int Cout,
                                  int reflect, cudaStream_t stream) {
  const auto* d = static_cast<const float*>(dy);
  const auto* wf = static_cast<const float*>(w);
  auto* o = static_cast<float*>(dx);
  switch (Cout) {
    case 1: return dgrad<1>(d, wf, o, B, H, W, Cin, reflect, stream);
    case 2: return dgrad<2>(d, wf, o, B, H, W, Cin, reflect, stream);
    case 3: return dgrad<3>(d, wf, o, B, H, W, Cin, reflect, stream);
    case 4: return dgrad<4>(d, wf, o, B, H, W, Cin, reflect, stream);
    default: return cudaErrorInvalidValue;
  }
}
