// K4d in bf16 on Hopper's tensor cores: the input gradient of the 7x7
// stride-1 pad-3 conv (reflect or zeros) for few output channels (the
// generator head, Cin 64 -> Cout 3), with the reflect ring folded onto its
// sources. csrc/conv7_bwd.cu's entry point launches it for bf16 (and
// csrc/conv7_bwd_tf32.cu's kernel for fp32).
//   dy (B, H, W, Cout), w (7, 7, Cin, Cout) -> dx (B, H, W, Cin)
//
// Replaces: src/uig/kernels/conv_pallas.py, _conv5_impl with fold=True (a
// full correlation of the padded dy with flipped weights, then _fold_block
// adds the gradient of the reflect ring onto its mirrored sources in VMEM),
// from the custom VJP of conv7_s2d.
//
// Bound on this card (H100 SXM data sheet, 700 W): bytes. At batch 16 and
// 256^2 the dx write is 134 MB, 0.040 ms at 3.35 TB/s (dy is 6.3 MB). The
// products, 2 * 16 * 256^2 * 64 * 147 = 19.7 GFLOP, take 0.29 ms on fp32
// FMAs but 0.020 ms at the 989 TFLOP/s bf16 tensor-core rate, so the
// kernel issues wgmma (bf16 products, exact in fp32, summed into fp32
// accumulators in registers) and keeps the rest of its work (building the
// A operand, storing dx) within the time the write takes.
//
// Design: implicit GEMM, one m64n64 tile a warpgroup: M = a 4 x 16 patch
// of dx pixels, N = 64 input channels (a grid slice of Cin), K = the 49
// taps x Cout in the order k = r L + u Cout + o (r, u = 0..6 the window's
// row and column, o the channel; L = 7 Cout rounded up to even, 22 for
// Cout = 3), padded to whole k16 steps (154 -> 160). Row m of A is dx
// pixel m's 7 x 7 window of dy: dy[i + r - 3, j + u - 3, o], and
// B[k, c] = w[6 - r, 6 - u, c, o], so dx = A B. dy has Cout channels (6
// bytes a pixel), which no cp.async or TMA row copy fits: each warpgroup
// stages a dy halo of its patch in shared memory (zeros outside the
// image), twice, the second copy one element later, so that every pair of
// neighbouring elements (k, k + 1), k even, is one aligned 32-bit load in
// one of the copies; its threads then build A in the canonical 128-byte
// swizzled K-major layout, 16-byte pieces of 8 k. B (flipped and regrouped
// from w, (160, 64) bf16, 20 KB) is built once a block. The blocks are
// persistent: two warpgroups a block, two blocks an SM, each warpgroup
// walking patches with the grid's stride, so the B build is paid once a
// block. A warpgroup fetches the next patch's halo into registers while it
// computes the current one, rounds each patch's dx once into a swizzled
// shared-memory stage, and stores the stage to device memory in whole
// 16-byte pieces (a warp writes 512 contiguous bytes) while the next
// patch's products run; one warpgroup's A build overlaps the others'
// products.
//
// The reflect fold: the padded gradient at padded position (P, Q) is the
// same dot product with the window centred there, (P - 6 + r, Q - 6 + u),
// and in reflect mode dx (i, j) sums it over P in {i + 3, 3 - i for 1 <= i
// <= 3, 2H + 1 - i for H - 4 <= i <= H - 2} and Q likewise. A patch that
// holds such ring pixels runs extra K passes over the same B, one for each
// (row source, column source) pair other than (main, main) that one of its
// pixels has, with A's row zero for a pixel without that pair. Every
// contribution to a dx value is summed in the one fp32 accumulator, in a
// fixed order, before its one rounding; no padded gradient goes to device
// memory and there are no atomics, so repeats are bit-equal. This was
// chosen over folding an extended tile's accumulators in shared memory
// (as _fold_block does in VMEM): the passes reuse the main pass's loader
// and products and cost nothing in the interior, where 84 % of the
// patches of a 256^2 plane lie. The halo (19 x 32 pixels a warpgroup)
// holds every dy pixel a ring window of the patch reaches inside the
// image; an interior patch loads only its main window's 10 x 23.
//
// Shapes: every shape the wrapper takes (Cout 1..4, Cin % 4 == 0, reflect
// with H, W >= 4; zeros with any H, W), Cin in 64-wide grid slices (the
// missing channels of the last are zero in B and not stored).
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "dtype.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kPH = 4, kPW = 16;        // a warpgroup's patch: 64 dx pixels
constexpr int kHR = kPH + 15;           // halo rows (row i0 - 6 + h)
constexpr int kHC = kPW + 16;           // halo columns (column j0 - 6 + h)
constexpr int kMainR0 = 3, kMainR1 = kPH + 9;   // main window rows [3, 13)
constexpr int kMainC0 = 3, kMainC1 = kPW + 10;  // and columns [3, 26)

template <int CO>
struct Geo {
  static constexpr int L = (7 * CO + 1) / 2 * 2;  // a window row's k
  static constexpr int K = 7 * L;                 // k that carry a product
  static constexpr int KS = (K + 15) / 16;        // k16 steps
  static constexpr int KCH = (KS + 3) / 4;        // 64-wide K chunks of A
  static constexpr int RS = kHC * CO;             // halo row, in elements
  static constexpr int HALO = kHR * RS;           // one copy, in elements
  static constexpr int B_BYTES = KS * 2048;
  static constexpr int A_BYTES = KCH * kTileBytes;
  static constexpr int HALO_BYTES = (HALO + 2) * 2 / 16 * 16 + 16;
  static constexpr int OUT_BYTES = 64 * 128;  // the patch's dx, bf16
  // a warpgroup's A, output stage and halo copies, keeping the next A tile
  // 1024-aligned
  static constexpr int WG_BYTES =
      (A_BYTES + OUT_BYTES + 2 * HALO_BYTES + 1023) / 1024 * 1024;
  static constexpr int SMEM = 1024 + B_BYTES + 2 * WG_BYTES;
  // halo element of k's window position, from the window's first element
  static __host__ __device__ constexpr int off(int k) {
    return (k / L) * RS + k % L;
  }
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

// The halo, in elements a thread: rows [R0, R1) x columns [C0, C1), element
// q of the region to thread q % 128, slot q / 128.
template <int CO, int R0, int R1, int C0, int C1>
struct Region {
  static constexpr int kE = (C1 - C0) * CO;  // elements of a row's run
  static constexpr int N = (R1 - R0) * kE;
  static constexpr int SLOTS = (N + 127) / 128;
  static __device__ __forceinline__ int hr(int q) { return R0 + q / kE; }
  static __device__ __forceinline__ int ec(int q) { return C0 * CO + q % kE; }
};
template <int CO>
using RingRegion = Region<CO, 0, kHR, 0, kHC>;
template <int CO>
using MainRegion = Region<CO, kMainR0, kMainR1, kMainC0, kMainC1>;

// Issue the loads of patch p's halo region into registers (zero outside
// the image); they land while the warpgroup works on the patch before.
template <int CO, typename Rg>
__device__ __forceinline__ void fetch_halo(uint32_t (&v)[RingRegion<CO>::SLOTS],
                                           const uint16_t* __restrict__ dy,
                                           const Patch& p, int H, int W,
                                           int t) {
  const int lo = (6 - p.j0) * CO, hi = (W + 6 - p.j0) * CO;  // in the image
  // element (gy, ec) of the patch's halo rows is dy[base + gy W CO + ec]
  const long long base = ((long long)p.b * H * W + p.j0 - 6) * CO;
#pragma unroll
  for (int s = 0; s < Rg::SLOTS; ++s) {
    const int q = t + 128 * s;
    const int gy = p.i0 - 6 + Rg::hr(q), ec = Rg::ec(q);
    v[s] = (q < Rg::N && gy >= 0 && gy < H && ec >= lo && ec < hi)
               ? dy[base + (long long)gy * W * CO + ec]
               : 0;
  }
}

// Store the fetched region into both halo copies.
template <int CO, typename Rg>
__device__ __forceinline__ void store_halo(const uint32_t (&v)[RingRegion<CO>::SLOTS],
                                           uint16_t* h0, uint16_t* h1,
                                           int t) {
#pragma unroll
  for (int s = 0; s < Rg::SLOTS; ++s) {
    const int q = t + 128 * s;
    if (q < Rg::N) {
      const int e = Rg::hr(q) * Geo<CO>::RS + Rg::ec(q);
      h0[e] = (uint16_t)v[s];
      h1[e + 1] = (uint16_t)v[s];
    }
  }
}

// Thread t's half HF of A's row t % 64 (pieces [HF KS, HF KS + KS) of the
// row's 2 KS): the window whose first element is halo element `base`, or
// zeros when !valid.
template <int CO, int HF>
__device__ __forceinline__ void build_row(uint8_t* a, const uint8_t* c0,
                                          const uint8_t* c1, int row,
                                          int base, bool valid) {
  using G = Geo<CO>;
  // pair (e, e + 1) is aligned in copy 0 when e is even, in copy 1 when odd
  const uint8_t* p_even = (base & 1) ? c1 + 2 * (base + 1) : c0 + 2 * base;
  const uint8_t* p_odd = (base & 1) ? c0 + 2 * base : c1 + 2 * (base + 1);
#pragma unroll
  for (int i = 0; i < G::KS; ++i) {
    const int p = HF * G::KS + i;
    uint32_t v[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int k = 8 * p + 2 * x;
      v[x] = 0;
      if (k < G::K && valid) {
        const int o = G::off(k);
        v[x] = *reinterpret_cast<const uint32_t*>(
            ((o & 1) ? p_odd : p_even) + 2 * o);
      }
    }
    *reinterpret_cast<uint4*>(a + (p / 8) * kTileBytes + row * 128 +
                              (((p % 8) ^ (row & 7)) << 4)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// Patch pt's dx from its stage (pixel m's 64 channels at row m, 16-byte
// piece p at p ^ (m % 8)) to device memory: each thread 4 pieces of 8
// channels, a warp 4 whole pixels (512 contiguous bytes); 8-byte halves
// where Cin % 8 == 4 (pixels then start 8-byte aligned).
__device__ __forceinline__ void copy_out(const uint8_t* out, const Patch& pt,
                                         bf16* __restrict__ dx, int H, int W,
                                         int Cin, int n0, int t) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int q = t + 128 * k;
    const int m = q / 8, p = q % 8;
    const int y = pt.i0 + m / kPW, x = pt.j0 + m % kPW;
    const int n = n0 + 8 * p;
    if (y >= H || x >= W || n >= Cin) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(out + m * 128 +
                                                    ((p ^ (m & 7)) << 4));
    bf16* o = dx + (((size_t)pt.b * H + y) * W + x) * Cin + n;
    if (Cin % 8 == 0) {
      *reinterpret_cast<uint4*>(o) = v;
    } else {
      *reinterpret_cast<uint2*>(o) = make_uint2(v.x, v.y);
      if (n + 4 < Cin)
        *reinterpret_cast<uint2*>(o + 4) = make_uint2(v.z, v.w);
    }
  }
}

// The padded row (or column) whose window pass `src` adds to dx row i of a
// plane of n: 0 main, 1 the near ring, 2 the far ring; -1 if none.
__device__ __forceinline__ int ring_src(int src, int i, int n) {
  if (src == 0) return i + 3;
  if (src == 1) return (i >= 1 && i <= 3) ? 3 - i : -1;
  return (i >= n - 4 && i <= n - 2) ? 2 * n + 1 - i : -1;
}

// grid (persistent blocks, ceil(Cin / 64)), block 256, Geo<CO>::SMEM
// dynamic. Warpgroup g of block x walks patches 2 x + g, 2 x + g + 2
// gridDim.x, ... of the (B, ceil(H / 4), ceil(W / 16)) patch grid.
// Two blocks an SM for the path's Cout = 3 (126 registers); the other Cout
// may take more registers than two blocks leave (Cout 4's shared memory
// fits one block an SM).
template <int CO>
__global__ void __launch_bounds__(kThreads, CO == 3 ? 2 : 1)
    conv7_dgrad_wgmma_kernel(const bf16* __restrict__ dy,
                             const bf16* __restrict__ w, bf16* __restrict__ dx,
                             int B, int H, int W, int Cin, int reflect) {
  using G = Geo<CO>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* sm = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t sb = smem_u32(sm);
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int n0 = blockIdx.y * 64;

  // B: row k, piece pc (columns 8 pc .. 8 pc + 7), 128-byte swizzled rows
  const uint16_t* wu = reinterpret_cast<const uint16_t*>(w);
  for (int idx = tid; idx < G::KS * 16 * 8; idx += kThreads) {
    const int k = idx / 8, pc = idx % 8;
    const int r = k / G::L, q = k % G::L, u = q / CO, o = q % CO;
    const bool tap = k < G::K && q < 7 * CO;
    uint32_t v[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      uint32_t pair = 0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n0 + 8 * pc + 2 * h + e;
        uint32_t bits = 0;
        if (tap && c < Cin)
          bits = wu[((size_t)((6 - r) * 7 + 6 - u) * Cin + c) * CO + o];
        pair |= bits << (16 * e);
      }
      v[h] = pair;
    }
    *reinterpret_cast<uint4*>(sm + swz(k, pc)) = make_uint4(v[0], v[1], v[2],
                                                            v[3]);
  }
  fence_proxy_async();
  __syncthreads();

  uint8_t* a = sm + G::B_BYTES + wg * G::WG_BYTES;
  const uint32_t sa = sb + G::B_BYTES + wg * G::WG_BYTES;
  uint8_t* out = a + G::A_BYTES;
  uint8_t* c0 = out + G::OUT_BYTES;
  uint8_t* c1 = c0 + G::HALO_BYTES;
  uint16_t* h0 = reinterpret_cast<uint16_t*>(c0);
  uint16_t* h1 = reinterpret_cast<uint16_t*>(c1);
  const uint16_t* dyu = reinterpret_cast<const uint16_t*>(dy);
  const int tiles_y = (H + kPH - 1) / kPH, tiles_x = (W + kPW - 1) / kPW;
  const int tiles = B * tiles_y * tiles_x;
  const int row = t % 64, hf = t / 64;
  const int pi = row / kPW, pj = row % kPW;

  // each warpgroup's patches, with the next patch's halo fetched into
  // registers while the current one is computed, and the previous patch's
  // dx stored from its stage while the current one's products run
  const int stride = gridDim.x * 2;
  uint32_t hv[RingRegion<CO>::SLOTS];
  int tile = blockIdx.x * 2 + wg;
  Patch p = patch_of(tile, tiles_y, tiles_x, H, W, reflect);
  Patch staged = p;
  bool have_staged = false;
  if (tile < tiles) {
    if (p.ring)
      fetch_halo<CO, RingRegion<CO>>(hv, dyu, p, H, W, t);
    else
      fetch_halo<CO, MainRegion<CO>>(hv, dyu, p, H, W, t);
  }
  for (; tile < tiles; tile += stride) {
    const Patch cur = p;
    wg_sync(wg);  // the previous patch's halo reads and stage reads are done
    if (cur.ring)
      store_halo<CO, RingRegion<CO>>(hv, h0, h1, t);
    else
      store_halo<CO, MainRegion<CO>>(hv, h0, h1, t);
    wg_sync(wg);
    if (tile + stride < tiles) {
      p = patch_of(tile + stride, tiles_y, tiles_x, H, W, reflect);
      if (p.ring)
        fetch_halo<CO, RingRegion<CO>>(hv, dyu, p, H, W, t);
      else
        fetch_halo<CO, MainRegion<CO>>(hv, dyu, p, H, W, t);
    }

    float d[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) d[k] = 0.f;
    const int i = cur.i0 + pi, j = cur.j0 + pj;
#pragma unroll 1
    for (int rs = 0; rs < 3; ++rs) {
      if ((rs == 1 && !cur.near_r) || (rs == 2 && !cur.far_r)) continue;
#pragma unroll 1
      for (int cs = 0; cs < 3; ++cs) {
        if ((cs == 1 && !cur.near_c) || (cs == 2 && !cur.far_c)) continue;
        const int P = ring_src(rs, i, H), Q = ring_src(cs, j, W);
        const bool valid = P >= 0 && Q >= 0;
        const int base = valid ? (P - cur.i0) * G::RS + (Q - cur.j0) * CO : 0;
        if (hf == 0)
          build_row<CO, 0>(a, c0, c1, row, base, valid);
        else
          build_row<CO, 1>(a, c0, c1, row, base, valid);
        fence_proxy_async();
        wg_sync(wg);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < G::KS; ++s)
          wgmma_k16<64, 0, 1>(
              d, desc(sa + (s / 4) * kTileBytes + (s % 4) * 32, 16, 1024),
              desc(sb + s * 2048, kTileBytes, 1024));
        wgmma_commit();
        // d belongs to the products in flight until the wait: no access
#pragma unroll
        for (int k = 0; k < 32; ++k) asm volatile("" : "+f"(d[k])::"memory");
        if (have_staged) {  // the first pass: store the previous patch
          copy_out(out, staged, dx, H, W, Cin, n0, t);
          have_staged = false;
        }
        wgmma_wait0(d);
        wg_sync(wg);  // every warp's products and stage reads are done
      }
    }

    // stage the patch's dx, rounded once, for the next patch's first pass
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = acc_row(t, h);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int n = acc_col(t, jj);
        *reinterpret_cast<__nv_bfloat162*>(
            out + m * 128 + (((n / 8) ^ (m & 7)) << 4) + (n % 8) * 2) =
            __floats2bfloat162_rn(d[4 * jj + 2 * h], d[4 * jj + 2 * h + 1]);
      }
    }
    staged = cur;
    have_staged = true;
  }
  if (have_staged) {
    wg_sync(wg);
    copy_out(out, staged, dx, H, W, Cin, n0, t);
  }
}

template <int CO>
cudaError_t dgrad(const void* dy, const void* w, void* dx, int B, int H,
                  int W, int Cin, int reflect, cudaStream_t stream) {
  const auto kernel = conv7_dgrad_wgmma_kernel<CO>;
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
  // two blocks an SM over the whole grid
  const long long per_group = (2LL * sms + groups - 1) / groups;
  const int blocks = (int)std::min((tiles + 1) / 2, std::max(1LL, per_group));
  kernel<<<dim3(blocks, groups), kThreads, Geo<CO>::SMEM, stream>>>(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(w),
      static_cast<bf16*>(dx), B, H, W, Cin, reflect);
  return cudaGetLastError();
}

}  // namespace

// bf16 input gradient, called by uig_conv7_dgrad (csrc/conv7_bwd.cu) with
// its shape checks done: dy (B, H, W, Cout), w (7, 7, Cin, Cout), dx (B, H,
// W, Cin); 1 <= Cout <= 4, Cin % 4 == 0, reflect needs H, W >= 4.
cudaError_t conv7_dgrad_bf16_wgmma(const void* dy, const void* w, void* dx,
                                   int B, int H, int W, int Cin, int Cout,
                                   int reflect, cudaStream_t stream) {
  switch (Cout) {
    case 1: return dgrad<1>(dy, w, dx, B, H, W, Cin, reflect, stream);
    case 2: return dgrad<2>(dy, w, dx, B, H, W, Cin, reflect, stream);
    case 3: return dgrad<3>(dy, w, dx, B, H, W, Cin, reflect, stream);
    case 4: return dgrad<4>(dy, w, dx, B, H, W, Cin, reflect, stream);
    default: return cudaErrorInvalidValue;
  }
}
