// K4w in bf16 on Hopper's tensor cores: the weight gradient of the 7x7
// stride-1 pad-3 conv (reflect or zeros) for few output channels (the
// generator head, Cin 64 -> Cout 3 at 256^2). The entry point of
// csrc/conv7_bwd.cu launches it for bf16 (and csrc/conv7_wgrad_tf32.cu's
// kernel for fp32).
//   x (B, H, W, Cin), dy (B, H, W, Cout) -> dw (7, 7, Cin, Cout)
//
// Replaces: src/uig/kernels/conv_pallas.py, _wgrad5_impl -> _wgrad5_kernel
// (patch^T . dy with dot_general on bf16 operands and an fp32 result,
// accumulated across the sequential grid in a VMEM block), from the custom
// VJP of conv7_s2d; JAX's weight cast then rounds the cotangent to bf16.
//
// Bound on this card (H100 SXM data sheet, 700 W): bytes. At (16, 256, 256,
// 64) -> 3 the x read is 134 MB and dy 6.3 MB, 0.042 ms at 3.35 TB/s; the
// products, 2 * 16 * 256^2 * 64 * 147 = 19.7 GFLOP, take 0.020 ms at the
// 989 TFLOP/s bf16 rate. The FMA design before it (x widened into an fp32
// shared tile with a 2.4x halo, all products on fp32 FMAs) ran at 3.5 % of
// this bound.
//
// Design: the transpose of the bf16 forward (csrc/conv7_tc.cu), the 7
// column taps folded into N. For output row oy of a strip [x0, x1) and
// padded column q (x column col(x0 + q - 3)),
//   D_ky[c][(kx, f)] += sum over q of x[row(oy + ky - 3)][col(x0 + q - 3)]
//                       [c] * dy[oy][x0 + q - kx][f],
// with dy zero outside the strip's own columns, so that every (oy, ox)
// counts once; dw[ky][kx][c][f] = D_ky[c][(kx, f)] summed over the rows
// and strips. M = Cin (one m64 tile a 64-channel grid slice), K = the
// strip's padded columns (134 -> 9 k16 steps for 128 columns), N = 7 Cout
// padded to n8 (24 at Cout 3), on wgmma m64nNk16 with fp32 accumulators
// (the bf16 products are exact), 2.3x fewer products than the straight
// im2col GEMM (M = 49 Cin, N = 8).
//   - A: a block walks the rows of a tile (32 output rows of a 128-column
//     strip) with the source rows in a ring of 8 slots (slot = row % 8), as
//     the forward does; a slot holds the strip's padded columns as 128-byte
//     rows, one pixel's 64 channels each, in the 128B swizzle: the MN-major
//     A that wgmma reads transposed. Each source row is read from device
//     memory once a tile by cp.async (16-byte pieces, 8-byte where Cin % 8
//     == 4; the mirrored columns of the reflect halo are copies, zeros
//     outside the plane in zeros mode), row oy + 4 loading while row oy's
//     products run; mirrored rows are resident by construction.
//   - B_oy (K-major, N rows of the strip's padded columns, 128B swizzle) is
//     built by the threads from one dy row: dy has 6 bytes a pixel at Cout
//     3, which no cp.async or TMA row copy fits, so the row goes through
//     registers into a staged copy with a zero halo and the threads write
//     B's 16-byte pieces from it. B_oy + 1 is built while row oy's products
//     run (two B buffers), and dy row oy + 2 is fetched into registers.
//   - Two warpgroups: the first accumulates ky 0..3, the second 4..6, each
//     one fp32 accumulator set a tap (12 registers a thread at N = 24).
//   - Blocks are persistent: block i walks tiles i, i + chunks, ... of the
//     (B, ceil(H / 32), ceil(W / 128)) tile grid and keeps its sums across
//     them; it writes its partial dw once, and a second kernel sums the
//     chunks' partials in block order and rounds dw once to bf16. No
//     atomics: repeats are bit-equal.
// One block an SM (~164 KB of shared memory at Cout 3).
//
// Weighed and not built: the straight im2col GEMM (M = 49 Cin, N = Cout
// padded to 8; 2.3x these products, and each A row a gather of 49 taps);
// mma.sync as the bf16 forward runs it (every warp would read all of B's
// fragments from shared memory, which bounds that kernel; here wgmma reads
// B once a warpgroup); a partial a tile (the sum then reads 256
// partials at batch 16 against the persistent blocks' 132).
//
// Shapes: every head the bf16 forward takes: Cout 1..4, Cin % 4 == 0,
// Cin <= 256 (up to 4 grid slices), ragged H and W, H, W >= 4 for
// reflect. Anything else is refused.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kTW = 128;                  // output columns a tile's strip
constexpr int kTR = 32;                   // output rows a tile
constexpr int kKS = (kTW + 6 + 15) / 16;  // k16 steps of a strip's columns
constexpr int kRing = 8;                  // source-row slots: 7 + 1 loading
constexpr int kSlot = kKS * 16 * 128;     // a slot: 128-byte rows
constexpr int kChunks = (kKS + 3) / 4;    // 64-wide K chunks of B
constexpr int kDyOff = 8;                 // staged dy: j = -8 .. kDyLen - 9
constexpr int kDyLen = kKS * 16 + 16;
constexpr int kWgThreads = 256;

template <int CO>
struct Geo {
  static constexpr int N = (7 * CO + 7) / 8 * 8;  // n8 tiles of (kx, f)
  static constexpr int BT = N * 128;              // a K chunk of B
  static constexpr int B_BYTES = kChunks * BT;
  static constexpr int DY_PER = (CO * kDyLen + kWgThreads - 1) / kWgThreads;
  static constexpr int SMEM =
      1024 + kRing * kSlot + 2 * B_BYTES + CO * kDyLen * 2;
};

#define UIG_R4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])

// d (N / 2 fp32 a thread, wgmma.cuh's accumulator layout) += A (64 x 16,
// MN-major) * B (16 x N, K-major), both bf16 in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_tn(float (&d)[N / 2], uint64_t da,
                                         uint64_t db) {
  static_assert(N == 8 || N == 16 || N == 24 || N == 32, "N: 8 to 32");
  if constexpr (N == 8)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, 0;\n}\n"
        : UIG_R4(0)
        : "l"(da), "l"(db), "r"(1));
  else if constexpr (N == 16)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n}\n"
        : UIG_R4(0), UIG_R4(4)
        : "l"(da), "l"(db), "r"(1));
  else if constexpr (N == 24)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, %12, %13, p, "
        "1, 1, 1, 0;\n}\n"
        : UIG_R4(0), UIG_R4(4), UIG_R4(8)
        : "l"(da), "l"(db), "r"(1));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, %16, %17, p, 1, 1, 1, 0;\n}\n"
        : UIG_R4(0), UIG_R4(4), UIG_R4(8), UIG_R4(12)
        : "l"(da), "l"(db), "r"(1));
}
#undef UIG_R4

// Keep the accumulators out of reach of other instructions: before the
// wait, the products in flight own them; after it, no read may move above.
template <int N>
__device__ __forceinline__ void pin(float (&d)[4][N / 2]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(d[k][i])::"memory");
}

// grid (chunks, ceil(Cin / 64)), block 256, Geo<CO>::SMEM dynamic. Block
// (i, s) walks tiles i, i + chunks, ... of the (B, ceil(H / kTR), ceil(W /
// kTW)) tile grid over channels [64 s, 64 s + 64) and writes part[i] (49,
// Cin, CO) at those channels.
template <int CO>
__global__ void __launch_bounds__(kWgThreads, 1)
    conv7_wgrad_wgmma_kernel(const bf16* __restrict__ x,
                             const bf16* __restrict__ dy,
                             float* __restrict__ part, int B, int H, int W,
                             int Cin, int reflect) {
  using G = Geo<CO>;
  constexpr int N = G::N;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* sm = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t ring = smem_u32(sm);
  const uint32_t bsm = ring + kRing * kSlot;
  uint8_t* bgen = sm + kRing * kSlot;
  uint16_t* dyrow = reinterpret_cast<uint16_t*>(bgen + 2 * G::B_BYTES);
  const uint16_t* dyu = reinterpret_cast<const uint16_t*>(dy);

  const int tid = threadIdx.x, wg = tid >> 7;
  const int c0 = blockIdx.y * 64;
  const int strips = (W + kTW - 1) / kTW, groups = (H + kTR - 1) / kTR;
  const int tiles = B * groups * strips;
  const int ky0 = wg ? 4 : 0, nky = wg ? 3 : 4;  // the warpgroup's taps

  float d[4][N / 2];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) d[k][i] = 0.f;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / (groups * strips);
    const int rem = tile - b * groups * strips;
    const int r0 = (rem / strips) * kTR, r1 = min(H, r0 + kTR);
    const int x0 = (rem % strips) * kTW, x1 = min(W, x0 + kTW);
    const int nq = x1 - x0 + 6, nk = (nq + 15) / 16;
    const int s_lo = max(0, r0 - 3), s_hi = min(H - 1, r1 + 2);
    const bf16* xb = x + (size_t)b * H * W * Cin + c0;
    const uint16_t* dyb = dyu + ((size_t)b * H * W + x0) * CO;

    // source row sy's padded columns into its slot: row q of the slot is
    // column col(x0 + q - 3), 64 channels from c0; zeros past Cin, past
    // nq, and outside the plane in zeros mode
    auto load_row = [&](int sy) {
      const uint32_t dst = ring + (sy % kRing) * kSlot;
      const bf16* src = xb + (size_t)sy * W * Cin;
      const int nrow = nk * 16;
      if (Cin % 8 == 0) {
        for (int i = tid; i < nrow * 8; i += kWgThreads) {
          const int q = i >> 3, pc = i & 7;
          int col = x0 + q - 3;
          bool ok = q < nq && c0 + 8 * pc < Cin;
          if (ok) {
            if (reflect) col = mirror(col, W);
            else ok = col >= 0 && col < W;
          }
          cp_async<16>(dst + swz(q, pc),
                       ok ? src + (size_t)col * Cin + 8 * pc : x, ok ? 16 : 0);
        }
      } else {
        for (int i = tid; i < nrow * 16; i += kWgThreads) {
          const int q = i >> 4, h = i & 15;
          int col = x0 + q - 3;
          bool ok = q < nq && c0 + 4 * h < Cin;
          if (ok) {
            if (reflect) col = mirror(col, W);
            else ok = col >= 0 && col < W;
          }
          cp_async<8>(dst + swz(q, h >> 1) + (h & 1) * 8,
                      ok ? src + (size_t)col * Cin + 4 * h : x, ok ? 8 : 0);
        }
      }
    };
    // dy row oy of the strip as staged entries (j, f), j = -8 .. kDyLen -
    // 9: thread tid holds entries tid + 256 k; zero outside [0, x1 - x0)
    auto fetch_dy = [&](int oy, uint32_t (&v)[G::DY_PER]) {
      const uint16_t* src = dyb + (size_t)oy * W * CO;
#pragma unroll
      for (int k = 0; k < G::DY_PER; ++k) {
        const int e = tid + kWgThreads * k;
        const int j = e / CO - kDyOff;
        v[k] = e < CO * kDyLen && j >= 0 && j < x1 - x0
                   ? src[(size_t)j * CO + e % CO]
                   : 0u;
      }
    };
    auto store_dy = [&](const uint32_t (&v)[G::DY_PER]) {
#pragma unroll
      for (int k = 0; k < G::DY_PER; ++k) {
        const int e = tid + kWgThreads * k;
        if (e < CO * kDyLen)
          dyrow[(e % CO) * kDyLen + e / CO] = (uint16_t)v[k];
      }
    };
    // B from the staged row into buffer `buf`: row n = (kx, f) (kx = n /
    // CO, f = n % CO; zero for n >= 7 CO), K = the padded columns q in
    // chunks of 64: B[q][n] = dy[oy][x0 + q - kx][f], 16-byte pieces of 8
    // q in the 128B swizzle
    auto build_b = [&](int buf) {
      uint8_t* bt = bgen + buf * G::B_BYTES;
      const int pieces = 2 * nk;
      for (int i = tid; i < N * pieces; i += kWgThreads) {
        const int n = i / pieces, p = i - n * pieces;
        const int kx = n / CO, f = n - kx * CO;
        uint32_t v[4] = {0u, 0u, 0u, 0u};
        if (n < 7 * CO) {
          const uint16_t* s = dyrow + f * kDyLen + 8 * p - kx + kDyOff;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = (uint32_t)s[2 * e] | (uint32_t)s[2 * e + 1] << 16;
        }
        *reinterpret_cast<uint4*>(bt + (p >> 3) * G::BT + n * 128 +
                                  (((p & 7) ^ (n & 7)) << 4)) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
    };

    __syncthreads();  // the previous tile's products and reads are done
    for (int sy = s_lo; sy <= min(s_hi, r0 + 3); ++sy) load_row(sy);
    cp_async_commit();
    uint32_t dv[G::DY_PER];
    fetch_dy(r0, dv);
    store_dy(dv);
    __syncthreads();
    build_b(r0 & 1);
    fence_proxy_async();
    if (r0 + 1 < r1) fetch_dy(r0 + 1, dv);

    for (int oy = r0; oy < r1; ++oy) {
      cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();  // rows up to oy + 3 and B_oy visible to wgmma;
                        // row oy - 1's products are done
      if (oy + 4 <= s_hi) load_row(oy + 4);
      cp_async_commit();

      const uint32_t bb = bsm + (oy & 1) * G::B_BYTES;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k >= nky) break;
        int sy = oy + ky0 + k - 3;
        if (reflect) sy = mirror(sy, H);
        else if (sy < 0 || sy >= H) continue;
        const uint32_t sa = ring + (sy % kRing) * kSlot;
#pragma unroll 1
        for (int s = 0; s < nk; ++s)
          wgmma_tn<N>(d[k], desc(sa + s * 2048, kSlot, 1024),
                      desc(bb + (s >> 2) * G::BT + (s & 3) * 32, 16, 1024));
      }
      wgmma_commit();
      pin<N>(d);
      if (oy + 1 < r1) {  // B_oy + 1 while the products run
        store_dy(dv);
        __syncthreads();
        build_b((oy + 1) & 1);
        fence_proxy_async();
        if (oy + 2 < r1) fetch_dy(oy + 2, dv);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      pin<N>(d);
    }
  }

  // the block's partial: D_ky[c][(kx, f)] -> part[i][ky][kx][c][f]
  const int t = tid & 127;
  float* p = part + (size_t)blockIdx.x * 49 * Cin * CO;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k >= nky) break;
    const int ky = ky0 + k;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + acc_row(t, h);
      if (c >= Cin) continue;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = acc_col(t, j) + e;
          if (n >= 7 * CO) continue;
          const int kx = n / CO, f = n - kx * CO;
          p[((size_t)(ky * 7 + kx) * Cin + c) * CO + f] = d[k][4 * j + 2 * h + e];
        }
    }
  }
}

// dw[e] = sum over chunks, in order, of part[chunk][e], rounded once to
// bf16.
__global__ void conv7_wgrad_sum_kernel(const float* __restrict__ part,
                                       bf16* __restrict__ dw, int n,
                                       int chunks) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int k = 0; k < chunks; ++k) s += part[(size_t)k * n + e];
  dw[e] = __float2bfloat16_rn(s);
}

template <int CO>
cudaError_t wgrad(const void* x, const void* dy, float* part, void* dw,
                  int B, int H, int W, int Cin, int reflect, int chunks,
                  cudaStream_t stream) {
  const auto kernel = conv7_wgrad_wgmma_kernel<CO>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<CO>::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(chunks, (Cin + 63) / 64), kWgThreads, Geo<CO>::SMEM,
           stream>>>(static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
                     part, B, H, W, Cin, reflect);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = 49 * Cin * CO;
  conv7_wgrad_sum_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      part, static_cast<bf16*>(dw), n, chunks);
  return cudaGetLastError();
}

}  // namespace

// bf16 weight gradient, called by uig_conv7_wgrad (csrc/conv7_bwd.cu): x
// (B, H, W, Cin), dy (B, H, W, Cout), dw (7, 7, Cin, Cout); part (chunks,
// 49, Cin, Cout) fp32 scratch, chunks >= 1 persistent blocks a 64-channel
// slice. 1 <= Cout <= 4, Cin % 4 == 0, Cin <= 256, reflect needs H, W >= 4.
cudaError_t conv7_wgrad_bf16_wgmma(const void* x, const void* dy, float* part,
                                   void* dw, int B, int H, int W, int Cin,
                                   int Cout, int reflect, int chunks,
                                   cudaStream_t stream) {
  if (Cin % 4 || Cin > 256 || chunks < 1) return cudaErrorInvalidValue;
  switch (Cout) {
    case 1: return wgrad<1>(x, dy, part, dw, B, H, W, Cin, reflect, chunks,
                            stream);
    case 2: return wgrad<2>(x, dy, part, dw, B, H, W, Cin, reflect, chunks,
                            stream);
    case 3: return wgrad<3>(x, dy, part, dw, B, H, W, Cin, reflect, chunks,
                            stream);
    case 4: return wgrad<4>(x, dy, part, dw, B, H, W, Cin, reflect, chunks,
                            stream);
    default: return cudaErrorInvalidValue;
  }
}
