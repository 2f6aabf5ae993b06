// K4w in fp32 on Hopper's tensor cores, in the three-term TF32 split: the
// weight gradient of the 7x7 stride-1 pad-3 conv (reflect or zeros) for few
// output channels (the generator head, Cin 64 -> Cout 3 at 256^2).
// csrc/conv7_bwd.cu's entry point launches it for fp32 and states the TPU
// kernel it replaces.
//   x (B, H, W, Cin), dy (B, H, W, Cout) -> dw (7, 7, Cin, Cout)
//
// Bound on this card (H100 SXM data sheet, 700 W): operations. At (16, 256,
// 256, 64) -> 3 the products are 2 * 16 * 256^2 * 64 * 147 = 19.7 GFLOP;
// the split runs each as three TF32 products, 59.2 GFLOP at 495 TFLOP/s
// dense TF32: 0.120 ms (the x read, 268 MB, takes 0.080 ms at 3.35 TB/s).
//
// Numerics: each fp32 operand becomes hi = rna_tf32(v) and lo = rna_tf32(v
// - hi) (csrc/tf32.cuh), and each product is summed as lo_x hi_dy + hi_x
// lo_dy + hi_x hi_dy into fp32. The tensor core sums a partial of one
// (padded row, ky) pair (all of a strip row's k8 steps; UIG_K4W_DEPTH = d >
// 0 cuts it into partials of d steps) in a fresh accumulator; each partial
// is added to the block's fp32 register sum with a rounded fp32 add, in the
// order (tile, output row). tools/k4d_k4w_depths.py measures the depths
// against float64 (PERF.md).
//
// Design: a GEMM a padded row. For the padded row P of an image (source
// row row(P - 3)) and a strip [x0, x1) of output columns, with padded
// column q the x column col(x0 + q - 3),
//   D[c][(ky, kx, f)] += sum over q of x[row(P - 3)][col(x0 + q - 3)][c] *
//                        dy[P - ky][x0 + q - kx][f],
// with dy zero outside the strip's columns and the tile's output rows, so
// that every (oy, ox) counts once; dw[ky][kx][c][f] = D[c][(ky, kx, f)]
// summed over the padded rows and strips. M = Cin (one m64 tile a
// 64-channel grid slice), K = the strip's padded columns (64: 58 output
// columns + 6, 8 k8 steps; a ragged last strip runs all 8 on zeros), N =
// the 49 taps x Cout padded to 168 at Cout 3, in three thirds of NW = 56
// columns, one a warpgroup, on wgmma m64n56k8 tf32. Folding ky into N as
// well as kx (the bf16 kernel, csrc/conv7_wgrad_tc.cu, folds kx only)
// keeps N wide.
//   - A from registers: tf32 wgmma reads only K-major shared operands, and
//     A is MN-major in the source row (pixel-major, channels contiguous).
//     A row slot holds the strip's padded columns at a pitch of 72 floats
//     (8 mod 32), by cp.async (16-byte pieces, 4-byte ones where Cin % 4 !=
//     0; mirrored columns as copies, zeros outside the plane in zeros mode
//     and past Cin); M row 16 w + g + 8 h is channel 16 w + 2 g + h of the
//     slice, so one 8-byte load gives a thread both rows of a column, two
//     loads a k8 step, free of bank conflicts. Two slots: one in use, one
//     loading the next padded row. The three warpgroups read and split the
//     same fragments.
//   - B_P (K-major, the N rows (ky, kx, f) of the padded columns, hi and lo
//     planes in the 128B swizzle) is built by the threads for padded row P
//     + 1 from a ring of 8 staged dy rows, split into hi and lo as they are
//     staged (dy has 6 bytes a pixel at Cout 3, which no row copy fits;
//     rows are fetched into registers a padded row ahead), while row P's
//     products run: the 7 rows kx of a (ky, f) are shifts of one staged
//     row, so a thread reads 10 values a plane and writes 7 pieces. Two B
//     buffers, 84 KB each at Cout 3.
//   - A warpgroup skips a padded row whose output rows P - ky all lie
//     outside the tile; B's rows for such an output row are zeros. The
//     warpgroups run one code path, one N: ptxas serializes the wgmma it
//     meets on divergent paths.
//   - Blocks are persistent: block i walks tiles i, i + chunks, ... of the
//     (B, ceil(H / 16), ceil(W / TW)) tile grid and keeps its sums across
//     them; it writes its partial dw once, and conv7_wgrad_tf32_sum_kernel
//     sums the chunks' partials in block order. No atomics: repeats are
//     bit-equal. One block of 384 threads an SM (~218 KB of shared memory
//     at Cout 3).
// Weighed and not built: the bf16 kernel's ring of 8 source rows with B_oy
// of one dy row at a time (a 64-column strip to fit, 166 KB for the ring):
// each source row's fragments would be read and split 7 times, once a tap,
// at N = 24 a product.
//
// Shapes: every head the fp32 forward takes: Cout 1..4, any Cin (64-wide
// grid slices), ragged H and W, H, W >= 4 for reflect. Cout 4 takes strips
// of 26 columns (32 padded, 4 k8 steps) to fit its wider B.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_wgmma.cuh"

namespace {

// k8 steps a partial (0: a strip row's); tools/k4d_k4w_depths.py measures
// one step against the default.
#ifndef UIG_K4W_DEPTH
#define UIG_K4W_DEPTH 0
#endif

constexpr int kTR = 16;      // output rows a tile (conv.py's _WTILE_TF32)
constexpr int kPitch = 72;   // floats a padded column's 64 channels
constexpr int kDyRing = 8;   // staged dy rows: 7 a B build reads + 1
constexpr int kDyOff = 8;    // staged dy: j = -8 .. Q - 1
constexpr int kWgs = 3;      // warpgroups a block, a third of N each
constexpr int kWThreads = 128 * kWgs;

template <int CO>
struct Geo {
  static constexpr int TW = CO == 4 ? 26 : 58;    // output columns a strip
  static constexpr int KS = (TW + 6 + 7) / 8;     // k8 steps of a strip row
  static constexpr int Q = 8 * KS;                // padded columns a slot
  static constexpr int CH = (KS + 3) / 4;         // 32-wide K chunks of B
  static constexpr int TAPS = 49 * CO;            // N's columns (ky, kx, f)
  // a warpgroup's third of N
  static constexpr int NW = (TAPS + kWgs * 8 - 1) / (kWgs * 8) * 8;
  static constexpr int BT = kWgs * NW * 128;      // a chunk of one plane
  static constexpr int PLANE = CH * BT;
  static constexpr int B_BYTES = 2 * PLANE;       // hi, then lo
  static constexpr int SLOT = Q * kPitch * 4;
  static constexpr int DY_LEN = Q + kDyOff;
  static constexpr int DY_PER = (CO * DY_LEN + kWThreads - 1) / kWThreads;
  static constexpr int DEPTH = UIG_K4W_DEPTH > 0 ? UIG_K4W_DEPTH : KS;
  static constexpr int DY_ROW = 2 * CO * DY_LEN;  // a staged row: hi, lo
  static constexpr int SMEM =
      1024 + 2 * B_BYTES + 2 * SLOT + kDyRing * DY_ROW * 4;
};

// The thread's A fragment of k8 step s from a row slot (pointer at the
// thread's channel pair): columns 8 s + t and 8 s + t + 4, split.
__device__ __forceinline__ void frag(const float* src, int s, int t,
                                     uint32_t (&ah)[4], uint32_t (&al)[4]) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float2 v =
        *reinterpret_cast<const float2*>(src + (8 * s + t + 4 * c) * kPitch);
    split_tf32(v.x, ah[2 * c], al[2 * c]);
    split_tf32(v.y, ah[2 * c + 1], al[2 * c + 1]);
  }
}

// A warpgroup's products of one padded row: the KS k8 steps of A (the
// slot at src; past a ragged strip's columns A and B are zeros) times its
// NW columns of B (hi plane at shared address b, lo plane PLANE bytes
// further), in partials of DEPTH steps added to sum in order. Step s +
// 1's fragments are split while step s's products run, and so does
// work(s, KS), slice s of the next padded row's B build, which every
// thread runs. Both warpgroups run this one path (one N, no early exit):
// ptxas serializes wgmma that it meets on divergent paths.
template <int CO, typename Work>
__device__ __forceinline__ void row_products(float (&sum)[Geo<CO>::NW / 2],
                                             float (&acc)[Geo<CO>::NW / 2],
                                             const float* src, uint32_t b,
                                             int t, Work&& work) {
  using G = Geo<CO>;
  constexpr int N = G::NW;
  uint32_t fh[2][4], fl[2][4];
  frag(src, 0, t, fh[0], fl[0]);
#pragma unroll
  for (int s = 0; s < G::KS; ++s) {
    const int cur = s & 1;
    const uint32_t bb = b + (s / 4) * G::BT + (s % 4) * 32;
    const uint64_t bh = desc(bb, 16, 1024);
    const uint64_t bl = desc(bb + G::PLANE, 16, 1024);
    wgmma_fence();
    wgmma_tf32<N>(acc, fl[cur], bh, s % G::DEPTH != 0);
    wgmma_tf32<N>(acc, fh[cur], bl, 1);
    wgmma_tf32<N>(acc, fh[cur], bh, 1);
    wgmma_commit();
    pin_acc<N / 2>(acc);
    work(s, G::KS);
    if (s % G::DEPTH != G::DEPTH - 1 && s != G::KS - 1) {
      // step s - 1 is done: its fragments' registers take step s + 1
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      pin4(fh[cur ^ 1], fl[cur ^ 1]);
    } else {
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      pin_acc<N / 2>(acc);
      pin4(fh[cur], fl[cur]);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) sum[i] += acc[i];
    }
    if (s + 1 < G::KS) frag(src, s + 1, t, fh[cur ^ 1], fl[cur ^ 1]);
  }
}

// grid (chunks, ceil(Cin / 64)), block kWThreads, Geo<CO>::SMEM dynamic.
// Block (i, s) walks tiles i, i + chunks, ... of the (B, ceil(H / kTR),
// ceil(W / TW)) tile grid over channels [64 s, 64 s + 64) and writes
// part[i] (49, Cin, CO) at those channels.
template <int CO>
__global__ void __launch_bounds__(kWThreads, 1)
    conv7_wgrad_tf32_kernel(const float* __restrict__ x,
                            const float* __restrict__ dy,
                            float* __restrict__ part, int B, int H, int W,
                            int Cin, int reflect) {
  using G = Geo<CO>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* sm = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t bsa = smem_u32(sm);
  const uint32_t slot_sa = bsa + 2 * G::B_BYTES;
  const float* slots = reinterpret_cast<const float*>(sm + 2 * G::B_BYTES);
  float* dyst = reinterpret_cast<float*>(sm + 2 * G::B_BYTES + 2 * G::SLOT);

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = t & 31, tq = lane & 3;
  const int fch = 16 * warp + 2 * (lane >> 2);  // the thread's A channels
  const int c0 = blockIdx.y * 64;
  const int strips = (W + G::TW - 1) / G::TW, groups = (H + kTR - 1) / kTR;
  const int tiles = B * groups * strips;

  float sum[G::NW / 2], acc[G::NW / 2];
#pragma unroll
  for (int i = 0; i < G::NW / 2; ++i) sum[i] = acc[i] = 0.f;
  // the warpgroup's taps: ky of its first and last columns
  const int ky_lo = wg * G::NW / (7 * CO);
  const int ky_hi = min(6, ((wg + 1) * G::NW - 1) / (7 * CO));
  // B's rows past the taps stay zero in both buffers
  for (int i = tid; i < 2 * 2 * G::CH * (kWgs * G::NW - G::TAPS) * 8;
       i += kWThreads) {
    const int piece = i % 8, r = i / 8;
    const int n = G::TAPS + r % (kWgs * G::NW - G::TAPS);
    const int plane = r / (kWgs * G::NW - G::TAPS);  // (buffer, hi/lo, chunk)
    *reinterpret_cast<uint4*>(sm + plane * G::BT + swz(n, piece)) =
        make_uint4(0u, 0u, 0u, 0u);
  }

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / (groups * strips);
    const int rem = tile - b * groups * strips;
    const int r0 = (rem / strips) * kTR, r1 = min(H, r0 + kTR);
    const int x0 = (rem % strips) * G::TW, x1 = min(W, x0 + G::TW);
    const int nq = x1 - x0 + 6;
    const float* xb = x + (size_t)b * H * W * Cin + c0;
    const float* dyb = dy + ((size_t)b * H * W + x0) * CO;

    // padded row pr's source row into slot `slot`: row q of the slot is
    // column col(x0 + q - 3), 64 channels from c0; zeros past Cin and past
    // nq, and outside the plane in zeros mode (a row outside is not read)
    auto load_row = [&](int pr, int slot) {
      int sy = pr - 3;
      if (reflect) sy = mirror(sy, H);
      else if (sy < 0 || sy >= H) return;
      const uint32_t dst = slot_sa + slot * G::SLOT;
      const float* src = xb + (size_t)sy * W * Cin;
      if (Cin % 4 == 0) {
        for (int i = tid; i < G::Q * 16; i += kWThreads) {
          const int q = i >> 4, pc = i & 15;
          int col = x0 + q - 3;
          bool ok = q < nq && c0 + 4 * pc < Cin;
          if (ok) {
            if (reflect) col = mirror(col, W);
            else ok = col >= 0 && col < W;
          }
          cp_async<16>(dst + (q * kPitch + 4 * pc) * 4,
                       ok ? src + (size_t)col * Cin + 4 * pc : x, ok ? 16 : 0);
        }
      } else {
        for (int i = tid; i < G::Q * 64; i += kWThreads) {
          const int q = i >> 6, c = i & 63;
          int col = x0 + q - 3;
          bool ok = q < nq && c0 + c < Cin;
          if (ok) {
            if (reflect) col = mirror(col, W);
            else ok = col >= 0 && col < W;
          }
          cp_async<4>(dst + (q * kPitch + c) * 4,
                      ok ? src + (size_t)col * Cin + c : x, ok ? 4 : 0);
        }
      }
    };
    // dy row oy of the strip staged as hi and lo planes (f, j) at (plane
    // CO + f) DY_LEN + j + kDyOff, j = -8 .. Q - 1, in ring slot oy %
    // kDyRing; zero outside [0, x1 - x0): thread tid fetches entries tid +
    // kWThreads k into registers, then splits and stores them
    auto fetch_dy = [&](int oy, float (&v)[G::DY_PER]) {
      const float* src = dyb + (size_t)oy * W * CO;
#pragma unroll
      for (int k = 0; k < G::DY_PER; ++k) {
        const int e = tid + kWThreads * k;
        const int j = e / CO - kDyOff, f = e % CO;
        v[k] = e < CO * G::DY_LEN && j >= 0 && j < x1 - x0
                   ? src[(size_t)j * CO + f]
                   : 0.f;
      }
    };
    auto store_dy = [&](int oy, const float (&v)[G::DY_PER]) {
      uint32_t* st = reinterpret_cast<uint32_t*>(dyst) +
                     (oy % kDyRing) * G::DY_ROW;
#pragma unroll
      for (int k = 0; k < G::DY_PER; ++k) {
        const int e = tid + kWThreads * k;
        if (e >= CO * G::DY_LEN) continue;
        const int at = (e % CO) * G::DY_LEN + e / CO;
        split_tf32(v[k], st[at], st[CO * G::DY_LEN + at]);
      }
    };
    // B_pr's hi and lo planes into buffer pr & 1: row n = (ky, kx, f) (rows
    // [wg NW, wg NW + NW) warpgroup wg's), zero for an output row pr - ky
    // outside the tile; K = the padded columns q in chunks of 32: B[q][n] =
    // dy[pr - ky][x0 + q - kx][f], 16-byte pieces of 4 q in the 128B
    // swizzle. Task (ky, f, piece p) reads the 10 staged values q - kx, q =
    // 4 p .. 4 p + 3, kx = 0..6, of each plane once and writes the pieces of
    // its 7 rows kx; slice s of `slices` builds the tasks tid + kWThreads
    // k, k = s, s + slices, ...
    auto build_b = [&](int pr, int slice, int slices) {
      uint8_t* bt = sm + (pr & 1) * G::B_BYTES;
      constexpr int pieces = G::Q / 4;
      for (int k = slice;; k += slices) {
        const int i = tid + kWThreads * k;
        if (i >= 7 * CO * pieces) break;
        const int p = i % pieces, f = i / pieces % CO, ky = i / (pieces * CO);
        const int oy = pr - ky;
        uint32_t v[2][10];
        if (oy >= r0 && oy < r1) {
          const uint32_t* st = reinterpret_cast<const uint32_t*>(dyst) +
                               (oy % kDyRing) * G::DY_ROW + f * G::DY_LEN +
                               4 * p + kDyOff - 6;
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 10; e += 2) {
              const uint2 u = *reinterpret_cast<const uint2*>(
                  st + h * CO * G::DY_LEN + e);
              v[h][e] = u.x;
              v[h][e + 1] = u.y;
            }
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 10; ++e) v[h][e] = 0u;
        }
#pragma unroll
        for (int kx = 0; kx < 7; ++kx) {
          const int n = (ky * 7 + kx) * CO + f;
          const uint32_t off = (p >> 3) * G::BT + swz(n, p & 7);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<uint4*>(bt + h * G::PLANE + off) =
                make_uint4(v[h][6 - kx], v[h][7 - kx], v[h][8 - kx],
                           v[h][9 - kx]);
        }
      }
    };

    __syncthreads();  // the previous tile's products and reads are done
    load_row(r0, r0 & 1);
    cp_async_commit();
    float dv[G::DY_PER];
    fetch_dy(r0, dv);
    store_dy(r0, dv);
    if (r0 + 1 < r1) {
      fetch_dy(r0 + 1, dv);
      store_dy(r0 + 1, dv);
    }
    __syncthreads();
    build_b(r0, 0, 1);
    fence_proxy_async();

    for (int p = r0; p < r1 + 6; ++p) {
      cp_async_wait<0>();
      __syncthreads();  // row p's slot and B_p visible; row p - 1 is done
      if (p + 1 < r1 + 6) load_row(p + 1, (p + 1) & 1);
      cp_async_commit();
      // dy row p + 2 is fetched now and stored after row p's products,
      // which B_p + 1 (from dy rows up to p + 1) is built under
      const bool stage = p + 2 < r1;
      if (stage) fetch_dy(p + 2, dv);
      auto work = [&](int slice, int slices) {
        if (p + 1 < r1 + 6) build_b(p + 1, slice, slices);
      };
      const bool live = reflect || (p >= 3 && p - 3 < H);
      // the warpgroup's output rows p - ky meet the tile
      const bool mine = p - ky_hi < r1 && p - ky_lo >= r0;
      if (live && mine) {
        const float* src = slots + (p & 1) * (G::SLOT / 4) + fch;
        const uint32_t bb =
            bsa + (p & 1) * G::B_BYTES + wg * G::NW * 128;
        row_products<CO>(sum, acc, src, bb, tq, work);
      } else {
        work(0, 1);
      }
      if (stage) store_dy(p + 2, dv);
      fence_proxy_async();  // B_p + 1 visible to wgmma after the barrier
    }
  }

  // the block's partial: D[c][(ky, kx, f)] -> part[i][ky][kx][c][f]; M row
  // acc_row(t, h) is channel fch + h, column j of the warpgroup is N's
  // column wg NW + j
  float* pz = part + (size_t)blockIdx.x * 49 * Cin * CO;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = c0 + fch + h;
    if (c >= Cin) continue;
#pragma unroll
    for (int j = 0; j < G::NW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = wg * G::NW + acc_col(t, j) + e;
        if (n >= G::TAPS) continue;
        const int ky = n / (7 * CO), kx = n % (7 * CO) / CO, f = n % CO;
        pz[((size_t)(ky * 7 + kx) * Cin + c) * CO + f] = sum[4 * j + 2 * h + e];
      }
  }
}

// dw[e] = sum over chunks, in order, of part[chunk][e].
__global__ void conv7_wgrad_tf32_sum_kernel(const float* __restrict__ part,
                                            float* __restrict__ dw, int n,
                                            int chunks) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int k = 0; k < chunks; ++k) s += part[(size_t)k * n + e];
  dw[e] = s;
}

template <int CO>
cudaError_t wgrad(const float* x, const float* dy, float* part, float* dw,
                  int B, int H, int W, int Cin, int reflect, int chunks,
                  cudaStream_t stream) {
  const auto kernel = conv7_wgrad_tf32_kernel<CO>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<CO>::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(chunks, (Cin + 63) / 64), kWThreads, Geo<CO>::SMEM,
           stream>>>(x, dy, part, B, H, W, Cin, reflect);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = 49 * Cin * CO;
  conv7_wgrad_tf32_sum_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      part, dw, n, chunks);
  return cudaGetLastError();
}

}  // namespace

// fp32 weight gradient, called by uig_conv7_wgrad (csrc/conv7_bwd.cu): x
// (B, H, W, Cin), dy (B, H, W, Cout), dw (7, 7, Cin, Cout); part (chunks,
// 49, Cin, Cout) fp32 scratch, chunks >= 1 persistent blocks a 64-channel
// slice. 1 <= Cout <= 4, any Cin, reflect needs H, W >= 4.
cudaError_t conv7_wgrad_fp32_tf32(const void* x, const void* dy, float* part,
                                  void* dw, int B, int H, int W, int Cin,
                                  int Cout, int reflect, int chunks,
                                  cudaStream_t stream) {
  if (chunks < 1) return cudaErrorInvalidValue;
  const auto* xf = static_cast<const float*>(x);
  const auto* d = static_cast<const float*>(dy);
  auto* o = static_cast<float*>(dw);
  switch (Cout) {
    case 1: return wgrad<1>(xf, d, part, o, B, H, W, Cin, reflect, chunks,
                            stream);
    case 2: return wgrad<2>(xf, d, part, o, B, H, W, Cin, reflect, chunks,
                            stream);
    case 3: return wgrad<3>(xf, d, part, o, B, H, W, Cin, reflect, chunks,
                            stream);
    case 4: return wgrad<4>(xf, d, part, o, B, H, W, Cin, reflect, chunks,
                            stream);
    default: return cudaErrorInvalidValue;
  }
}
