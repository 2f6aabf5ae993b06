// K4f in fp32 on Hopper's tensor cores, in the three-term TF32 split: the
// 7x7 stride-1 pad-3 conv (reflect or zeros) + bias for few output channels
// (the generator head, Cin 64 -> Cout 3 at 256^2). The entry point of
// csrc/conv7.cu launches it for fp32 and states the TPU kernel it replaces
// (src/uig/kernels/conv_pallas.py, _conv5_impl -> _conv5_kernel, as
// conv7_s2d reaches it).
//   x (B, H, W, Cin), w (7, 7, Cin, Cout), bias (Cout,) -> y (B, H, W, Cout)
//
// Bound on this card (H100 SXM data sheet, 700 W): operations. At (16, 256,
// 256, 64) -> 3 the products are 2 * 16 * 256^2 * 3 * 49 * 64 = 19.7 GFLOP;
// the split runs each as three TF32 products, 59.2 GFLOP at 495 TFLOP/s
// dense TF32: 0.120 ms (the x read, 268 MB, takes 0.080 ms at 3.35 TB/s).
// The FMA design before it (one thread a pixel, 4 fp32 accumulators for
// Cout 3, one scalar and one float4 shared load per 4 FMAs) was bound by
// shared-load issue at 20 % of even the FMA bound.
//
// Numerics: each fp32 operand becomes hi = rna_tf32(v) and lo = rna_tf32(v
// - hi) (csrc/tf32.cuh), and each product is summed as lo_x hi_w + hi_x
// lo_w + hi_x hi_w into fp32. The tensor core sums a partial of one k8 step
// (8 channels of one row tap, the three terms in that order) in a fresh
// accumulator; each partial is added to its output's fp32 register sum with
// a rounded fp32 add, in the order (ky, then channels). UIG_K4F_DEPTH = 0
// instead sums all of a Z value's 7 Cin products in the accumulator;
// tools/k4f_depths.py measures both against float64 (PERF.md). Plain
// single-pass TF32 is not used.
//
// Design: the 7 column taps fold into N, as in the bf16 kernel
// (csrc/conv7_tc.cu). For output row oy,
//   Z[p][(kx, f)] = sum over (ky, c) of x[row(oy + ky - 3), p][c] *
//                   w[ky][kx][c][f],
// a GEMM with M = the source columns p of a strip, K = 7 Cin and N = 7 Cout
// padded to n8 tiles (NT = Cout, 24 columns at Cout 3), on mma.sync m16n8k8
// tf32; then
//   y[oy][ox][f] = (sum over kx = 0..6, in order, of Z[col(ox + kx - 3)]
//                  [(kx, f)]) + bias[f]
// in fp32, with row() and col() mirroring in reflect mode and dropping the
// term outside the plane in zeros mode.
//   - Shared memory: in fp32 the bf16 kernel's ring of 8 source rows
//     doubles (313 KB for a 144-column strip at Cin 64) and B's hi and lo
//     planes take 86 KB, so the ring cannot stay. Instead a block walks the
//     padded rows P = r0 .. r1 + 5 of its output rows [r0, r1) once each:
//     padded row P (source row row(P - 3)) meets output rows P - ky, ky =
//     0..6, so each warp keeps the sums of 7 pending output rows in
//     registers (7 x NT x 4 fp32 a thread) and reads each A fragment from
//     shared memory, and splits it, once for all 7 taps. Output row P - 6
//     is complete after padded row P. Two row slots remain (one in use,
//     one loading by cp.async: 16-byte pieces, 4-byte ones where Cin % 4 !=
//     0, zero fill past Cin), 78 KB at Cin 64; a mirrored row is read again
//     (from L2), only at the plane's edges.
//   - A: warp i owns m16 tile i of the strip (16 source columns, 9 warps at
//     most, strips of up to 138 output columns, two at W = 256); ldmatrix
//     .x4 on the fp32 slot gives the m16n8k8 tf32 fragment (each 8 x 16-
//     byte matrix is 8 rows x 4 fp32), with a row pitch of 4 Cp + 16 bytes
//     so that its 8 rows hit 8 distinct 16-byte bank groups.
//   - B: w as a (7 Cp) x (NT 8) matrix, split into hi and lo once a block
//     and kept in the mma's fragment order (one 16-byte load a lane gives a
//     fragment's hi and lo pair), 86 KB at Cin 64, for the block's life.
//   - The completed row's Z goes through shared memory (fp32) for the
//     shift-sum; one thread an output (ox, f) writes y's strip row.
// One block an SM (~174 KB of shared memory at Cin 64, Cout 3). Every sum
// runs in a fixed order and there are no atomics: repeats are bit-equal.
//
// Weighed and not built: wgmma m64n24k8 tf32 with B (W^T's hi and lo
// planes, K-major) in shared memory, as K3 and K4s's fp32 kernels run. It
// would read each B fragment once a warpgroup instead of once a warp, but
// its M tile is 64 source columns: a 256-wide plane then runs 320 or 384
// rows of M for 268 (19-43 % of its products wasted, against 7 % for
// m16 tiles), and 64-column units of the pending-row walk keep three times
// the source columns resident, which does not fit beside B's 86 KB. The
// straight im2col GEMM (N = Cout padded to 8, K = 49 Cin) does 2.7x these
// products. UIG_K4F_DEPTH is the one build switch (tools only).
//
// Shapes: Cout 1..4, any Cin with B's fragments and two source rows of a
// one-tile strip within the shared memory (Cin <= 112 at Cout 4; the
// wrapper checks MAX_CIN_FP32), ragged H and W, H, W >= 4 for reflect.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "tf32.cuh"
#include "wgmma.cuh"

#ifndef UIG_K4F_DEPTH
#define UIG_K4F_DEPTH 1
#endif

namespace {

constexpr int kMaxTiles = 9;  // m16 tiles of a strip at most, a warp each
constexpr int kRows = 32;     // output rows a block (fewer if the grid
                              // would not fill the card)
constexpr int kSmemCap = 232448;  // shared memory a block may take: all
constexpr int kDepth = UIG_K4F_DEPTH;  // k8 steps a partial (0: all of Z)
static_assert(kDepth == 0 || kDepth == 1, "UIG_K4F_DEPTH: 1, or 0 for all");

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += A (16 x 8, row) B (8 x 8, col), tf32 products into fp32.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory of a block over mt m16 tiles: two row slots, B's
// fragments, then Z (16 mt rows of NT 8 fp32).
struct Layout {
  int cp, pitch, slot, bbytes, total;
  __host__ __device__ Layout(int cin, int nt, int mt) {
    cp = (cin + 7) / 8 * 8;
    pitch = 4 * cp + 16;
    slot = 16 * mt * pitch;
    bbytes = 7 * (cp / 8) * nt * 32 * 16;
    total = 2 * slot + bbytes + 16 * mt * nt * 8 * 4;
  }
};

// grid (strips, ceil(H / rows), B), block 32 mt, Layout(Cin, COUT,
// mt).total dynamic. Block (s, g, b): output columns [s tw, min(W, (s + 1)
// tw)) of rows [g rows, min(H, (g + 1) rows)) of image b, over mt m16 tiles
// of source columns. N = 7 COUT padded to NT = COUT n8 tiles.
template <int COUT>
__global__ void __launch_bounds__(32 * kMaxTiles, 1)
    conv7_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias, float* __restrict__ y,
                      int H, int W, int Cin, int reflect, int tw, int rows,
                      int mt) {
  constexpr int NT = COUT;
  constexpr int kZp = NT * 8;  // fp32 a Z row
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const Layout L(Cin, NT, mt);
  const int ks_n = L.cp / 8;  // k8 steps a source row
  const uint32_t ring = smem_u32(smem);
  uint4* bfrag = reinterpret_cast<uint4*>(smem + 2 * L.slot);
  float* z = reinterpret_cast<float*>(smem + 2 * L.slot + L.bbytes);

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * tw, x1 = min(W, x0 + tw);
  if (x0 >= W) return;  // the whole block: no strip left
  const int lo = max(0, x0 - 3), ncols = min(W, x1 + 3) - lo;
  const int r0 = blockIdx.y * rows, r1 = min(H, r0 + rows);
  const int p_end = r1 + 6;  // padded rows r0 .. r1 + 5
  const float* xb = x + (size_t)b * H * W * Cin;

  // the source row of padded row P, or -1 (zeros mode, outside the plane)
  auto source = [&](int P) {
    const int sy = P - 3;
    if (reflect) return mirror(sy, H);
    return sy >= 0 && sy < H ? sy : -1;
  };
  // source row sy's strip into slot s: 16-byte pieces (4 channels) where
  // Cin % 4 == 0, else 4-byte ones; zeros from Cin to Cp
  auto load_row = [&](int sy, int s) {
    const uint32_t dst = ring + s * L.slot;
    const float* src = xb + ((size_t)sy * W + lo) * Cin;
    if (Cin % 4 == 0) {
      const int pp = L.cp / 4;
      for (int i = tid; i < ncols * pp; i += nthreads) {
        const int px = i / pp, c = (i - px * pp) * 4;
        const bool ok = c < Cin;
        cp_async<16>(dst + px * L.pitch + 4 * c,
                     ok ? src + (size_t)px * Cin + c : x, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < ncols * L.cp; i += nthreads) {
        const int px = i / L.cp, c = i - px * L.cp;
        const bool ok = c < Cin;
        cp_async<4>(dst + px * L.pitch + 4 * c,
                    ok ? src + (size_t)px * Cin + c : x, ok ? 4 : 0);
      }
    }
  };
  {
    const int sy = source(r0);
    if (sy >= 0) load_row(sy, r0 & 1);
    cp_async_commit();
  }

  // B in fragment order, split: entry ((ks NT + nt) 32 + lane) holds lane's
  // {hi b0, hi b1, lo b0, lo b1} of k8 step ks = ky ks_n + cs, n8 tile nt:
  // rows k = cs 8 + t and + 4, column n = nt 8 + g (g = lane / 4, t = lane
  // % 4)
  for (int e = tid; e < 7 * ks_n * NT * 32; e += nthreads) {
    const int ln = e & 31, q = e >> 5;
    const int nt = q % NT, ks = q / NT;
    const int ky = ks / ks_n, cs = ks - ky * ks_n;
    const int n = nt * 8 + (ln >> 2);
    const int kx = n / COUT, f = n - kx * COUT;
    const int c = cs * 8 + (ln & 3);
    auto wv = [&](int ci) -> float {
      return n < 7 * COUT && ci < Cin
                 ? w[((size_t)(ky * 7 + kx) * Cin + ci) * COUT + f]
                 : 0.f;
    };
    uint32_t h0, l0, h1, l1;
    split(wv(c), h0, l0);
    split(wv(c + 4), h1, l1);
    bfrag[e] = make_uint4(h0, h1, l0, l1);
  }

  // the warp's m16 tile; ldmatrix.x4: lanes 0-7 address rows 0-7 of the
  // tile at k 0-3, 8-15 rows 8-15, 16-23 rows 0-7 at k 4-7, 24-31 rows 8-15
  // at k 4-7 (a row of a matrix: 4 fp32)
  const bool active = warp * 16 < ncols;
  const uint32_t a_off =
      (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * L.pitch +
      (lane >> 4) * 16;
  const int g = lane >> 2, t = lane & 3;

  // acc[i]: the sums of output row P - 6 + i (tap ky = 6 - i of row P)
  float acc[7][NT][4];
#pragma unroll
  for (int i = 0; i < 7; ++i)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;

  for (int P = r0; P < p_end; ++P) {
    if (P + 1 < p_end) {
      const int sy = source(P + 1);
      if (sy >= 0) load_row(sy, (P + 1) & 1);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // padded row P landed; B built (first row)

    if (active && source(P) >= 0) {
      // the taps whose output row P - ky lies in [r0, r1)
      const int kmin = max(0, P - r1 + 1), kmax = min(6, P - r0);
      const uint32_t a0 = ring + (P & 1) * L.slot + a_off;
      const uint4* bk = bfrag + lane;
#pragma unroll 1
      for (int cs = 0; cs < ks_n; ++cs) {
        uint32_t a[4], ah[4], al[4];
        ldmatrix_x4(a, a0 + cs * 32);
#pragma unroll
        for (int i = 0; i < 4; ++i) split(__uint_as_float(a[i]), ah[i], al[i]);
#pragma unroll
        for (int ky = 0; ky < 7; ++ky) {
          if (ky < kmin || ky > kmax) continue;
          uint4 bb[NT];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            bb[nt] = bk[((ky * ks_n + cs) * NT + nt) * 32];
          float(&s)[NT][4] = acc[6 - ky];
          if constexpr (kDepth == 1) {
            float part[NT][4];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) part[nt][e] = 0.f;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma_tf32(part[nt], al, bb[nt].x, bb[nt].y);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma_tf32(part[nt], ah, bb[nt].z, bb[nt].w);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma_tf32(part[nt], ah, bb[nt].x, bb[nt].y);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) s[nt][e] += part[nt][e];
          } else {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma_tf32(s[nt], al, bb[nt].x, bb[nt].y);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma_tf32(s[nt], ah, bb[nt].z, bb[nt].w);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma_tf32(s[nt], ah, bb[nt].x, bb[nt].y);
          }
        }
      }
    }
    // output row P - 6 is complete: its Z, rows warp 16 + g (+ 8), columns
    // nt 8 + 2 t (+1); then the pending rows move down one
    const int oy = P - 6;
    if (active) {
      if (oy >= r0) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float* zr = z + (warp * 16 + g) * kZp + nt * 8 + 2 * t;
          *reinterpret_cast<float2*>(zr) =
              make_float2(acc[0][nt][0], acc[0][nt][1]);
          *reinterpret_cast<float2*>(zr + 8 * kZp) =
              make_float2(acc[0][nt][2], acc[0][nt][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][nt][e] = acc[i + 1][nt][e];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[6][nt][e] = 0.f;
    }
    __syncthreads();  // Z visible; every warp done with padded row P's slot

    if (oy >= r0) {
      float* yr = y + (((size_t)b * H + oy) * W + x0) * COUT;
      for (int i = tid; i < (x1 - x0) * COUT; i += nthreads) {
        const int ox = x0 + i / COUT, f = i - (i / COUT) * COUT;
        float s = 0.f;
#pragma unroll
        for (int kx = 0; kx < 7; ++kx) {
          int sx = ox + kx - 3;
          if (reflect) sx = mirror(sx, W);
          else if (sx < 0 || sx >= W) continue;
          s += z[(sx - lo) * kZp + kx * COUT + f];
        }
        yr[i] = s + bias[f];
      }
    }
  }
  cp_async_wait<0>();
}

template <int COUT>
cudaError_t launch(const float* x, const float* w, const float* bias,
                   float* y, int B, int H, int W, int Cin, int reflect,
                   cudaStream_t stream) {
  // the widest strips whose block fits in the shared memory
  int mt = 0, tw = 0, strips = 0, smem = 0;
  for (int cap = kMaxTiles; cap >= 1; --cap) {
    strips = (W + 16 * cap - 7) / (16 * cap - 6);
    tw = (W + strips - 1) / strips;
    mt = (std::min(W, tw + 6) + 15) / 16;
    smem = Layout(Cin, COUT, mt).total;
    if (smem <= kSmemCap) break;
  }
  if (smem > kSmemCap) return cudaErrorInvalidValue;
  int rows = kRows;
  while (rows > 8 && (long long)strips * ((H + rows - 1) / rows) * B < 120)
    rows /= 2;
  const auto kernel = conv7_tf32_kernel<COUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(strips, (H + rows - 1) / rows, B);
  kernel<<<grid, 32 * mt, smem, stream>>>(x, w, bias, y, H, W, Cin, reflect,
                                          tw, rows, mt);
  return cudaGetLastError();
}

}  // namespace

// fp32 forward, called by uig_conv7_fwd (csrc/conv7.cu) with the shapes it
// documents.
cudaError_t conv7_fwd_tf32(const void* x, const void* w, const void* bias,
                           void* y, int B, int H, int W, int Cin, int Cout,
                           int reflect, cudaStream_t stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  const auto* bf = static_cast<const float*>(bias);
  auto* yf = static_cast<float*>(y);
  switch (Cout) {
    case 1: return launch<1>(xf, wf, bf, yf, B, H, W, Cin, reflect, stream);
    case 2: return launch<2>(xf, wf, bf, yf, B, H, W, Cin, reflect, stream);
    case 3: return launch<3>(xf, wf, bf, yf, B, H, W, Cin, reflect, stream);
    case 4: return launch<4>(xf, wf, bf, yf, B, H, W, Cin, reflect, stream);
    default: return cudaErrorInvalidValue;
  }
}
