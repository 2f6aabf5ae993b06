// K4f in bf16 on Hopper's tensor cores: the 7x7 stride-1 pad-3 conv
// (reflect or zeros) + bias for few output channels (the generator head,
// Cin 64 -> Cout 3 at 256^2). The entry point of csrc/conv7.cu launches
// it for bf16 (csrc/conv7_tf32.cu for fp32) and states the TPU kernel both
// replace.
//   x (B, H, W, Cin), w (7, 7, Cin, Cout), bias (Cout,) -> y (B, H, W, Cout)
//
// Bound on this card (H100 SXM data sheet, 700 W): bytes. At (16, 256, 256,
// 64) -> 3 the x read is 134 MB, 0.040 ms at 3.35 TB/s; the products, 2 *
// 16 * 256^2 * 3 * 49 * 64 = 19.7 GFLOP, take 0.020 ms at the 989 TFLOP/s
// bf16 rate. The FMA design (one thread a pixel, 4 fp32 accumulators for
// Cout <= 4) issued one scalar and one float4 shared load per 4 FMAs and
// was bound by shared-load issue, ~34x its bound.
//
// Design: the 7 horizontal taps fold into N. For output row oy,
//   Z[p][(kx, f)] = sum over (ky, c) of x[row(oy + ky - 3), p][c] *
//                   w[ky][kx][c][f],
// a GEMM with M = the source columns p of a strip, K = 7 Cin (ky, then c)
// and N = 7 Cout padded to n8 tiles (NT = 3 at Cout 3), on mma.sync
// m16n8k16 bf16 (fp32 accumulators: the bf16 products are exact); then
//   y[oy][ox][f] = round_bf16((sum over kx = 0..6, in order, of
//                  Z[col(ox + kx - 3)][(kx, f)]) + bias[f])
// in fp32, with row() and col() mirroring the index in reflect mode and
// dropping the term outside the plane in zeros mode. The straight im2col
// GEMM (N = Cout padded to 8, K = 49 Cin) does 2.7x these products and
// reads each A fragment for one n8 tile instead of NT.
//   - A: a block owns a strip of output columns [x0, x0 + tw) (tw <= 138,
//     two strips at W = 256) and walks kRows output rows down it. Its
//     source rows sit in a ring of 8 shared-memory slots (slot = row % 8),
//     each the strip's source columns [x0 - 3, x0 + tw + 3) clipped to the
//     plane (every mirrored column falls inside) x Cin channels, padded to
//     whole k16 steps with zeros and a pitch of 2 Cp + 16 bytes, so that
//     the 8 rows of an ldmatrix hit 8 distinct 16-byte bank groups. Each
//     row is read from device memory once a block (the halo rows of the
//     row group once more) by cp.async, 16-byte pieces (8-byte where Cin %
//     8 == 4) with zero fill past Cin; row oy + 4 loads while row oy's
//     products run. Warp i owns m16 tile i of the strip (9 warps at most)
//     and reads its A fragments with ldmatrix.x4.
//   - B: w as a (7 Cp) x (NT 8) matrix, B[(ky, c)][(kx, f)] = w[ky][kx][c]
//     [f], zeros past Cin and 7 Cout, is built once a block in the mma's
//     fragment order (one 8-byte load a lane a fragment), 21.5 KB at Cin
//     64, resident for the block's life.
//   - The row's Z goes through shared memory (fp32) for the shift-sum, and
//     one thread an output (ox, f) writes y's strip row, rounded once.
// One block an SM (~201 KB of shared memory at Cin 64). Every sum runs in
// a fixed order and there are no atomics: repeats are bit-equal.
//
// tools/k4f_designs.py times this kernel against four variants of it
// (tools/k4f_designs.cu) on the head's shapes; PERF.md gives the times.
// None was faster: rows loading two ahead (the loads are not what the rows
// wait on); two accumulator sets, the ky taps by parity; two m16 tiles a
// warp (each B fragment read once for both, 5 warps a block: fewer threads
// for the loads and the shift-sum); strips of 4 tiles at two blocks an SM
// (more halo columns). The straight im2col GEMM was not built: it does
// 2.7x these products and reads each A fragment for one n8 tile.
//
// Shapes: Cout 1..4, Cin % 4 == 0 with the ring and B within the shared
// memory (Cin <= 256 at Cout 4; the wrapper checks), ragged H and W, H, W
// >= 4 for reflect.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "dtype.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kMaxTiles = 9;  // m16 tiles of a strip at most, a warp each
constexpr int kRing = 8;      // source-row slots: 7 in use, 1 loading
constexpr int kRows = 32;     // output rows a block walks (fewer if the
                              // grid would not fill the card)
constexpr int kSmemCap = 232448;  // shared memory a block may take: all

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += A (16 x 16, row) B (16 x 8, col), bf16 products into fp32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory of a block over mt m16 tiles: the ring, then B's
// fragments, then Z (16 mt rows of NT 8 fp32).
struct Layout {
  int cp, pitch, slot, ring, bbytes, total;
  __host__ __device__ Layout(int cin, int nt, int mt) {
    cp = (cin + 15) / 16 * 16;
    pitch = 2 * cp + 16;
    slot = 16 * mt * pitch;
    ring = kRing * slot;
    bbytes = 7 * (cp / 16) * nt * 32 * 8;
    total = ring + bbytes + 16 * mt * nt * 8 * 4;
  }
};

// grid (strips, ceil(H / rows), B), block 32 mt,
// Layout(Cin, COUT, mt).total dynamic. Block (s, g, b): output columns
// [s tw, min(W, (s + 1) tw)) of rows [g rows, min(H, (g + 1) rows)) of
// image b, over mt m16 tiles of source columns. N = 7 COUT padded to NT =
// COUT n8 tiles (ceil(7 COUT / 8) == COUT for COUT <= 4).
template <int COUT>
__global__ void __launch_bounds__(32 * kMaxTiles, 1)
    conv7_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     const bf16* __restrict__ bias, bf16* __restrict__ y,
                     int H, int W, int Cin, int reflect, int tw, int rows,
                     int mt) {
  constexpr int NT = COUT;
  constexpr int kZp = NT * 8;  // fp32 a Z row
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const Layout L(Cin, NT, mt);
  const int cs_n = L.cp / 16;  // k16 steps a source row
  const uint32_t ring = smem_u32(smem);
  uint2* bfrag = reinterpret_cast<uint2*>(smem + L.ring);
  float* z = reinterpret_cast<float*>(smem + L.ring + L.bbytes);

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * tw, x1 = min(W, x0 + tw);
  if (x0 >= W) return;  // the whole block: no strip left
  const int lo = max(0, x0 - 3), ncols = min(W, x1 + 3) - lo;
  const int r0 = blockIdx.y * rows, r1 = min(H, r0 + rows);
  const int s_lo = max(0, r0 - 3), s_hi = min(H - 1, r1 + 2);
  const bf16* xb = x + (size_t)b * H * W * Cin;

  // source row sy's strip into its slot: 16-byte pieces (8 channels) where
  // Cin % 8 == 0, else 8-byte pieces; zeros from Cin to Cp
  auto load_row = [&](int sy) {
    const uint32_t dst = ring + (sy % kRing) * L.slot;
    const bf16* src = xb + ((size_t)sy * W + lo) * Cin;
    if (Cin % 8 == 0) {
      const int pp = L.cp / 8;
      for (int i = tid; i < ncols * pp; i += nthreads) {
        const int px = i / pp, c = (i - px * pp) * 8;
        const bool ok = c < Cin;
        cp_async<16>(dst + px * L.pitch + 2 * c,
                     ok ? src + (size_t)px * Cin + c : x, ok ? 16 : 0);
      }
    } else {
      const int pp = L.cp / 4;
      for (int i = tid; i < ncols * pp; i += nthreads) {
        const int px = i / pp, c = (i - px * pp) * 4;
        const bool ok = c < Cin;
        cp_async<8>(dst + px * L.pitch + 2 * c,
                    ok ? src + (size_t)px * Cin + c : x, ok ? 8 : 0);
      }
    }
  };
  // the first row's window as one group, then one group a row ahead
  for (int sy = s_lo; sy <= min(s_hi, r0 + 3); ++sy) load_row(sy);
  cp_async_commit();

  // B in fragment order: entry ((ks NT + nt) 32 + lane) holds lane's two
  // registers of k16 step ks = ky cs_n + cs, n8 tile nt: rows k = cs 16 +
  // 2 t (+1) and + 8 (+9), column n = nt 8 + g (g = lane / 4, t = lane % 4)
  {
    const uint16_t* wu = reinterpret_cast<const uint16_t*>(w);
    for (int e = tid; e < 7 * cs_n * NT * 32; e += nthreads) {
      const int ln = e & 31, q = e >> 5;
      const int nt = q % NT, ks = q / NT;
      const int ky = ks / cs_n, cs = ks - ky * cs_n;
      const int n = nt * 8 + (ln >> 2);
      const int kx = n / COUT, f = n - kx * COUT;
      const int c = cs * 16 + 2 * (ln & 3);
      auto wv = [&](int ci) -> uint32_t {
        return n < 7 * COUT && ci < Cin
                   ? wu[((size_t)(ky * 7 + kx) * Cin + ci) * COUT + f]
                   : 0u;
      };
      bfrag[e] = make_uint2(wv(c) | wv(c + 1) << 16,
                            wv(c + 8) | wv(c + 9) << 16);
    }
  }
  // the warp's m16 tile; ldmatrix.x4: lanes 0-7 address rows 0-7 of the
  // tile at k 0-7, 8-15 rows 8-15, 16-23 rows 0-7 at k 8-15, 24-31 rows
  // 8-15 at k 8-15
  const bool active = warp * 16 < ncols;
  const uint32_t a_off =
      (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * L.pitch +
      (lane >> 4) * 16;
  const int g = lane >> 2, t = lane & 3;

  for (int oy = r0; oy < r1; ++oy) {
    if (oy + 4 <= s_hi) load_row(oy + 4);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // rows up to oy + 3 landed; B built (first row)

    if (active) {
      float acc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
#pragma unroll
      for (int ky = 0; ky < 7; ++ky) {
        int sy = oy + ky - 3;
        if (reflect) sy = mirror(sy, H);
        else if (sy < 0 || sy >= H) continue;
        const uint32_t a0 = ring + (sy % kRing) * L.slot;
        const uint2* bk = bfrag + ky * cs_n * NT * 32 + lane;
#pragma unroll 2
        for (int cs = 0; cs < cs_n; ++cs) {
          uint2 bb[NT];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) bb[nt] = bk[(cs * NT + nt) * 32];
          uint32_t a[4];
          ldmatrix_x4(a, a0 + a_off + cs * 32);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_bf16(acc[nt], a, bb[nt].x, bb[nt].y);
        }
      }
      // Z rows warp 16 + g (+ 8), columns nt 8 + 2 t (+1)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float* zr = z + (warp * 16 + g) * kZp + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(zr) = make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(zr + 8 * kZp) =
            make_float2(acc[nt][2], acc[nt][3]);
      }
    }
    __syncthreads();  // Z visible; every warp done with row oy - 3's slot

    bf16* yr = y + (((size_t)b * H + oy) * W + x0) * COUT;
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
      yr[i] = from_f32<bf16>(s + to_f32(bias[f]));
    }
  }
  cp_async_wait<0>();
}

template <int COUT>
cudaError_t launch(const bf16* x, const bf16* w, const bf16* bias, bf16* y,
                   int B, int H, int W, int Cin, int reflect,
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
  const auto kernel = conv7_mma_kernel<COUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(strips, (H + rows - 1) / rows, B);
  kernel<<<grid, 32 * mt, smem, stream>>>(
      x, w, bias, y, H, W, Cin, reflect, tw, rows, mt);
  return cudaGetLastError();
}

}  // namespace

// bf16 forward, called by uig_conv7_fwd (csrc/conv7.cu) with the shapes it
// documents.
cudaError_t conv7_fwd_bf16_mma(const void* x, const void* w, const void* bias,
                               void* y, int B, int H, int W, int Cin,
                               int Cout, int reflect, cudaStream_t stream) {
  if (Cin % 4 || Cout < 1 || Cout > 4) return cudaErrorInvalidValue;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* wb = static_cast<const bf16*>(w);
  const auto* bb = static_cast<const bf16*>(bias);
  auto* yb = static_cast<bf16*>(y);
  switch (Cout) {
    case 1:
      return launch<1>(xb, wb, bb, yb, B, H, W, Cin, reflect, stream);
    case 2:
      return launch<2>(xb, wb, bb, yb, B, H, W, Cin, reflect, stream);
    case 3:
      return launch<3>(xb, wb, bb, yb, B, H, W, Cin, reflect, stream);
    default:
      return launch<4>(xb, wb, bb, yb, B, H, W, Cin, reflect, stream);
  }
}
