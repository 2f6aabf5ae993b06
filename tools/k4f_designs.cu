// The four variants of csrc/conv7_tc.cu's conv7_mma_kernel (K4f's bf16
// forward) that it was chosen over; tools/k4f_designs.py builds this file
// beside the port's sources and times them against the port's kernel. It
// is on no path of the port. The kernel below is the port's with four
// compile-time knobs, and at <COUT, 9, 1, 1, 1> it computes the port's
// kernel (the tool checks that its output is bit-equal):
//   TILES  m16 tiles of a strip at most (4: two blocks an SM, half the
//          shared memory each, narrower strips and more halo columns);
//   TPW    m16 tiles a warp (2: each B fragment read from shared memory
//          once for two tiles, half the warps);
//   ACCS   accumulator sets, taken by ky % ACCS (2: 2 NT independent
//          chains of mma.sync a warp; Z is their fp32 sum);
//   AHEAD  source rows loading ahead of the row whose products run.
#include "conv7_tc.cu"

namespace {

// csrc/conv7_tc.cu's Layout with a ring of `slots` source rows.
struct VLayout {
  int cp, pitch, slot, ring, bbytes, total;
  __host__ __device__ VLayout(int cin, int nt, int mt, int slots) {
    cp = (cin + 15) / 16 * 16;
    pitch = 2 * cp + 16;
    slot = 16 * mt * pitch;
    ring = slots * slot;
    bbytes = 7 * (cp / 16) * nt * 32 * 8;
    total = ring + bbytes + 16 * mt * nt * 8 * 4;
  }
};

template <int COUT, int TILES, int TPW, int ACCS, int AHEAD>
__global__ void __launch_bounds__(32 * ((TILES + TPW - 1) / TPW),
                                  TILES <= 4 ? 2 : 1)
    conv7_variant_kernel(const bf16* __restrict__ x,
                         const bf16* __restrict__ w,
                         const bf16* __restrict__ bias, bf16* __restrict__ y,
                         int H, int W, int Cin, int reflect, int tw, int rows,
                         int mt) {
  constexpr int NT = COUT;
  constexpr int kZp = NT * 8;  // fp32 a Z row
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads / 32;
  const VLayout L(Cin, NT, mt, 7 + AHEAD);
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
    const uint32_t dst = ring + (sy % (7 + AHEAD)) * L.slot;
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
  for (int a = 1; a < AHEAD; ++a) {
    if (r0 + 3 + a <= s_hi) load_row(r0 + 3 + a);
    cp_async_commit();
  }

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
  // the warp's m16 tiles warp + u nwarps, u < TPW; ldmatrix.x4: lanes 0-7
  // address rows 0-7 of a tile at k 0-7, 8-15 rows 8-15, 16-23 rows 0-7 at
  // k 8-15, 24-31 rows 8-15 at k 8-15
  uint32_t a_off[TPW];
  bool active[TPW];
#pragma unroll
  for (int u = 0; u < TPW; ++u) {
    const int tile = warp + u * nwarps;
    active[u] = tile < mt && tile * 16 < ncols;
    a_off[u] = (tile * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * L.pitch +
               (lane >> 4) * 16;
  }
  const int g = lane >> 2, t = lane & 3;

  for (int oy = r0; oy < r1; ++oy) {
    if (oy + 3 + AHEAD <= s_hi) load_row(oy + 3 + AHEAD);
    cp_async_commit();
    cp_async_wait<AHEAD>();
    __syncthreads();  // rows up to oy + 3 landed; B built (first row)

    if (active[0]) {
      float accs[ACCS][TPW][NT][4];
#pragma unroll
      for (int v = 0; v < ACCS; ++v)
#pragma unroll
        for (int u = 0; u < TPW; ++u)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) accs[v][u][nt][i] = 0.f;
#pragma unroll
      for (int ky = 0; ky < 7; ++ky) {
        float(&acc)[TPW][NT][4] = accs[ky % ACCS];
        int sy = oy + ky - 3;
        if (reflect) sy = mirror(sy, H);
        else if (sy < 0 || sy >= H) continue;
        const uint32_t a0 = ring + (sy % (7 + AHEAD)) * L.slot;
        const uint2* bk = bfrag + ky * cs_n * NT * 32 + lane;
#pragma unroll 2
        for (int cs = 0; cs < cs_n; ++cs) {
          uint2 bb[NT];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) bb[nt] = bk[(cs * NT + nt) * 32];
#pragma unroll
          for (int u = 0; u < TPW; ++u) {
            if (!active[u]) continue;
            uint32_t a[4];
            ldmatrix_x4(a, a0 + a_off[u] + cs * 32);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma_bf16(acc[u][nt], a, bb[nt].x, bb[nt].y);
          }
        }
      }
#pragma unroll
      for (int v = 1; v < ACCS; ++v)
#pragma unroll
        for (int u = 0; u < TPW; ++u)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) accs[0][u][nt][i] += accs[v][u][nt][i];
      // Z rows tile 16 + g (+ 8), columns nt 8 + 2 t (+1)
#pragma unroll
      for (int u = 0; u < TPW; ++u) {
        if (!active[u]) continue;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float* zr = z + ((warp + u * nwarps) * 16 + g) * kZp + nt * 8 + 2 * t;
          *reinterpret_cast<float2*>(zr) =
              make_float2(accs[0][u][nt][0], accs[0][u][nt][1]);
          *reinterpret_cast<float2*>(zr + 8 * kZp) =
              make_float2(accs[0][u][nt][2], accs[0][u][nt][3]);
        }
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

template <int COUT, int TILES, int TPW, int ACCS, int AHEAD>
cudaError_t launch_variant(const bf16* x, const bf16* w, const bf16* bias,
                           bf16* y, int B, int H, int W, int Cin, int reflect,
                           cudaStream_t stream) {
  // shared memory a block may take: all of it, or half an SM's less the
  // 1 KB the SM reserves a block where two blocks share an SM
  constexpr int cap_bytes = TILES <= 4 ? 233472 / 2 - 1024 : 232448;
  // the widest strips whose block fits in the shared memory
  int mt = 0, tw = 0, strips = 0, smem = 0;
  for (int cap = TILES; cap >= 1; --cap) {
    strips = (W + 16 * cap - 7) / (16 * cap - 6);
    tw = (W + strips - 1) / strips;
    mt = (std::min(W, tw + 6) + 15) / 16;
    smem = VLayout(Cin, COUT, mt, 7 + AHEAD).total;
    if (smem <= cap_bytes) break;
  }
  if (smem > cap_bytes) return cudaErrorInvalidValue;
  int rows = kRows;
  while (rows > 8 && (long long)strips * ((H + rows - 1) / rows) * B < 120)
    rows /= 2;
  const auto kernel = conv7_variant_kernel<COUT, TILES, TPW, ACCS, AHEAD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(strips, (H + rows - 1) / rows, B);
  kernel<<<grid, 32 * ((mt + TPW - 1) / TPW), smem, stream>>>(
      x, w, bias, y, H, W, Cin, reflect, tw, rows, mt);
  return cudaGetLastError();
}

}  // namespace

// Variant v of the head's forward, bf16, Cout 3: 0 the port's kernel
// (9, 1, 1, 1); 1 rows loading two ahead (9, 1, 1, 2); 2 that with two
// accumulator sets (9, 1, 2, 2); 3 that with strips of 4 tiles (4, 1, 1,
// 2); 4 that with two tiles a warp (9, 2, 1, 2). Arguments as
// uig_conv7_fwd's, Cout fixed.
extern "C" cudaError_t k4f_design_fwd(const void* x, const void* w,
                                      const void* bias, void* y, int B, int H,
                                      int W, int Cin, int reflect, int v,
                                      cudaStream_t stream) {
  if (Cin % 4) return cudaErrorInvalidValue;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* wb = static_cast<const bf16*>(w);
  const auto* bb = static_cast<const bf16*>(bias);
  auto* yb = static_cast<bf16*>(y);
  switch (v) {
    case 0:
      return launch_variant<3, 9, 1, 1, 1>(xb, wb, bb, yb, B, H, W, Cin,
                                           reflect, stream);
    case 1:
      return launch_variant<3, 9, 1, 1, 2>(xb, wb, bb, yb, B, H, W, Cin,
                                           reflect, stream);
    case 2:
      return launch_variant<3, 9, 1, 2, 2>(xb, wb, bb, yb, B, H, W, Cin,
                                           reflect, stream);
    case 3:
      return launch_variant<3, 4, 1, 1, 2>(xb, wb, bb, yb, B, H, W, Cin,
                                           reflect, stream);
    case 4:
      return launch_variant<3, 9, 2, 1, 2>(xb, wb, bb, yb, B, H, W, Cin,
                                           reflect, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
