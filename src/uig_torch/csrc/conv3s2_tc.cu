// K4s in bf16 on Hopper's tensor cores: the forward and the weight gradient
// of the square k x k conv with zero padding and a stride over NHWC bf16
// (the generator's 3x3 stride-2 pad-1 downsamples d128: 64 -> 128 channels
// at 256^2, d256: 128 -> 256 at 128^2; with stride 1 and no padding the
// generic VALID conv). The fp32 kernels and the bf16 input gradient stay on
// the FMA core of csrc/conv3s2.cu, whose entry points launch these.
//   fwd:   x (B, H, W, C), w (k, k, C, F) [+ bias (F,)] -> y (B, Ho, Wo, F)
//   wgrad: x, dy (B, Ho, Wo, F) -> dw (k, k, C, F)
//
// Replaces: src/uig/kernels/conv_pallas.py, conv3s2_s2d and conv_core
// through _conv5_impl -> _conv5_kernel (fwd) and _wgrad5_impl ->
// _wgrad5_kernel (wgrad).
//
// Bound on this card (H100 SXM data sheet, 700 W): each path shape at batch
// 16 is 2 * 16 * 128^2 * 128 * 9 * 64 = 3.87e10 FLOP, 0.039 ms at the
// 989 TFLOP/s bf16 tensor-core rate. d128 moves 201 MB (x 134 MB, y or dy
// 67 MB), 0.060 ms at 3.35 TB/s: bytes bound it. d256 moves 101 MB,
// 0.030 ms: operations bound it. On fp32 FMAs the same FLOPs take 0.58 ms,
// so both kernels issue wgmma (bf16 products, exact in fp32, summed into
// fp32 accumulators in registers) and keep the tensor cores fed from a ring
// of shared-memory stages that the loads fill while the products run.
//
// Design: implicit GEMM, K in chunks of 64 channels of one tap (a ragged
// channel count is a chunk whose missing channels are zero). A block is two
// consumer warpgroups (256 threads); each issues
// wgmma.mma_async.m64n128k16.f32.bf16.bf16 on 128-byte-swizzled tiles of a
// kStages-deep ring. Every tile is rows of 128 bytes (64 bf16) in 1024-byte
// atoms of 8 rows, 16-byte piece j of row r at piece j ^ (r % 8), as TMA's
// CU_TENSOR_MAP_SWIZZLE_128B writes it. The A side is a gather: cp.async
// with src-size zero fill for padding, ragged edges and missing channels,
// 16-byte pieces when C % 8 == 0 and 8-byte pieces otherwise. The B side is
// a plain row-major matrix: TMA (cp.async.bulk.tensor, two 64 x 64 boxes a
// stage, completion on an mbarrier) when F % 8 == 0, so that its rows are
// 16-byte multiples, which covers the path; cp.async otherwise. TMA leaves
// the threads' issue slots to the A gather: on an H100 both kernels ran
// 10-15% faster at the path shapes than with B by 16-byte cp.async. Both
// kernels run one ring (mainloop) and differ in their loaders and
// epilogues. The order of every sum is fixed, no atomics: repeats are
// bit-equal.
//   fwd:   M = output pixels of the whole batch (128 a block), N = F (128 a
//          block), K = (tap, c): A is K-major (a row is one output pixel's
//          64 channels of the tap), B is the HWIO weight as a (k k C, F)
//          row-major matrix, N-major (imm-trans-b). Epilogue: acc + bias in
//          fp32, one round to nearest even, masked store of the edge.
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

#include <type_traits>

#include "dtype.cuh"

namespace {

constexpr int kStages = 3;
constexpr int kThreads = 256;           // two consumer warpgroups
constexpr int kTileBytes = 64 * 128;    // 64 rows of 128 bytes
constexpr int kStageBytes = 4 * kTileBytes;  // A: 2 tiles, B: 2 tiles
constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + alignment

// ------------------------------------------------------------- PTX glue --
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte piece `piece` of row `row` in a 128B-swizzled tile.
__device__ __forceinline__ uint32_t swz(int row, int piece) {
  return row * 128 + ((piece ^ (row & 7)) << 4);
}

// VEC-byte copy global -> shared; src_bytes < VEC fills the rest with zeros
// (0: no read at all).
template <int VEC>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int src_bytes) {
  if constexpr (VEC == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Make this thread's generic-proxy writes to shared memory (cp.async)
// visible to the async proxy (wgmma's operand reads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// 2-D TMA load of box (c0 inner, c1 outer) into shared memory at dst.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a 128B-swizzled operand at `addr`
// (1024-byte aligned atom, or an offset inside one along K): lbo is the
// byte stride between 64-element atoms along M/N (MN-major only), sbo the
// byte stride between groups of 8 rows.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits for every committed wgmma, then pins the accumulators so that no
// read of them is scheduled above the wait.
__device__ __forceinline__ void wgmma_wait0(float (&d)[64]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define UIG_R8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 fp32 a thread) += A (64 x 16) * B (16 x 128), both from shared
// memory; TA / TB: the operand is MN-major (read transposed).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %66, %67;\n"
      "}\n"
      : UIG_R8(0), UIG_R8(8), UIG_R8(16), UIG_R8(24), UIG_R8(32), UIG_R8(40),
        UIG_R8(48), UIG_R8(56)
      : "l"(da), "l"(db), "n"(TA), "n"(TB), "r"(1));
}
#undef UIG_R8

// The accumulator's layout (m64nNk16, fp32): thread t of the warpgroup
// holds d[4 j + 2 h + e] at row 16 (t / 32) + (t % 32) / 4 + 8 h and column
// 8 j + 2 (t % 4) + e, for j < N / 8 and h, e < 2.
__device__ __forceinline__ int acc_row(int t, int h) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * h;
}
__device__ __forceinline__ int acc_col(int t, int j) {
  return 8 * j + 2 * (t & 3);
}

// B as rows of a row-major (rows, N) bf16 matrix, the stage's 64 rows from
// `row0` and 128 columns from n0, into two 64 x 64 N-major tiles (columns
// n0 .. n0 + 63, then n0 + 64 .. n0 + 127). Rows at or past `row_end` and
// columns at or past N are zero. cp.async in VB-byte pieces: 8 (N % 4 == 0)
// where TMA cannot take the rows (N % 8 != 0); tools/k4s_b_loader_ab.py
// times 16 against TMA.
template <int VB>
__device__ __forceinline__ void load_b_cp_async(uint32_t dst, const bf16* b,
                                                int row0, int row_end, int N,
                                                int n0, int tid) {
  constexpr int kTilePieces = 128 / VB;  // pieces of a tile's 128-byte row
#pragma unroll
  for (int q = 0; q < 64 * 2 * kTilePieces / kThreads; ++q) {
    const int idx = tid + q * kThreads;  // (row, piece of the two tiles)
    const int r = idx / (2 * kTilePieces), p = idx % (2 * kTilePieces);
    const int half = p / kTilePieces, pc = p % kTilePieces;
    const int n = n0 + half * 64 + pc * (VB / 2);
    const int row = row0 + r;
    const bool ok = row < row_end && n < N;
    const bf16* src = ok ? b + (size_t)row * N + n : b;
    const uint32_t off =
        VB == 16 ? swz(r, pc) : swz(r, pc >> 1) + (pc & 1) * 8;
    cp_async<VB>(dst + half * kTileBytes + off, src, ok ? VB : 0);
  }
}

// The ring both kernels share. load(kc, s, bar) issues K step kc's loads
// into stage s: the cp.async pieces, then one commit; with TMA_B thread 0
// also puts the B boxes on mbarrier `bar`. Step kc waits for
// its stage (its cp.async group, and the mbarrier's phase), makes the
// cp.async writes visible to wgmma (the async proxy), syncs the block so
// that every warpgroup is done with step kc - 1, whose stage the next load
// overwrites, issues the load kStages - 1 steps ahead and runs four k16
// wgmma on the stage. A_MN: A is MN-major (wgrad) rather than K-major (fwd);
// B is MN-major in both. Warpgroup wg reads A tile wg of the stage.
template <bool TMA_B, bool A_MN, typename Load>
__device__ __forceinline__ void mainloop(float (&d)[64], uint32_t base,
                                         int nk, int wg, Load&& load) {
  __shared__ __align__(8) uint64_t full[kStages];
  if (TMA_B && threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s, &full[s]);
    else cp_async_commit();
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;

  for (int kc = 0; kc < nk; ++kc) {
    const int s = kc % kStages;
    cp_async_wait<kStages - 2>();
    if constexpr (TMA_B) mbar_wait(&full[s], (kc / kStages) & 1);
    fence_proxy_async();
    __syncthreads();
    const int next = kc + kStages - 1;
    if (next < nk) load(next, next % kStages, &full[next % kStages]);
    else cp_async_commit();

    const uint32_t sa = base + s * kStageBytes + wg * kTileBytes;
    const uint32_t sb = base + s * kStageBytes + 2 * kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // k16: +16 rows MN-major, +32 B K-major
      const uint64_t da = A_MN ? desc(sa + kk * 2048, kTileBytes, 1024)
                               : desc(sa + kk * 32, 16, 1024);
      wgmma_m64n128k16<A_MN, 1>(d, da, desc(sb + kk * 2048, kTileBytes, 1024));
    }
    wgmma_commit();
    wgmma_wait0(d);
  }
}

// The stage's B: two 64 x 64 boxes of `map` at (n0, row) by TMA on `bar`,
// or load_b_cp_async.
template <bool TMA_B>
__device__ __forceinline__ void load_b(uint32_t sb, const CUtensorMap* map,
                                       uint64_t* bar, const bf16* b, int row,
                                       int row_end, int N, int n0, int tid) {
  if constexpr (TMA_B) {
    if (tid == 0) {
      mbar_expect_tx(bar, 2 * kTileBytes);
      tma_load_2d(sb, map, bar, n0, row);
      tma_load_2d(sb + kTileBytes, map, bar, n0 + 64, row);
    }
  } else {
    load_b_cp_async<8>(sb, b, row, row_end, N, n0, tid);
  }
}

// ------------------------------------------------------------------ fwd --
// grid (ceil(B Ho Wo / 128), ceil(F / 128)), block 256, kSmemBytes dynamic.
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
    const uint32_t st = base + s * kStageBytes;
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
    load_b<TMA_B>(st + 2 * kTileBytes, &w_map, bar, w, tap * C + c0,
               tap * C + min(c0 + 64, C), F, n0, tid);
    cp_async_commit();
  };

  const int wg = tid / 128, t = tid % 128;
  float d[64];
  mainloop<TMA_B, false>(d, base, k * k * cchunks, wg, load);

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
// kSmemBytes dynamic. Warpgroup g of block x owns slice 2 x + g: tap
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
    const uint32_t st = base + s * kStageBytes;
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
    load_b<TMA_B>(st + 2 * kTileBytes, &dy_map, bar, dy, pk, p1, F, n0, tid);
    cp_async_commit();
  };

  const int wg = tid / 128, t = tid % 128;
  float d[64];
  mainloop<TMA_B, true>(d, base, (p1 - p0 + 63) / 64, wg, load);

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

// ------------------------------------------------------------------ host --
// cuTensorMapEncodeTiled, reached through the runtime so that the library
// links against libcudart only.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a row-major (rows, cols) bf16 matrix in 64 x 64 boxes, 128-byte
// swizzled, zeros outside. False if TMA cannot take it (cols % 8 != 0 or a
// pointer off 16 bytes): the kernel then loads B with cp.async.
bool b_map(CUtensorMap* map, const void* ptr, int rows, int cols,
           cudaError_t* err) {
  *err = cudaSuccess;
  if (cols % 8 || reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) {
    *err = cudaErrorNotSupported;
    return false;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) *err = cudaErrorInvalidValue;
  return r == CUDA_SUCCESS;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemBytes);
}

template <int VA, bool TMA_B>
cudaError_t fwd(const void* x, const void* w, const void* bias, void* y,
                const CUtensorMap& map, int B, int H, int W, int C, int F,
                int k, int stride, int pad, cudaStream_t stream) {
  const auto kernel = conv_fwd_wgmma_kernel<VA, TMA_B>;
  cudaError_t err = allow_smem(kernel);
  if (err != cudaSuccess) return err;
  const int Ho = (H + 2 * pad - k) / stride + 1;
  const int Wo = (W + 2 * pad - k) / stride + 1;
  const long long M = (long long)B * Ho * Wo;
  const dim3 grid((unsigned)((M + 127) / 128), (F + 127) / 128);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
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
  cudaError_t err = allow_smem(kernel);
  if (err != cudaSuccess) return err;
  const int Ho = (H + 2 * pad - k) / stride + 1;
  const int Wo = (W + 2 * pad - k) / stride + 1;
  const int nslices = k * k * ((C + 63) / 64);
  const dim3 grid((nslices + 1) / 2, (F + 127) / 128, chunks);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), part, map, B,
      H, W, C, F, Ho, Wo, k, stride, pad, per_chunk);
  return cudaGetLastError();
}

// launch(VA, TMA_B) as std::integral_constant values: the A pieces VA = 16
// bytes when C % 8 == 0, else 8; B by TMA when its map was built, else by
// cp.async.
template <typename Launch>
cudaError_t dispatch(int C, bool tma, Launch&& launch) {
  auto with_a = [&](auto va) -> cudaError_t {
    return tma ? launch(va, std::true_type{}) : launch(va, std::false_type{});
  };
  return C % 8 == 0 ? with_a(std::integral_constant<int, 16>{})
                    : with_a(std::integral_constant<int, 8>{});
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
