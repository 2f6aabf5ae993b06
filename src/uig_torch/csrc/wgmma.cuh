// The tensor-core ring of the bf16 conv kernels: csrc/conv3s2_tc.cu (K4s's
// forward, input gradient and weight gradient) and csrc/conv3_in_tc.cu
// (K3's 3x3 conv). PTX glue for cp.async, mbarriers, TMA and wgmma, the
// 128-byte-swizzled tile layout, the loader of the B operand, and the
// mainloop that every one of those kernels runs; host helpers for the TMA
// map and the launch variants. csrc/tf32_wgmma.cuh builds the fp32
// kernels' ring (K3's conv, K4s's dgrad) on the PTX glue and host helpers.
//
// Layout: every shared tile is 64 rows of 128 bytes (64 bf16) in 1024-byte
// atoms of 8 rows, 16-byte piece j of row r at piece j ^ (r % 8), as TMA's
// CU_TENSOR_MAP_SWIZZLE_128B writes it. A stage holds A's two tiles (64
// rows each, one per consumer warpgroup) and B's BN / 64 tiles (BN = 128,
// or 64 where the N side is at most 64 wide: a 128-wide tile would waste
// half its products).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dtype.cuh"

namespace {

constexpr int kStages = 3;
constexpr int kThreads = 256;         // two consumer warpgroups
constexpr int kTileBytes = 64 * 128;  // 64 rows of 128 bytes

// A: 2 tiles, B: BN / 64 tiles; the ring, + 1024 for the alignment
template <int BN>
constexpr int kStageBytes = (2 + BN / 64) * kTileBytes;
template <int BN>
constexpr int kSmemBytes = kStages * kStageBytes<BN> + 1024;

// ------------------------------------------------------------- PTX glue --
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte piece `piece` of row `row` in a 128B-swizzled tile.
__device__ __forceinline__ uint32_t swz(int row, int piece) {
  return row * 128 + ((piece ^ (row & 7)) << 4);
}

// Reflect padding's source index of i on an axis of n (PyTorch's
// ReflectionPad2d: no edge repeat), for -n < i < 2 n - 1.
__device__ __forceinline__ int mirror(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// VEC-byte copy global -> shared, VEC 16, 8 or 4; src_bytes < VEC fills the
// rest with zeros (0: no read at all).
template <int VEC>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int src_bytes) {
  static_assert(VEC == 16 || VEC == 8 || VEC == 4, "cp.async: 16, 8 or 4");
  if constexpr (VEC == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else if constexpr (VEC == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
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
template <int N>
__device__ __forceinline__ void wgmma_wait0(float (&d)[N]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
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
// d (32 fp32 a thread) += A (64 x 16) * B (16 x 64).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, %34, %35;\n"
      "}\n"
      : UIG_R8(0), UIG_R8(8), UIG_R8(16), UIG_R8(24)
      : "l"(da), "l"(db), "n"(TA), "n"(TB), "r"(1));
}
#undef UIG_R8

template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma_k16(float (&d)[BN / 2], uint64_t da,
                                          uint64_t db) {
  static_assert(BN == 128 || BN == 64, "wgmma N width: 128 or 64");
  if constexpr (BN == 128)
    wgmma_m64n128k16<TA, TB>(d, da, db);
  else
    wgmma_m64n64k16<TA, TB>(d, da, db);
}

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
// `row0` and BN columns from n0, into BN / 64 tiles of 64 x 64, N-major
// (columns n0 .. n0 + 63, then n0 + 64 .. n0 + 127). Rows at or past
// `row_end` and columns at or past N are zero. cp.async in VB-byte pieces:
// 8 (N % 4 == 0) where TMA cannot take the rows (N % 8 != 0);
// tools/k4s_b_loader_ab.py times 16 against TMA.
template <int VB, int BN>
__device__ __forceinline__ void load_b_cp_async(uint32_t dst, const bf16* b,
                                                int row0, int row_end, int N,
                                                int n0, int tid) {
  constexpr int kTiles = BN / 64;
  constexpr int kTilePieces = 128 / VB;  // pieces of a tile's 128-byte row
#pragma unroll
  for (int q = 0; q < 64 * kTiles * kTilePieces / kThreads; ++q) {
    const int idx = tid + q * kThreads;  // (row, piece of the tiles)
    const int r = idx / (kTiles * kTilePieces);
    const int p = idx % (kTiles * kTilePieces);
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

// The stage's B: BN / 64 boxes of 64 x 64 of `map` at (n0, row) by TMA on
// `bar`, or load_b_cp_async.
template <int BN, bool TMA_B>
__device__ __forceinline__ void load_b(uint32_t sb, const CUtensorMap* map,
                                       uint64_t* bar, const bf16* b, int row,
                                       int row_end, int N, int n0, int tid) {
  if constexpr (TMA_B) {
    if (tid == 0) {
      mbar_expect_tx(bar, BN / 64 * kTileBytes);
      tma_load_2d(sb, map, bar, n0, row);
      if constexpr (BN == 128)
        tma_load_2d(sb + kTileBytes, map, bar, n0 + 64, row);
    }
  } else {
    load_b_cp_async<8, BN>(sb, b, row, row_end, N, n0, tid);
  }
}

// The ring every kernel runs. load(kc, s, bar) issues K step kc's loads
// into stage s: the cp.async pieces, then one commit; with TMA_B thread 0
// also puts the B boxes on mbarrier `bar`. Step kc waits for its stage (its
// cp.async group, and the mbarrier's phase), makes the cp.async writes
// visible to wgmma (the async proxy), syncs the block so that every
// warpgroup is done with step kc - 1, whose stage the next load
// overwrites, issues the load kStages - 1 steps ahead and runs four k16
// wgmma on the stage. The prologue loads only the stages that exist (nk
// may be as short as 1, or 0: d stays zero) and commits empty groups for
// the rest, so a short K costs no loads past its end. A_MN: A is MN-major
// (wgrad) rather than K-major; B is MN-major in every kernel. Warpgroup wg
// reads A tile wg of the stage.
template <int BN, bool TMA_B, bool A_MN, typename Load>
__device__ __forceinline__ void mainloop(float (&d)[BN / 2], uint32_t base,
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
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;

  for (int kc = 0; kc < nk; ++kc) {
    const int s = kc % kStages;
    cp_async_wait<kStages - 2>();
    if constexpr (TMA_B) mbar_wait(&full[s], (kc / kStages) & 1);
    fence_proxy_async();
    __syncthreads();
    const int next = kc + kStages - 1;
    if (next < nk) load(next, next % kStages, &full[next % kStages]);
    else cp_async_commit();

    const uint32_t sa = base + s * kStageBytes<BN> + wg * kTileBytes;
    const uint32_t sb = base + s * kStageBytes<BN> + 2 * kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // k16: +16 rows MN-major, +32 B K-major
      const uint64_t da = A_MN ? desc(sa + kk * 2048, kTileBytes, 1024)
                               : desc(sa + kk * 32, 16, 1024);
      wgmma_k16<BN, A_MN, 1>(d, da, desc(sb + kk * 2048, kTileBytes, 1024));
    }
    wgmma_commit();
    wgmma_wait0(d);
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

inline EncodeTiled encode_tiled() {
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
inline bool b_map(CUtensorMap* map, const void* ptr, int rows, int cols,
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

// Let `kernel` take the ring of a BN-wide B as dynamic shared memory.
template <int BN, typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemBytes<BN>);
}

// launch(VA, TMA_B) as std::integral_constant values: the A pieces VA = 16
// bytes when A's channel count `ca` is a multiple of 8, else 8; B by TMA
// when its map was built, else by cp.async.
template <typename Launch>
cudaError_t dispatch(int ca, bool tma, Launch&& launch) {
  auto with_a = [&](auto va) -> cudaError_t {
    return tma ? launch(va, std::true_type{}) : launch(va, std::false_type{});
  };
  return ca % 8 == 0 ? with_a(std::integral_constant<int, 16>{})
                     : with_a(std::integral_constant<int, 8>{});
}

}  // namespace
