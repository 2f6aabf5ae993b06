// The fp32 kernels on wgmma in the three-term TF32 split (csrc/tf32.cuh):
// csrc/conv3_in_tf32.cu (K3's fp32 conv), csrc/conv3s2_tf32.cu (K4s's
// fp32 forward, input and weight gradients), csrc/conv7_bwd_tf32.cu and
// csrc/conv7_wgrad_tf32.cu (K4d's and K4w's fp32 gradients of the 7x7
// head). The tf32 wgmma with A from registers, the order of a 32-element K
// chunk that matches the A fragments, the split of an HWIO weight into
// W^T's K-major planes, the TMA map of a hi or lo plane, and the ring that
// K3, the K4s forward and the K4s input gradient run.
//
// Numerics, in every kernel that includes this: each product a b is summed
// as lo_a hi_b + hi_a lo_b + hi_a hi_b (fp32 accumulators), in that order
// for every k8 step. The tensor core's accumulator takes a partial sum over
// a fixed number of K stages, started fresh (scale-d = 0); each partial is
// then added to an fp32 register sum with a rounded fp32 add, in K order.
// Plain single-pass TF32 is not used.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32.cuh"
#include "wgmma.cuh"

namespace {

constexpr uint32_t kTf32Mask = 0xffffe000u;
constexpr int kTfTile = 128 * 128;  // A: 128 rows of 128 bytes (32 fp32)

// A stage of tf32_ring: the A tile, then B's hi and lo planes, BN rows of
// 128 bytes each; the ring, + 1024 for the alignment.
template <int BN>
constexpr int kTfStageBytes = kTfTile + 2 * BN * 128;
template <int BN, int STAGES>
constexpr int kTfSmemBytes = STAGES * kTfStageBytes<BN> + 1024;

// The channel (of its 32-channel chunk) at position p of a K-major row:
// k8 step p / 8 takes, at fragment column t and t + 4, channels 8t + 2s
// and 8t + 2s + 1 (s = p / 8), the ones thread t holds as v[2s], v[2s + 1].
__device__ __forceinline__ int chunk_channel(int p) {
  return 8 * (p & 3) + 2 * (p >> 3) + ((p >> 2) & 1);
}

// x's hi and lo as the products take them (lo rounded to TF32 by its mask).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  split(x, hi, lo);
  lo &= kTf32Mask;
}

#define UIG_R8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define UIG_R4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])

// d (N / 2 fp32 a thread) = A (64 x 8, tf32 from registers) * B (8 x N,
// K-major tf32 in shared memory) + (scale_d ? d : 0), N = 128 or 64 (the
// rings), or 24, 40, 56, 72 (a warpgroup's third of K4w's 49 Cout taps,
// Cout 1..4). The A fragment: warp w of the warpgroup, lane (g = lane / 4,
// t = lane % 4): a[0] at row 16 w + g, column t; a[1] row + 8; a[2], a[3]
// the same at column t + 4. d's layout is wgmma.cuh's acc_row / acc_col.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  static_assert(N == 128 || N == 72 || N == 64 || N == 56 || N == 40 ||
                    N == 24,
                "wgmma N width: 128, 72, 64, 56, 40 or 24");
  if constexpr (N == 128)
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, "
        "%67}, %68, p, 1, 1;\n"
        "}\n"
        : UIG_R8(0), UIG_R8(8), UIG_R8(16), UIG_R8(24), UIG_R8(32),
          UIG_R8(40), UIG_R8(48), UIG_R8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  else if constexpr (N == 64)
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
        "}\n"
        : UIG_R8(0), UIG_R8(8), UIG_R8(16), UIG_R8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  else if constexpr (N == 72)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 {%0, %1, %2, "
        "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35}, {%36, %37, %38, %39}, %40, p, 1, "
        "1;\n"
        "}\n"
        : UIG_R4(0), UIG_R4(4), UIG_R4(8), UIG_R4(12), UIG_R4(16),
          UIG_R4(20), UIG_R4(24), UIG_R4(28), UIG_R4(32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  else if constexpr (N == 56)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 {%0, %1, %2, "
        "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27}, {%28, "
        "%29, %30, %31}, %32, p, 1, 1;\n"
        "}\n"
        : UIG_R4(0), UIG_R4(4), UIG_R4(8), UIG_R4(12), UIG_R4(16),
          UIG_R4(20), UIG_R4(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  else if constexpr (N == 40)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 {%0, %1, %2, "
        "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
        "%17, %18, %19}, {%20, %21, %22, %23}, %24, p, 1, 1;\n"
        "}\n"
        : UIG_R4(0), UIG_R4(4), UIG_R4(8), UIG_R4(12), UIG_R4(16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  else if constexpr (N == 24)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 {%0, %1, %2, "
        "%3, %4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, "
        "%16, p, 1, 1;\n"
        "}\n"
        : UIG_R4(0), UIG_R4(4), UIG_R4(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
}
#undef UIG_R8
#undef UIG_R4

// One stage's 12 products: the k8 steps of a 32-element K row, each as
// lo_a hi_b, hi_a lo_b, hi_a hi_b; sb: B's hi plane, its lo plane
// lo_off bytes further (K-major, 128B swizzle, +32 bytes a k8 step).
template <int N>
__device__ __forceinline__ void tf32x3_stage(float (&acc)[N / 2],
                                             const uint32_t (&ah)[4][4],
                                             const uint32_t (&al)[4][4],
                                             uint32_t sb, uint32_t lo_off,
                                             bool fresh) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t bh = desc(sb + kk * 32, 16, 1024);
    const uint64_t bl = desc(sb + lo_off + kk * 32, 16, 1024);
    wgmma_tf32<N>(acc, al[kk], bh, !(fresh && kk == 0));
    wgmma_tf32<N>(acc, ah[kk], bl, 1);
    wgmma_tf32<N>(acc, ah[kk], bh, 1);
  }
}

// Keep the fragments live until the products that read them are done.
__device__ __forceinline__ void pin(uint32_t (&ah)[4][4],
                                    uint32_t (&al)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      asm volatile("" : "+r"(ah[kk][i]), "+r"(al[kk][i])::"memory");
}

// The same for one k8 step's fragment.
__device__ __forceinline__ void pin4(uint32_t (&ah)[4], uint32_t (&al)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    asm volatile("" : "+r"(ah[i]), "+r"(al[i])::"memory");
}

// Keep accumulators out of reach of other instructions: while products are
// in flight they own them; after a wait, no read may move above it.
template <int N>
__device__ __forceinline__ void pin_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The ring of K3's fp32 conv and the K4s fp32 forward and input gradient:
// sum (BN / 2
// fp32 a thread, wgmma.cuh's accumulator layout) = A (128 rows, 64 a
// warpgroup) x B (BN columns) over nk K stages of 32 elements. Stage layout
// (kTfStageBytes<BN>, from `base`, 1024-aligned): A rows 0..127, 128 bytes
// each in the 128B swizzle, then B's hi and lo planes, BN K-major rows each.
// load(kc, s, bar) issues stage kc's loads into slot s: A by cp.async (one
// commit), B by TMA on mbarrier `bar` (thread 0). A is split in registers:
// each thread loads its fragments with two 16-byte shared loads a row,
// splits them and issues wgmma with A from registers, so no second shared
// tile is written. Step kc issues its 12 products, then, while they run,
// waits for stage kc + 1, refills the slot that step kc - 1 read (every
// warpgroup passed its wait before this step's barrier) and splits stage
// kc + 1's fragments; then it waits for its products. DEPTH stages a
// partial in the tensor core's accumulator, each added to `sum` with a
// rounded fp32 add. nk >= 1.
template <int BN, int STAGES, int DEPTH, typename Load>
__device__ __forceinline__ void tf32_ring(float (&sum)[BN / 2],
                                         uint32_t base, const uint8_t* sbase,
                                         int nk, Load&& load) {
  static_assert(STAGES >= 3, "the ring refills the slot two steps back");
  __shared__ __align__(8) uint64_t full[STAGES];
  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s, &full[s]);
    else cp_async_commit();
  }

  const int wg = tid >> 7, t = tid & 127;
  const int lane = tid & 31;
  // the thread's fragment rows (of the stage's 128) and 16-byte pieces
  const int frow = 64 * wg + 16 * ((t >> 5) & 3) + (lane >> 2);
  const int fpiece = 2 * (lane & 3);
  // stage s's fragments: elements 8t .. 8t + 7 of rows frow and frow + 8,
  // split
  auto frags = [&](int s, uint32_t (&ah)[4][4], uint32_t (&al)[4][4]) {
    const uint8_t* sa = sbase + s * kTfStageBytes<BN>;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = frow + 8 * h;
      const float4 u = *reinterpret_cast<const float4*>(sa + swz(r, fpiece));
      const float4 v =
          *reinterpret_cast<const float4*>(sa + swz(r, fpiece + 1));
      const float e[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        split_tf32(e[2 * kk], ah[kk][h], al[kk][h]);
        split_tf32(e[2 * kk + 1], ah[kk][2 + h], al[kk][2 + h]);
      }
    }
  };
  // wait until stage kc's loads (A by every thread, B by TMA) have landed
  auto arrive = [&](int kc) {
    mbar_wait(&full[kc % STAGES], (kc / STAGES) & 1);
    __syncthreads();
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sum[i] = acc[i] = 0.f;
  uint32_t ah[4][4], al[4][4], nh[4][4], nl[4][4];
  cp_async_wait<STAGES - 2>();
  arrive(0);
  frags(0, ah, al);

  for (int kc = 0; kc < nk; ++kc) {
    const uint32_t sb = base + (kc % STAGES) * kTfStageBytes<BN> + kTfTile;
    wgmma_fence();
    tf32x3_stage<BN>(acc, ah, al, sb, BN * 128, kc % DEPTH == 0);
    wgmma_commit();
    if (kc + 1 < nk) {
      cp_async_wait<STAGES - 3>();
      arrive(kc + 1);
      const int next = kc + STAGES - 1;
      if (next < nk) load(next, next % STAGES, &full[next % STAGES]);
      else cp_async_commit();
      frags((kc + 1) % STAGES, nh, nl);
    }
    wgmma_wait0(acc);
    pin(ah, al);
    if (kc + 1 < nk) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ah[kk][i] = nh[kk][i];
          al[kk][i] = nl[kk][i];
        }
    }
    if (kc % DEPTH == DEPTH - 1 || kc == nk - 1) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sum[i] += acc[i];
    }
  }
}

// W^T's hi and lo planes, K-major, from an HWIO weight read as (taps C, F):
// wt (2, F, taps Cp), Cp = C rounded up to 32, each 32-channel chunk of a
// tap in chunk_channel order, zeros past C. One block of (32, 8) threads
// a 32-channel chunk of one tap x 32 columns (grid (ceil(F / 32), taps Cp
// / 32)), through a shared tile, read along F and written along K.
__device__ __forceinline__ void wt_split_tile(const float* __restrict__ w,
                                              float* __restrict__ wt,
                                              int taps, int C, int F,
                                              int Cp) {
  __shared__ float tile[32][33];
  const int chunks = Cp / 32;
  const int j = blockIdx.y;
  const int tap = j / chunks;
  const int c0 = (j - tap * chunks) * 32;
  const int n0 = blockIdx.x * 32;
  const int tx = threadIdx.x;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i, n = n0 + tx;
    tile[i][tx] = c < C && n < F ? w[((size_t)tap * C + c) * F + n] : 0.f;
  }
  __syncthreads();
  const size_t k = (size_t)taps * Cp;
  const size_t plane = (size_t)F * k;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int n = n0 + i;
    if (n >= F) continue;
    uint32_t hi, lo;
    split_tf32(tile[chunk_channel(tx)][i], hi, lo);
    const size_t o = (size_t)n * k + (size_t)j * 32 + tx;
    wt[o] = __uint_as_float(hi);
    wt[plane + o] = __uint_as_float(lo);
  }
}

// The map of one (rows, cols) fp32 plane in boxes of 32 columns (one
// 128-byte row) x box_rows rows, 128-byte swizzled, zeros outside.
inline cudaError_t plane_map(CUtensorMap* map, const float* ptr, int rows,
                             int cols, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(float)};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
