// K3 in fp32 on Hopper's tensor cores: the fused 3x3 stride-1 pad-1 conv
// (reflect or zeros) + bias + instance norm (+ReLU) over NHWC fp32, in the
// three-term TF32 split (csrc/tf32.cuh), for the generator's residual trunk
// (18 conv + IN pairs an apply, (B, 64, 64, 256) -> 256 in cyclegan256_dp)
// on the fp32 training step and the fp32 serving path.
//   x (B, H, W, C), w (3, 3, C, F) as a (9C, F) matrix, bias (F,) fp32
//   -> y_conv = conv + bias, y = IN(y_conv) (+ReLU), both (B, H, W, F)
// csrc/conv3_in.cu's entry point states the TPU kernel it replaces and the
// bound; this file holds the design.
//
// Numerics. Each product x w is summed as lo_x hi_w + hi_x lo_w + hi_x hi_w
// (wgmma m64n128k8 tf32, fp32 accumulators), in that order for every k8
// step. The tensor core's accumulator takes a partial sum over kDepth K
// stages of 32 channels (64 of one tap by default, UIG_K3_DEPTH), started
// fresh (scale-d = 0); each partial is then added to an fp32 register sum
// with a rounded fp32 add, in K order. Plain single-pass TF32 is not used.
//
// Design: an implicit GEMM, M = 128 output pixels of one image a block
// (grid (ceil(H W / 128), ceil(F / 128), B), two consumer warpgroups of
// 64 x 128), N = 128 output channels, K = 9 taps x C channels in stages of
// one tap's 32 channels: a 128-byte row, the width of the 128B swizzle (72
// stages at C = 256), on a 4-stage ring (48 KB a stage, one block an SM).
//   - A (activations): the gather of csrc/conv3_in_tc.cu, in 16-byte
//     pieces of 4 channels (C % 4 == 0): index mirroring for reflect
//     padding before the cp.async, zero fill for masked rows, for padding
//     in zeros mode and for the channels missing from a ragged last chunk.
//     The split runs in registers: each thread loads its fragments with two
//     16-byte shared loads a row, splits them and issues wgmma with A from
//     registers, so no second shared tile is written; the next stage's
//     fragments are loaded and split while this stage's products run.
//   - B (weights): tf32 wgmma reads only K-major operands, and the HWIO
//     weight read as (9C, F) is N-major, so conv3_wt_split_kernel first
//     writes W^T as two K-major planes, hi and lo, (F, 9 Cp) fp32 each (Cp
//     = C rounded up to 32, zeros past C), in a scratch the wrapper
//     allocates; TMA loads each stage's 128 x 32 boxes into the 128B
//     swizzle (zeros past F). Within each 32-channel chunk the planes hold
//     the channels in the order chunk_channel(p), the order in which
//     thread t's two 16-byte loads (channels 8t .. 8t + 7 of its row) fill
//     the k8 fragments; a product summed over k is unchanged.
//   - Epilogue: the bf16 kernel's (csrc/conv3_in_epilogue.cuh), without its
//     rounding: sum + bias in fp32, y_conv stored in fp32, the column
//     moments in a fixed tree into the (2, B, tiles, F) partials, then
//     in_common.cuh's in_finalize_apply. No atomics: repeats are bit-equal.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3_in_epilogue.cuh"
#include "in_common.cuh"
#include "tf32.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kTfStages = 4;
constexpr int kTfTile = 128 * 128;          // 128 rows of 128 bytes
constexpr int kTfStageBytes = 3 * kTfTile;  // A, B hi, B lo
constexpr int kTfSmemBytes = kTfStages * kTfStageBytes + 1024;
#ifndef UIG_K3_DEPTH
#define UIG_K3_DEPTH 2
#endif
constexpr int kDepth = UIG_K3_DEPTH;  // K stages a partial sum
constexpr uint32_t kTf32Mask = 0xffffe000u;

__device__ __forceinline__ int mirror(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// The channel (of its 32-channel chunk) at position p of a K-major row:
// k8 step p / 8 takes, at fragment column t and t + 4, channels 8t + 2s
// and 8t + 2s + 1 (s = p / 8), the ones thread t holds as v[2s], v[2s + 1].
__device__ __forceinline__ int chunk_channel(int p) {
  return 8 * (p & 3) + 2 * (p >> 3) + ((p >> 2) & 1);
}

// wt: (2, F, 9 Cp), hi and lo of W^T from w (9C, F). grid (ceil(F / 32),
// 9 Cp / 32), block (32, 8): a 32-channel chunk of one tap x 32 columns
// through a shared tile, read along F and written along K.
__global__ void conv3_wt_split_kernel(const float* __restrict__ w,
                                      float* __restrict__ wt, int C, int F,
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
  const size_t k = (size_t)9 * Cp;
  const size_t plane = (size_t)F * k;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int n = n0 + i;
    if (n >= F) continue;
    uint32_t hi, lo;
    split(tile[chunk_channel(tx)][i], hi, lo);
    const size_t o = (size_t)n * k + (size_t)j * 32 + tx;
    wt[o] = __uint_as_float(hi);
    wt[plane + o] = __uint_as_float(lo & kTf32Mask);
  }
}

#define UIG_R8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 fp32 a thread) = A (64 x 8, tf32 from registers) * B (8 x 128,
// K-major tf32 in shared memory) + (scale_d ? d : 0). The A fragment: warp
// w of the warpgroup, lane (g = lane / 4, t = lane % 4): a[0] at row
// 16 w + g, column t; a[1] row + 8; a[2], a[3] the same at column t + 4.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1;\n"
      "}\n"
      : UIG_R8(0), UIG_R8(8), UIG_R8(16), UIG_R8(24), UIG_R8(32), UIG_R8(40),
        UIG_R8(48), UIG_R8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
#undef UIG_R8

// grid (ceil(H W / 128), ceil(F / 128), B), block 256, kTfSmemBytes
// dynamic. Stage layout: A rows 0..127 (rows 64 wg .. 64 wg + 63 for
// warpgroup wg), then B's hi and lo planes, 128 rows of F each; after the
// mainloop the ring's memory holds the warps' column sums.
__global__ void __launch_bounds__(kThreads, 1)
    conv3_in_tf32_wgmma_kernel(const float* __restrict__ x,
                               const float* __restrict__ bias,
                               float* __restrict__ y, float* __restrict__ part,
                               const __grid_constant__ CUtensorMap hi_map,
                               const __grid_constant__ CUtensorMap lo_map,
                               int B, int H, int W, int C, int F,
                               int reflect) {
  constexpr int kPasses = 128 * 8 / kThreads;  // 16-byte pieces a thread
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kTfStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint8_t* sbase = smem_raw + (base - smem_u32(smem_raw));

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int HW = H * W;
  const int m0 = blockIdx.x * 128;
  const int n0 = blockIdx.y * 128;
  const int cchunks = (C + 31) / 32;
  const int nk = 9 * cchunks;
  const float* xb = x + (size_t)b * HW * C;

  // the thread's A rows to gather: output pixel (y, x) of image b
  const int piece = tid & 7;
  int a_y[kPasses], a_x[kPasses];
  bool a_ok[kPasses];
#pragma unroll
  for (int q = 0; q < kPasses; ++q) {
    const int m = m0 + (tid >> 3) + q * (kThreads / 8);
    a_ok[q] = m < HW;
    const int mm = a_ok[q] ? m : 0;
    a_y[q] = mm / W;
    a_x[q] = mm - a_y[q] * W;
  }

  auto load = [&](int kc, int s) {
    const int tap = kc / cchunks;
    const int c0 = (kc - tap * cchunks) * 32;
    const int di = tap / 3, dj = tap - di * 3;
    const uint32_t st = base + s * kTfStageBytes;
    const int c = c0 + piece * 4;
#pragma unroll
    for (int q = 0; q < kPasses; ++q) {
      const int row = (tid >> 3) + q * (kThreads / 8);
      int sy = a_y[q] + di - 1, sx = a_x[q] + dj - 1;
      bool ok = a_ok[q] && c < C;
      if (reflect) {
        sy = mirror(sy, H);
        sx = mirror(sx, W);
      } else {
        ok = ok && sy >= 0 && sy < H && sx >= 0 && sx < W;
      }
      const float* src = ok ? xb + ((size_t)sy * W + sx) * C + c : x;
      cp_async<16>(st + swz(row, piece), src, ok ? 16 : 0);
    }
    if (tid == 0) {
      mbar_expect_tx(&full[s], 2 * kTfTile);
      const int k = tap * cchunks * 32 + c0;
      tma_load_2d(st + kTfTile, &hi_map, &full[s], k, n0);
      tma_load_2d(st + 2 * kTfTile, &lo_map, &full[s], k, n0);
    }
    cp_async_commit();
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kTfStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kTfStages - 1; ++s) {
    if (s < nk) load(s, s);
    else cp_async_commit();
  }

  const int wg = tid >> 7, t = tid & 127;
  const int lane = tid & 31;
  // the thread's fragment rows (of the stage's 128) and 16-byte pieces
  const int frow = 64 * wg + 16 * ((t >> 5) & 3) + (lane >> 2);
  const int fpiece = 2 * (lane & 3);
  // stage s's fragments: channels 8t .. 8t + 7 of rows frow and frow + 8,
  // split
  auto frags = [&](int s, uint32_t (&ah)[4][4], uint32_t (&al)[4][4]) {
    const uint8_t* sa = sbase + s * kTfStageBytes;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = frow + 8 * h;
      const float4 u = *reinterpret_cast<const float4*>(sa + swz(r, fpiece));
      const float4 v =
          *reinterpret_cast<const float4*>(sa + swz(r, fpiece + 1));
      const float e[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        split(e[2 * kk], ah[kk][h], al[kk][h]);
        split(e[2 * kk + 1], ah[kk][2 + h], al[kk][2 + h]);
        al[kk][h] &= kTf32Mask;
        al[kk][2 + h] &= kTf32Mask;
      }
    }
  };
  // wait until stage kc's loads (A by every thread, B by TMA) have landed
  auto arrive = [&](int kc) {
    mbar_wait(&full[kc % kTfStages], (kc / kTfStages) & 1);
    __syncthreads();
  };

  float sum[64], acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) sum[i] = acc[i] = 0.f;
  uint32_t ah[4][4], al[4][4], nh[4][4], nl[4][4];
  cp_async_wait<kTfStages - 2>();
  arrive(0);
  frags(0, ah, al);

  // Step kc issues its 12 products, then, while they run, waits for stage
  // kc + 1, refills the slot that step kc - 1 read (every warpgroup passed
  // its wait before this step's barrier) and splits stage kc + 1's
  // fragments; then it waits for its products.
  for (int kc = 0; kc < nk; ++kc) {
    const int fresh = kc % kDepth == 0;
    const uint32_t sb = base + (kc % kTfStages) * kTfStageBytes + kTfTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // k8: +32 bytes of the K-major rows
      const uint64_t bh = desc(sb + kk * 32, 16, 1024);
      const uint64_t bl = desc(sb + kTfTile + kk * 32, 16, 1024);
      wgmma_tf32(acc, al[kk], bh, !(fresh && kk == 0));
      wgmma_tf32(acc, ah[kk], bl, 1);
      wgmma_tf32(acc, ah[kk], bh, 1);
    }
    wgmma_commit();
    if (kc + 1 < nk) {
      cp_async_wait<kTfStages - 3>();
      arrive(kc + 1);
      const int next = kc + kTfStages - 1;
      if (next < nk) load(next, next % kTfStages);
      else cp_async_commit();
      frags((kc + 1) % kTfStages, nh, nl);
    }
    wgmma_wait0(acc);
    // the fragments stay live until the products that read them are done
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        asm volatile("" : "+r"(ah[kk][i]), "+r"(al[kk][i])::"memory");
    if (kc + 1 < nk) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ah[kk][i] = nh[kk][i];
          al[kk][i] = nl[kk][i];
        }
    }
    if (kc % kDepth == kDepth - 1 || kc == nk - 1) {
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] += acc[i];
    }
  }

  conv3_in_epilogue<float>(sum, bias, y, part, smem_raw, B, HW, F, b, m0, n0);
}

// The map of one (rows, cols) fp32 plane in boxes of 32 columns (one
// 128-byte row) x 128 rows, 128-byte swizzled, zeros outside.
cudaError_t plane_map(CUtensorMap* map, const float* ptr, int rows,
                      int cols) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(float)};
  const cuuint32_t box[2] = {32, 128};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// fp32 forward, called by uig_conv3_in_fwd (csrc/conv3_in.cu) with the
// shapes it documents: W^T's hi/lo planes into wt, the conv into yconv and
// the partials, then the moments' finalize and the normalize + affine
// (+ReLU) pass into y.
cudaError_t conv3_in_fwd_tf32(const float* x, const float* w, float* wt,
                              const float* bias, const float* gamma,
                              const float* beta, float* yconv, float* y,
                              float* part, float* ss, int B, int H, int W,
                              int C, int F, int reflect, int relu, float eps,
                              cudaStream_t stream) {
  const int HW = H * W;
  const int tiles = (HW + 127) / 128;
  const int cp = (C + 31) / 32 * 32;
  conv3_wt_split_kernel<<<dim3((F + 31) / 32, 9 * cp / 32), dim3(32, 8), 0,
                          stream>>>(w, wt, C, F, cp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap hi_map = {}, lo_map = {};
  if ((err = plane_map(&hi_map, wt, F, 9 * cp)) != cudaSuccess) return err;
  if ((err = plane_map(&lo_map, wt + (size_t)F * 9 * cp, F, 9 * cp)) !=
      cudaSuccess)
    return err;
  err = cudaFuncSetAttribute(conv3_in_tf32_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kTfSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles, (F + 127) / 128, B);
  conv3_in_tf32_wgmma_kernel<<<grid, kThreads, kTfSmemBytes, stream>>>(
      x, bias, yconv, part, hi_map, lo_map, B, H, W, C, F, reflect);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return in_finalize_apply<float>(part, gamma, beta, ss, yconv, y, B, HW, F,
                                  tiles, eps, relu, stream);
}
