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
// stages at C = 256), on a 4-stage ring (48 KB a stage, one block an SM):
// tf32_ring of csrc/tf32_wgmma.cuh, which the K4s fp32 input gradient runs
// too.
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
#include "tf32_wgmma.cuh"

namespace {

constexpr int kTfStages = 4;
constexpr int kTfSmem = kTfSmemBytes<128, kTfStages>;
#ifndef UIG_K3_DEPTH
#define UIG_K3_DEPTH 2
#endif
constexpr int kDepth = UIG_K3_DEPTH;  // K stages a partial sum

// wt: (2, F, 9 Cp), hi and lo of W^T from w (9C, F) (wt_split_tile).
__global__ void conv3_wt_split_kernel(const float* __restrict__ w,
                                      float* __restrict__ wt, int C, int F,
                                      int Cp) {
  wt_split_tile(w, wt, 9, C, F, Cp);
}

// grid (ceil(H W / 128), ceil(F / 128), B), block 256, kTfSmem dynamic.
// The ring of tf32_wgmma.cuh (A rows 64 wg .. 64 wg + 63 for warpgroup wg,
// B's hi and lo planes 128 rows of F each); after it the ring's memory
// holds the warps' column sums.
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

  auto load = [&](int kc, int s, uint64_t* bar) {
    const int tap = kc / cchunks;
    const int c0 = (kc - tap * cchunks) * 32;
    const int di = tap / 3, dj = tap - di * 3;
    const uint32_t st = base + s * kTfStageBytes<128>;
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
      mbar_expect_tx(bar, 2 * kTfTile);
      const int k = tap * cchunks * 32 + c0;
      tma_load_2d(st + kTfTile, &hi_map, bar, k, n0);
      tma_load_2d(st + 2 * kTfTile, &lo_map, bar, k, n0);
    }
    cp_async_commit();
  };

  float sum[64];
  tf32_ring<128, kTfStages, kDepth>(sum, base, sbase, nk, load);

  conv3_in_epilogue<float>(sum, bias, y, part, smem_raw, B, HW, F, b, m0, n0);
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
  if ((err = plane_map(&hi_map, wt, F, 9 * cp, 128)) != cudaSuccess) return err;
  if ((err = plane_map(&lo_map, wt + (size_t)F * 9 * cp, F, 9 * cp, 128)) !=
      cudaSuccess)
    return err;
  err = cudaFuncSetAttribute(conv3_in_tf32_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kTfSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles, (F + 127) / 128, B);
  conv3_in_tf32_wgmma_kernel<<<grid, kThreads, kTfSmem, stream>>>(
      x, bias, yconv, part, hi_map, lo_map, B, H, W, C, F, reflect);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return in_finalize_apply<float>(part, gamma, beta, ss, yconv, y, B, HW, F,
                                  tiles, eps, relu, stream);
}
