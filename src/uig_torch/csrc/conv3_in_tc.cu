// K3 in bf16 on Hopper's tensor cores: the fused 3x3 stride-1 pad-1 conv
// (reflect or zeros) + bias + instance norm (+ReLU) over NHWC bf16, for the
// generator's residual trunk (18 conv + IN pairs an apply, (B, 64, 64, 256)
// -> 256 in cyclegan256_dp). csrc/conv3_in.cu's entry point launches this
// one for bf16 and csrc/conv3_in_tf32.cu's for fp32.
//   x (B, H, W, C), w (3, 3, C, F) as a (9C, F) matrix, bias (F,) fp32
//   -> y_conv = bf16(conv + bias), y = IN(y_conv) (+ReLU), both (B, H, W, F)
//
// Replaces: src/uig/kernels/convin_pallas.py, _convin_fwd_impl ->
// _convin_kernel: the conv accumulates in fp32, acc + bias is rounded once
// to bf16 for y_conv, and the fp32 channel moments come from those rounded
// values, as there.
//
// Bound on this card (H100 SXM data sheet, 700 W): at (16, 64, 64, 256) ->
// 256 the conv is 2 * 16 * 64^2 * 256 * 9 * 256 = 7.73e10 FLOP, 0.078 ms at
// the 989 TFLOP/s bf16 tensor-core rate; its bytes (x, the weight, y_conv
// written and read back, y) are ~134 MB, 0.040 ms at 3.35 TB/s: operations
// bound it. On fp32 FMAs the same FLOPs take 1.15 ms, so the conv issues
// wgmma (bf16 products, exact in fp32, fp32 accumulators in registers).
//
// Design: the implicit GEMM of csrc/conv3s2_tc.cu's forward on the ring of
// csrc/wgmma.cuh (two consumer warpgroups, wgmma m64n128k16, a 3-stage
// ring of 128B-swizzled tiles, 36 K steps at C = 256), with two changes:
//   - M tiles are per image (grid (tiles, F / 128, B), 128 pixels of one
//     image a block), so that a tile's moments belong to one image and the
//     partials keep the (2, B, tiles, F) layout of in_common.cuh;
//   - the A gather (a 128-byte row is one output pixel's 64 channels at one
//     tap, cp.async into the swizzle, 8-byte pieces where C % 8 == 4)
//     mirrors the index for reflect padding before the copy; zero fill
//     only for masked rows, padding in zeros mode and the channels missing
//     from a ragged last chunk. B is the (9C, F) weight by TMA where
//     F % 8 == 0, else by cp.async.
// Epilogue (csrc/conv3_in_epilogue.cuh, shared with the fp32 kernel): acc +
// bias in fp32, one __float2bfloat16_rn, masked store of y_conv; then
// per-column sums of the rounded v and v^2 in a fixed order into the
// partials. No atomics: repeats are bit-equal. in_common.cuh's
// in_finalize_apply then reduces the partials in tile order and normalizes
// y_conv into y.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3_in_epilogue.cuh"
#include "dtype.cuh"
#include "in_common.cuh"
#include "wgmma.cuh"

namespace {

// grid (ceil(H W / 128), ceil(F / 128), B), block 256, kSmemBytes<128>
// dynamic. Stage layout: A rows 0..127 (2 tiles: one per warpgroup), then
// B's two N-major tiles; after the mainloop the ring's memory holds the
// warps' column sums.
template <int VA, bool TMA_B>
__global__ void __launch_bounds__(kThreads, 2)
    conv3_in_wgmma_kernel(const bf16* __restrict__ x,
                          const bf16* __restrict__ w,
                          const float* __restrict__ bias,
                          bf16* __restrict__ y, float* __restrict__ part,
                          const __grid_constant__ CUtensorMap w_map, int B,
                          int H, int W, int C, int F, int reflect) {
  constexpr int kPieces = 128 / VA;  // pieces of a 128-byte row
  constexpr int kRowsPerPass = kThreads / kPieces;
  constexpr int kPasses = 128 / kRowsPerPass;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int HW = H * W;
  const int m0 = blockIdx.x * 128;
  const int n0 = blockIdx.y * 128;
  const int cchunks = (C + 63) / 64;
  const bf16* xb = x + (size_t)b * HW * C;

  // the thread's A rows: output pixel (y, x) of image b
  const int piece = tid % kPieces;
  const int ce = piece * (VA / 2);  // first channel of the piece in a chunk
  int a_y[kPasses], a_x[kPasses];
  bool a_ok[kPasses];
#pragma unroll
  for (int q = 0; q < kPasses; ++q) {
    const int m = m0 + tid / kPieces + q * kRowsPerPass;
    a_ok[q] = m < HW;
    const int mm = a_ok[q] ? m : 0;
    a_y[q] = mm / W;
    a_x[q] = mm - a_y[q] * W;
  }

  auto load = [&](int kc, int s, uint64_t* bar) {
    const int tap = kc / cchunks;
    const int c0 = (kc - tap * cchunks) * 64;
    const int di = tap / 3, dj = tap - di * 3;
    const uint32_t st = base + s * kStageBytes<128>;
    const int c = c0 + ce;
#pragma unroll
    for (int q = 0; q < kPasses; ++q) {
      const int row = tid / kPieces + q * kRowsPerPass;
      int sy = a_y[q] + di - 1, sx = a_x[q] + dj - 1;
      bool ok = a_ok[q] && c < C;
      if (reflect) {
        sy = mirror(sy, H);
        sx = mirror(sx, W);
      } else {
        ok = ok && sy >= 0 && sy < H && sx >= 0 && sx < W;
      }
      const bf16* src = ok ? xb + ((size_t)sy * W + sx) * C + c : x;
      const uint32_t off = VA == 16 ? swz(row, piece)
                                    : swz(row, piece >> 1) + (piece & 1) * 8;
      cp_async<VA>(st + off, src, ok ? VA : 0);
    }
    load_b<128, TMA_B>(st + 2 * kTileBytes, &w_map, bar, w, tap * C + c0,
                       tap * C + min(c0 + 64, C), F, n0, tid);
    cp_async_commit();
  };

  const int wg = tid / 128;
  float d[64];
  mainloop<128, TMA_B, false>(d, base, 9 * cchunks, wg, load);
  conv3_in_epilogue<bf16>(d, bias, y, part, smem_raw, B, HW, F, b, m0, n0);
}

template <int VA, bool TMA_B>
cudaError_t conv(const void* x, const void* w, const float* bias, void* yconv,
                 float* part, const CUtensorMap& map, int B, int H, int W,
                 int C, int F, int reflect, int tiles, cudaStream_t stream) {
  const auto kernel = conv3_in_wgmma_kernel<VA, TMA_B>;
  cudaError_t err = allow_smem<128>(kernel);
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles, (F + 127) / 128, B);
  kernel<<<grid, kThreads, kSmemBytes<128>, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), bias,
      static_cast<bf16*>(yconv), part, map, B, H, W, C, F, reflect);
  return cudaGetLastError();
}

}  // namespace

// bf16 forward, called by uig_conv3_in_fwd (csrc/conv3_in.cu) with the
// shapes it documents: the conv into yconv and the partials, then the
// moments' finalize and the normalize + affine (+ReLU) pass into y.
cudaError_t conv3_in_fwd_bf16_wgmma(const void* x, const void* w,
                                    const float* bias, const float* gamma,
                                    const float* beta, void* yconv, void* y,
                                    float* part, float* ss, int B, int H,
                                    int W, int C, int F, int reflect,
                                    int relu, float eps,
                                    cudaStream_t stream) {
  const int HW = H * W;
  const int tiles = (HW + 127) / 128;
  CUtensorMap map = {};
  cudaError_t err;
  const bool tma = b_map(&map, w, 9 * C, F, &err);
  if (err != cudaSuccess) return err;
  err = dispatch(C, tma, [&](auto va, auto tma_b) {
    return conv<decltype(va)::value, decltype(tma_b)::value>(
        x, w, bias, yconv, part, map, B, H, W, C, F, reflect, tiles, stream);
  });
  if (err != cudaSuccess) return err;
  return in_finalize_apply<bf16>(part, gamma, beta, ss,
                                 static_cast<const bf16*>(yconv),
                                 static_cast<bf16*>(y), B, HW, F, tiles, eps,
                                 relu, stream);
}
