// Instance norm forward over NHWC fp32 or bf16: the C entry point of the
// kernel in instance_norm_fwd.cu (design, numerics and bound there).
//
// Replaces: src/uig/kernels/norm_pallas.py, _fwd_impl -> _in_fwd_kernel.
#include <cuda_runtime.h>

cudaError_t uig_in_fwd(const void* x, const float* gamma, const float* beta,
                       void* y, float* ss, float* part, int* sync, int B,
                       int HW, int C, int chunks, int rows, int group,
                       int reducers, int resident, int ring, int lanes,
                       int stage_rows, int fin_lanes, int vec, int grid,
                       float eps, int relu, int is_bf16,
                       cudaStream_t stream);

// x, y: (B, HW, C) fp32, or bf16 when is_bf16, 16-byte aligned; any C >= 1.
// gamma, beta: (C,) fp32. ss: (4, B, C) fp32, written: scale and shift,
// then the statistics mean and 1/sqrt(var + eps) that the backward takes.
// part: fp32 scratch, the chunk partials (2, B, chunks, C). sync: 1 + 2 B
// int32, zero on entry and on return (the exit count, a count of moment
// tasks and a ready flag an image); launches on one sync buffer must be
// stream-ordered. The plan (kernels/norm.py fwd_plan): chunks * rows >= HW
// pixels an image in chunks of rows, images in groups of `group`,
// `reducers` blocks that finalize images, `resident` runs kept in the ring
// from moments to apply (else staged twice, one group apart), `lanes`
// pixel lanes a task,
// `ring` stages of `stage_rows` pixels (vec: C * sizeof(T) % 16 == 0,
// 16-byte columns), fin_lanes finalize threads a piece of channels, `grid`
// blocks, resident at once (a cooperative launch, refused if they do not
// fit: cudaErrorCooperativeLaunchTooLarge).
// Returns cudaErrorInvalidValue for a plan the kernel does not take.
extern "C" cudaError_t uig_instance_norm_fwd(
    const void* x, const float* gamma, const float* beta, void* y, float* ss,
    float* part, int* sync, int B, int HW, int C, int chunks, int rows,
    int group, int reducers, int resident, int ring, int lanes,
    int stage_rows, int fin_lanes, int vec, int grid, float eps, int relu,
    int is_bf16, cudaStream_t stream) {
  return uig_in_fwd(x, gamma, beta, y, ss, part, sync, B, HW, C, chunks, rows,
                    group, reducers, resident, ring, lanes, stage_rows,
                    fin_lanes, vec, grid, eps, relu, is_bf16, stream);
}

extern "C" const char* uig_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
