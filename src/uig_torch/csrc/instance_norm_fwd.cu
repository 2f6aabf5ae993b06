// Instance norm forward over NHWC fp32 or bf16 in one launch: per-(example,
// channel) moments over H*W, normalize, affine, optional fused ReLU.
//
// Replaces: src/uig/kernels/norm_pallas.py, _fwd_impl -> _in_fwd_kernel (the
// TPU kernel keeps one example's whole plane resident in VMEM and reads it
// once; in bf16 it takes fp32 moments of the bf16 values and rounds y once).
// instance_norm.cu holds the C entry point.
//
// Numerics, as the JAX InstanceNorm: fp32 one-pass moments E[x] and E[x^2]
// of the stored values, var = max(E[x^2] - E[x]^2, 0), r = 1/sqrt(var +
// eps), scale = r gamma, shift = beta - mean scale, y = x scale + shift
// (+ReLU), rounded once to T. ss (4, B, C) fp32 keeps scale, shift, mean
// and r; the backward (instance_norm_bwd.cu) takes mean and r.
//
// Bound on this card: bytes. x is read once and y written once: at (16,
// 256, 256, 64) fp32 that is 2 x 268 MB, 0.160 ms at the H100 SXM
// data-sheet 3.35 TB/s (700 W); half that in bf16.
//
// Design: the TPU kernel's VMEM residency, spread over the SMs' shared
// memory. One block an SM, resident at once (a cooperative launch):
// `reducers` blocks finalize images; every other block (a task block) is
// one producer warp, 8 consumer warps and one partial warp. Images go in
// groups (as many as the task blocks take); each image in `chunks` runs of
// `rows` pixels, one contiguous byte range of NHWC each; task block j takes
// run j (and j + blocks, ...) of each group's runs, in group order.
//   The producer stages the block's runs into a ring of 12 stages of 16 KB
//   with 1-D bulk copies (cp.async.bulk, a full and an empty mbarrier a
//   stage). The consumers sum each staged run: thread (lane l, column j)
//   adds 16-byte channel vector j of the run's pixels l, l + lanes, ... in
//   fp32 (C * sizeof(T) % 16 == 0, at most 256 columns: "vec"), and hand
//   their lane sums to the partial warp, which adds them in lane order into
//   the run's (2, C) partial slot and counts the image's runs done (a
//   red.release). A reducer block waits for an image's count, sums its
//   chunk partials (fin_lanes threads a piece of 4 channels, or 1 where
//   C % 4 != 0; lane f takes a contiguous run of chunks in chunk order,
//   then the lanes in order), writes ss and raises the image's flag (a
//   st.release).
//   Resident (a group's runs fit the task blocks, and a run 9 stages): the
//   run stays in the ring from its moments to its apply, so x is read from
//   device memory once. While its statistics are finalized the consumers
//   sum the next group's first stages as they arrive (mbarrier test_wait),
//   then normalize the run from shared memory and store y with 16-byte
//   streaming stores, freeing its stages. Otherwise every run is staged
//   twice, a group apart: the moments of group g + 1 before the apply of g.
//   C that no 16-byte column fits ("scalar"): the consumers read x
//   directly, a thread a channel of a block of up to 256, in the same walk.
// No float atomics and a fixed order of every sum: repeats are bit-equal.
//
// Forward progress: every block is resident (cooperative launch). A task
// block waits only for an image's flag, in the apply of a group whose
// moments it has finished; a reducer waits only for the counts of moment
// runs. Every block finishes the moments of group g before it waits on
// anything of group g, so by induction over the groups every flag is
// raised: no cycle of waits.
// The counters (exit count, counts and flags) live in a zeroed int buffer
// that the wrapper keeps per device and stream; the last block out sets
// them back to 0, so a call is one launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kConsumers = 256;        // threads of the tasks' arithmetic
// vec: warp 8 stages the ring (producer); warp 9 adds the moment tasks'
// lane sums into their partials and counts them (partial warp)
constexpr int kProducer = kConsumers, kPartials = kConsumers + 32;
constexpr int kInThreads = kConsumers + 64;
// named barriers: 1 the consumers'; 2 + buf the lane sums of red[buf]
// handed to the partial warp, 4 + buf red[buf] free again
constexpr int kBarFull = 2, kBarEmpty = 4, kHandOff = kConsumers + 32;
constexpr int kInStageBytes = 16384;  // a ring stage
constexpr int kRedFloats = 4096;       // a buffer of lane sums
constexpr int kBatch = 8;              // partials' loads in flight a thread

// Channels in one 16-byte column.
template <typename T>
constexpr int kVecW = 16 / (int)sizeof(T);

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// Whether the barrier's phase of parity `parity` is complete (no wait).
__device__ __forceinline__ bool mbar_test(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done;
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// A barrier of the consumer threads only (the other warps never join).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}
// Adds 1 with release semantics at device scope, returning nothing (the
// thread does not wait for it): after a barrier of the block's threads,
// their stores before it are visible to whoever acquires the new count.
__device__ __forceinline__ void red_release_add(int* p) {
  asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(p)
               : "memory");
}

// 16 bytes of T as fp32 values, and back (rounded once).
__device__ __forceinline__ void unpack(uint4 u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(uint4 u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

struct Args {
  int B, HW, C;
  int chunks, rows;   // tasks an image (of each kind), pixels a task
  int group;          // images a group
  int reducers;       // blocks 0 .. reducers - 1 finalize the images
  int resident;       // vec: a task's staged run stays for its apply
  int ring;           // ring stages (vec)
  int lanes;          // pixel lanes of a task's threads
  int stage_rows;     // pixels a ring stage (vec), a multiple of lanes
  int fin_lanes;      // finalize threads a piece of channels
  float eps;
  int relu;
};

// Task t of group u: chunk t % chunks of image u * group + t / chunks.
struct Task {
  int b, p0, n;  // image, first pixel, pixels
};
__device__ __forceinline__ Task task(const Args& a, int u, int t) {
  const int b = u * a.group + t / a.chunks;
  const int p0 = (t % a.chunks) * a.rows;
  return {b, p0, min(p0 + a.rows, a.HW) - p0};
}
// The tasks of group u.
__device__ __forceinline__ int group_tasks(const Args& a, int u) {
  return (min((u + 1) * a.group, a.B) - u * a.group) * a.chunks;
}

// Step i of a task block's walk over G groups: the moments (or, if
// `apply`, the applies) of its tasks of group u. Resident (a run stays in
// the ring for its apply): the moments of group i. Else the runs are
// staged twice, one group apart: M_0, then M_{g+1} and A_g in turn, then
// A_{G-1}; 2 G steps.
__device__ __forceinline__ void step(int i, int G, bool resident,
                                     bool& apply, int& u) {
  if (resident || i == 0) {
    apply = false;
    u = i;
  } else if (i % 2) {
    u = (i + 1) / 2;
    apply = u >= G;
    if (apply) u = G - 1;
  } else {
    apply = true;
    u = i / 2 - 1;
  }
}

// The stages of a task block's walk, in order; the producer stages them.
template <typename T>
struct Stream {
  const T* x;
  const Args& a;
  int j, S, steps, i = 0, t, s = 0;
  Task k;
  __device__ Stream(const T* x_, const Args& a_, int j_, int S_, int G)
      : x(x_), a(a_), j(j_), S(S_), steps(a_.resident ? G : 2 * G), t(j_) {
    settle();
  }
  __device__ bool valid() const { return i < steps; }
  // the next task from (i, t) on
  __device__ void settle() {
    const int G = a.resident ? steps : steps / 2;
    for (; i < steps; ++i, t = j) {
      bool ap;
      int u;
      step(i, G, a.resident, ap, u);
      if (t < group_tasks(a, u)) {
        k = task(a, u, t);
        return;
      }
    }
  }
  __device__ void next() {
    if (++s * a.stage_rows >= k.n) {
      s = 0;
      t += S;
      settle();
    }
  }
  __device__ const void* src() const {
    return x + ((size_t)k.b * a.HW + k.p0 + (size_t)s * a.stage_rows) * a.C;
  }
  __device__ int bytes() const {
    return min(a.stage_rows, k.n - s * a.stage_rows) * a.C * (int)sizeof(T);
  }
};

// The lanes' sums in red (s1 at red, s2 at red + lanes * width, for
// `width` channels from c0), added in lane order into part's slot, by
// threads t, t + n, ... of a team of n.
__device__ __forceinline__ void store_partial(const float* red, int lanes,
                                              int width, int c0, float* part,
                                              size_t plane, size_t slot,
                                              int C, int t, int n) {
  for (int cc = t; cc < width && c0 + cc < C; cc += n) {
    float t1 = 0.f, t2 = 0.f;
    for (int l = 0; l < lanes; ++l) {
      t1 += red[l * width + cc];
      t2 += red[(lanes + l) * width + cc];
    }
    part[slot + c0 + cc] = t1;
    part[plane + slot + c0 + cc] = t2;
  }
}

// P fp32 values from p (16-byte aligned where P == 4), through L2.
template <int P>
__device__ __forceinline__ void ldcg_w(const float* p, float (&v)[P]) {
  if constexpr (P == 4) {
    const float4 u = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  } else {
    v[0] = __ldcg(p);
  }
}

// The finalize of image b (threads 0 .. 255 of a reducer block; every
// thread of the block passes its barriers): thread (lane fl, piece q of P
// channels) adds the chunk partials [fl per, (fl + 1) per) in chunk order,
// kBatch chunks' loads in flight; then the lanes are added in order:
//   mean = s1 / n, var = max(s2 / n - mean^2, 0), r = 1 / sqrt(var + eps)
//   scale = r gamma, shift = beta - mean scale
// into ss (planes scale, shift, mean, r of (B, C)).
template <int P>
__device__ void finalize(const float* __restrict__ part, size_t plane, int b,
                         const Args& a, float* red,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta,
                         float* __restrict__ ss, size_t bc) {
  const int C = a.C, fin_lanes = a.fin_lanes;
  const int np = C / P;                   // pieces a pixel row
  const int fw = min(np, kConsumers);     // pieces a pass
  const int tid = threadIdx.x;
  const int fl = tid / fw, q = tid % fw;
  const int per = (a.chunks + fin_lanes - 1) / fin_lanes;
  const int k0 = fl * per, k1 = min(k0 + per, a.chunks);
  const float n_px = (float)a.HW;
  for (int q0 = 0; q0 < np; q0 += fw) {
    float s1[P], s2[P];
#pragma unroll
    for (int e = 0; e < P; ++e) s1[e] = s2[e] = 0.f;
    const bool mine = tid < kConsumers && fl < fin_lanes && q0 + q < np;
    if (mine) {
      const float* p = part + (size_t)b * a.chunks * C + (q0 + q) * P;
      for (int k = k0; k < k1; k += kBatch) {
        float v1[kBatch][P], v2[kBatch][P];
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
          if (k + j < k1) {
            ldcg_w<P>(p + (size_t)(k + j) * C, v1[j]);
            ldcg_w<P>(p + plane + (size_t)(k + j) * C, v2[j]);
          }
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
          if (k + j < k1) {
#pragma unroll
            for (int e = 0; e < P; ++e) {
              s1[e] += v1[j][e];
              s2[e] += v2[j][e];
            }
          }
      }
    }
    __syncthreads();  // red is free
    const int w = fw * P;  // channels a pass
    if (mine) {
#pragma unroll
      for (int e = 0; e < P; ++e) {
        red[fl * w + q * P + e] = s1[e];
        red[(fin_lanes + fl) * w + q * P + e] = s2[e];
      }
    }
    __syncthreads();
    for (int cc = tid; cc < w && q0 * P + cc < C; cc += kInThreads) {
      float t1 = 0.f, t2 = 0.f;
      for (int l = 0; l < fin_lanes; ++l) {
        t1 += red[l * w + cc];
        t2 += red[(fin_lanes + l) * w + cc];
      }
      const int c = q0 * P + cc;
      const float m = t1 / n_px;
      const float var = fmaxf(t2 / n_px - m * m, 0.f);
      const float r = 1.f / sqrtf(var + a.eps);
      const float sc = r * gamma[c];
      const size_t o = (size_t)b * C + c;
      ss[o] = sc;
      ss[bc + o] = beta[c] - m * sc;
      ss[2 * bc + o] = m;
      ss[3 * bc + o] = r;
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kInThreads, 1)
    in_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, T* __restrict__ y,
                  float* __restrict__ ss, float* __restrict__ part,
                  int* __restrict__ sync, const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int red_task[2][2], s_poll[2];
  const int ns = a.ring;  // ring stages (vec)
  unsigned char* ring = smem;
  // lane sums: two buffers (vec: the consumers fill one while the partial
  // warp reads the other)
  float* red = reinterpret_cast<float*>(smem + (size_t)ns * kInStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 2 * kRedFloats);
  uint64_t* empty = full + ns;
  const int B = a.B, HW = a.HW, C = a.C, chunks = a.chunks;
  int* exited = sync;
  int* counts = sync + 1;  // moment tasks done, by image
  int* flags = counts + B;
  const int tid = threadIdx.x;
  const size_t plane = (size_t)B * chunks * C;
  const size_t bc = (size_t)B * C;
  const int groups = (B + a.group - 1) / a.group;
  const int S = gridDim.x - a.reducers;  // task blocks
  const int j = blockIdx.x - a.reducers;

  if (j < 0) {
    // ---- a reducer block: finalizes images blockIdx.x, + reducers, ...
    // as their moment tasks' counts complete, and raises their flags
    for (int b = blockIdx.x; b < B; b += a.reducers) {
      if (tid == 0)
        while (ld_acquire(&counts[b]) < chunks) __nanosleep(32);
      __syncthreads();
      if (C % 4 == 0)  // the partials in pieces of 4 channels
        finalize<4>(part, plane, b, a, red, gamma, beta, ss, bc);
      else
        finalize<1>(part, plane, b, a, red, gamma, beta, ss, bc);
      __syncthreads();
      if (tid == 0) st_release(&flags[b], 1);
    }
  } else if (tid < kConsumers || kVec) {
    // A task block walks the groups in order, taking tasks j, j + S, ...
    // of each: resident, its one task's moments, then (once the image's
    // statistics are out) its apply from the ring; else the moments and
    // the applies one group apart (step).
    // vec: a thread holds 16-byte column `col` of a pixel; scalar: channel
    // col of a block of `width` channels
    constexpr int W = kVec ? kVecW<T> : 1;
    const int width = kVec ? C / W : min(C, kConsumers);
    const int lane = tid / width, col = tid % width;
    const bool active = lane < a.lanes;
    const size_t row_bytes = (size_t)C * sizeof(T);
    if constexpr (kVec) {
      const int sr = a.stage_rows;
      if (tid == 0) {
        for (int s = 0; s < ns; ++s) {
          mbar_init(&full[s], 1);
          mbar_init(&empty[s], kConsumers / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      }
      __syncthreads();
      if (tid >= kPartials) {
        // ---- the partial warp: each moment task's lane sums into its
        // chunk's partial, then the image's count; b < 0 ends it
        bar_arrive(kBarEmpty, kHandOff);
        bar_arrive(kBarEmpty + 1, kHandOff);
        for (int m = 0;; ++m) {
          const int buf = m & 1;
          bar_sync(kBarFull + buf, kHandOff);
          const int b = red_task[buf][0], chunk = red_task[buf][1];
          if (b < 0) return;
          store_partial(red + buf * kRedFloats, a.lanes, C, 0, part, plane,
                        ((size_t)b * chunks + chunk) * C, C, tid - kPartials,
                        32);
          __syncwarp();
          if (tid == kPartials) red_release_add(&counts[b]);
          bar_arrive(kBarEmpty + buf, kHandOff);
        }
      }
      if (tid >= kProducer) {
        // ---- the producer: stages the block's runs into the ring in the
        // consumers' order: a group's moment runs, then (unless resident)
        // its apply runs again
        if (tid != kProducer) return;
        uint32_t g = 0;
        for (Stream<T> cur(x, a, j, S, groups); cur.valid(); cur.next(), ++g) {
          const int st = g % ns;
          mbar_wait(&empty[st], ((g / ns) & 1) ^ 1);
          mbar_expect_tx(&full[st], cur.bytes());
          bulk_copy(smem_u32(ring + st * kInStageBytes), cur.src(),
                    cur.bytes(), &full[st]);
        }
        return;
      }
      // ---- the consumers
      float s1[W], s2[W], sc[W], sh[W];
      // stage g's moments: one 16-byte column of each of the lane's pixels
      auto moments = [&](uint32_t g, int nr) {
        const unsigned char* p = ring + (g % ns) * kInStageBytes + col * 16;
        if (active)
          for (int r = lane; r < nr; r += a.lanes) {
            float v[W];
            unpack(*reinterpret_cast<const uint4*>(p + r * row_bytes), v);
#pragma unroll
            for (int e = 0; e < W; ++e) {
              s1[e] += v[e];
              s2[e] += v[e] * v[e];
            }
          }
      };
      // stage g applied to image b's pixels from p0 on; frees the stage
      auto apply = [&](uint32_t g, int nr, int b, int p0) {
        const unsigned char* p = ring + (g % ns) * kInStageBytes + col * 16;
        if (active) {
          unsigned char* yp = reinterpret_cast<unsigned char*>(
                                  y + ((size_t)b * HW + p0) * C) +
                              col * 16;
#pragma unroll 4
          for (int r = lane; r < nr; r += a.lanes) {
            float v[W];
            unpack(*reinterpret_cast<const uint4*>(p + r * row_bytes), v);
#pragma unroll
            for (int e = 0; e < W; ++e) {
              v[e] = v[e] * sc[e] + sh[e];
              if (a.relu) v[e] = fmaxf(v[e], 0.f);
            }
            __stcs(reinterpret_cast<uint4*>(yp + r * row_bytes), pack(v));
          }
        }
        __syncwarp();
        if (tid % 32 == 0) mbar_arrive(&empty[g % ns]);
      };
      auto scale_shift = [&](int b) {
        const float* p = ss + (size_t)b * C + col * W;
#pragma unroll
        for (int e = 0; e < W; ++e) {
          sc[e] = active ? __ldcg(p + e) : 0.f;
          sh[e] = active ? __ldcg(p + bc + e) : 0.f;
        }
      };
      int m = 0;       // moment tasks handed to the partial warp
      uint32_t g = 0;  // the next stage of the consumers' stream
      int early = 0;   // resident: the next task's stages summed already
      // a moment task: its stages from `early` on (freed unless resident),
      // then its lanes' sums to the partial warp
      auto moment_task = [&](const Task& k, int chunk) {
        if (!early) {
#pragma unroll
          for (int e = 0; e < W; ++e) s1[e] = s2[e] = 0.f;
        }
        for (int s = early; s * sr < k.n; ++s, ++g) {
          mbar_wait(&full[g % ns], (g / ns) & 1);
          moments(g, min(sr, k.n - s * sr));
          if (!a.resident) {
            __syncwarp();
            if (tid % 32 == 0) mbar_arrive(&empty[g % ns]);
          }
        }
        early = 0;
        const int buf = m++ & 1;
        float* rb = red + buf * kRedFloats;
        bar_sync(kBarEmpty + buf, kHandOff);
        if (active) {
#pragma unroll
          for (int e = 0; e < W; ++e) {
            rb[lane * C + col * W + e] = s1[e];
            rb[(a.lanes + lane) * C + col * W + e] = s2[e];
          }
        }
        if (tid == 0) {
          red_task[buf][0] = k.b;
          red_task[buf][1] = chunk;
        }
        bar_arrive(kBarFull + buf, kHandOff);
      };
      if (a.resident) {
        for (int u = 0; u < groups; ++u) {
          if (j >= group_tasks(a, u)) continue;
          const Task k = task(a, u, j);
          moment_task(k, j % chunks);
          // the task's stages stay in the ring: apply them once the
          // statistics are out, summing the next group's first stages
          // (as they arrive) meanwhile
          const int nst = (k.n + sr - 1) / sr;
          const uint32_t g0 = g - nst;
          const bool next = u + 1 < groups && j < group_tasks(a, u + 1);
          const int n1 = next ? task(a, u + 1, j).n : 0;
          const int nst1 = (n1 + sr - 1) / sr;
#pragma unroll
          for (int e = 0; e < W; ++e) s1[e] = s2[e] = 0.f;
          for (;;) {
            if (tid == 0) {
              const uint32_t ge = g + early;
              s_poll[0] = ld_acquire(&flags[k.b]);
              s_poll[1] =
                  early < nst1 && mbar_test(&full[ge % ns], (ge / ns) & 1);
            }
            consumer_sync();
            const int ready = s_poll[0], more = s_poll[1];
            consumer_sync();
            if (ready) break;
            if (more) {
              moments(g + early, min(sr, n1 - early * sr));
              ++early;
            } else if (tid == 0) {
              __nanosleep(32);
            }
          }
          scale_shift(k.b);
          for (int s = 0; s < nst; ++s)
            apply(g0 + s, min(sr, k.n - s * sr), k.b, k.p0 + s * sr);
          g += early;
        }
      } else {
        // the runs staged twice, one group apart (step)
        for (int i = 0; i < 2 * groups; ++i) {
          bool ap;
          int u;
          step(i, groups, false, ap, u);
          for (int t = j; t < group_tasks(a, u); t += S) {
            const Task k = task(a, u, t);
            if (!ap) {
              moment_task(k, t % chunks);
              continue;
            }
            if (tid == 0)
              while (ld_acquire(&flags[k.b]) == 0) __nanosleep(32);
            consumer_sync();
            scale_shift(k.b);
            for (int s = 0; s * sr < k.n; ++s, ++g) {
              mbar_wait(&full[g % ns], (g / ns) & 1);
              apply(g, min(sr, k.n - s * sr), k.b, k.p0 + s * sr);
            }
          }
        }
      }
      // end the partial warp; the last hand-over's buffer is waited for
      // too, so that each of its arrivals meets a wait
      const int buf = m & 1;
      bar_sync(kBarEmpty + buf, kHandOff);
      if (tid == 0) red_task[buf][0] = -1;
      bar_arrive(kBarFull + buf, kHandOff);
      bar_sync(kBarEmpty + (buf ^ 1), kHandOff);
    } else {
      // ---- scalar channels: the consumers read device memory directly
      for (int u = 0; u < groups; ++u) {
        for (int t = j; t < group_tasks(a, u); t += S) {
          const Task k = task(a, u, t);
          const size_t base = ((size_t)k.b * HW + k.p0) * C;
          for (int c0 = 0; c0 < C; c0 += width) {
            const int c = c0 + col;
            float s1 = 0.f, s2 = 0.f;
            if (active && c < C) {
              const T* xp = x + base + c;
#pragma unroll 4
              for (int q = lane; q < k.n; q += a.lanes) {
                const float v = to_f32(xp[(size_t)q * C]);
                s1 += v;
                s2 += v * v;
              }
            }
            consumer_sync();  // red is free
            if (active) {
              red[lane * width + col] = s1;
              red[(a.lanes + lane) * width + col] = s2;
            }
            consumer_sync();
            store_partial(red, a.lanes, width, c0, part, plane,
                          ((size_t)k.b * chunks + t % chunks) * C, C, tid,
                          kConsumers);
          }
          consumer_sync();  // the partials are stored
          if (tid == 0) red_release_add(&counts[k.b]);
        }
        for (int t = j; t < group_tasks(a, u); t += S) {
          const Task k = task(a, u, t);
          const size_t base = ((size_t)k.b * HW + k.p0) * C;
          if (tid == 0)
            while (ld_acquire(&flags[k.b]) == 0) __nanosleep(32);
          consumer_sync();
          for (int c0 = 0; c0 < C; c0 += width) {
            const int c = c0 + col;
            if (!active || c >= C) continue;
            const float sc = __ldcg(ss + (size_t)k.b * C + c);
            const float sh = __ldcg(ss + bc + (size_t)k.b * C + c);
#pragma unroll 4
            for (int q = lane; q < k.n; q += a.lanes) {
              const size_t o = base + (size_t)q * C + c;
              float v = to_f32(x[o]) * sc + sh;
              if (a.relu) v = fmaxf(v, 0.f);
              y[o] = from_f32<T>(v);
            }
          }
        }
      }
    }
  }
  // the last block out sets the counters back to 0 for the next call
  if (tid == 0 && atomicAdd(exited, 1) == (int)gridDim.x - 1) {
    for (int k = 0; k < 2 * B; ++k) counts[k] = 0;
    *exited = 0;
  }
}

template <typename T, bool kVec>
cudaError_t launch(const T* x, const float* gamma, const float* beta, T* y,
                   float* ss, float* part, int* sync, Args a, int grid,
                   cudaStream_t stream) {
  // the ring and its two barriers a stage, two lane-sum buffers
  const size_t smem =
      (size_t)a.ring * (kInStageBytes + 2 * 8) + 2 * kRedFloats * 4;
  // the grid must be resident at once (cooperative launch): reducer blocks
  // wait for moment tasks, and apply tasks for reducer blocks
  static size_t raised[64] = {};  // the shared-memory limit set, by device
  static int resident[64] = {};   // blocks resident at once, by device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (smem > raised[dev]) {
    err = cudaFuncSetAttribute(in_fwd_kernel<T, kVec>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    raised[dev] = smem;
    resident[dev] = 0;
  }
  if (!resident[dev]) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, in_fwd_kernel<T, kVec>, kInThreads, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    resident[dev] = per_sm * sms;
  }
  if (grid > resident[dev]) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&x, &gamma, &beta, &y, &ss, &part, &sync, &a};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(in_fwd_kernel<T, kVec>), dim3(grid),
      dim3(kInThreads), args, smem, stream);
}

template <typename T>
cudaError_t fwd(const void* x, const float* gamma, const float* beta,
                void* y, float* ss, float* part, int* sync, const Args& a,
                int vec, int grid, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const int width = vec ? a.C / kVecW<T> : min(a.C, kConsumers);
  // the finalize's pieces of 4 channels (C % 4 == 0) or 1
  const int fw = min(a.C % 4 ? a.C : a.C / 4, kConsumers);
  if (a.B < 1 || a.HW < 1 || a.C < 1 || a.chunks < 1 || a.rows < 1 ||
      (long long)a.chunks * a.rows < a.HW || a.group < 1 ||
      a.reducers < 1 || grid <= a.reducers || a.lanes < 1 ||
      a.lanes * width > kConsumers || a.fin_lanes < 1 ||
      a.fin_lanes * fw > kConsumers ||
      2 * a.lanes * (vec ? a.C : width) > kRedFloats ||
      2 * a.fin_lanes * fw * (a.C % 4 ? 1 : 4) > kRedFloats)
    return cudaErrorInvalidValue;
  if (!vec) {
    Args s = a;
    s.ring = s.resident = 0;
    return launch<T, false>(xt, gamma, beta, yt, ss, part, sync, s, grid,
                            stream);
  }
  // resident: each block holds at most one task of a group, whose stages
  // fit the ring
  const long long stages = (a.rows + a.stage_rows - 1) / a.stage_rows;
  if ((a.C * (int)sizeof(T)) % 16 || a.ring < 2 || a.ring > 12 ||
      a.stage_rows < a.lanes || a.stage_rows % a.lanes ||
      (size_t)a.stage_rows * a.C * sizeof(T) > (size_t)kInStageBytes ||
      (a.resident && ((long long)a.group * a.chunks > grid - a.reducers ||
                      stages > a.ring)))
    return cudaErrorInvalidValue;
  return launch<T, true>(xt, gamma, beta, yt, ss, part, sync, a, grid,
                         stream);
}

}  // namespace

// The launch of instance_norm.cu's entry point uig_instance_norm_fwd (see
// there for the operands).
cudaError_t uig_in_fwd(const void* x, const float* gamma, const float* beta,
                       void* y, float* ss, float* part, int* sync, int B,
                       int HW, int C, int chunks, int rows, int group,
                       int reducers, int resident, int ring, int lanes,
                       int stage_rows, int fin_lanes, int vec, int grid,
                       float eps, int relu, int is_bf16,
                       cudaStream_t stream) {
  const Args a{B,     HW,       C,        chunks, rows,       group,
               reducers, resident, ring,   lanes,  stage_rows, fin_lanes,
               eps,   relu};
  return is_bf16 ? fwd<bf16>(x, gamma, beta, y, ss, part, sync, a, vec, grid,
                             stream)
                 : fwd<float>(x, gamma, beta, y, ss, part, sync, a, vec, grid,
                              stream);
}
