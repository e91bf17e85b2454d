// Mamba (S6) selective scan backward for sm_90a: the gradient of the
// recurrence in ssm_scan.cu, for training the hybrid archs' Mamba layers.
//
// No TPU kernel corresponds: the JAX package differentiates its Mamba layer
// through XLA (its Pallas kernel, src/repro/kernels/ssm_scan/kernel.py,
// ssm_scan, has no custom_vjp). This is the gradient of what that kernel
// computes. Per (b, channel), with e_t = exp(dt_t a) and the cotangents dy
// [B, T, d_in] and dh_final [B, d_in, ds], the adjoint g runs backward in
// time from g = dh_final:
//   g <- g + C_t dy_t                      (now g = dL/dh_t)
//   du_t  = d_skip dy_t + dt_t sum_s g B_t
//   ddt_t = sum_s g (a e_t h_{t-1} + u_t B_t)
//   dB_t += g dt_t u_t,  dC_t += h_t dy_t  (summed over channels)
//   da   += g h_{t-1} dt_t e_t,  dd_skip += dy_t u_t  (summed over b and t)
//   g <- e_t g                             (dL/dh_{t-1}'s part through h_t)
//
// Bound on the H100: the bytes. The gradient's own inputs read once and
// outputs written once (u, dt, dy read and du, ddt written; B, C read and
// dB, dC written; a, d_skip, dh read and da, dd_skip written) are 342 MB
// at Jamba's layer shape (B 2, T 512, d_in 16384, ds 16): 0.102 ms at 3.35
// TB/s. One exponential an element and state, 0.27 G at the SFU's 16 a
// clock an SM, take 0.064 ms.
//
// Design:
// - h_{t-1} is never rebuilt by dividing by e_t (e_t underflows to 0 at
//   Jamba's a = -exp(a_log) with a large dt). The forward writes the state
//   entering every chunk of kChunk = 16 steps (ssm_scan.cu, h_chunks); the
//   backward walks the chunks last to first, recomputes the chunk's 16
//   states from its entering state with the forward's own arithmetic
//   (e_t = ex2.approx(dt a log2(e)), one fma), keeps the 16 e_t in
//   registers and the states in shared memory (a lane's as one 16-byte
//   row a step), then sweeps them backward: one exponential an element and
//   state. With the states in registers too a thread took 255 registers
//   and a block an SM less; the sweep (tools/ssm_scan_sweep.py --backward)
//   timed that at 0.848 ms against 0.640 at Jamba's layer shape on an H100
//   (PERF.md). Whole chunks run their 16 steps unguarded, so the compiler
//   interleaves one step's shuffles with the next step's work.
// - A chunk's u, dt, dy, B_t, C_t and entering states are staged in shared
//   memory with cp.async, double-buffered: the previous chunk's copies (the
//   sweep runs last chunk first) are in flight while this one computes,
//   every warp reads them as broadcasts from shared memory, and du and ddt
//   go out through shared memory as whole rows. u, dt and dy go as 16-byte
//   copies when d_in % 4 == 0 and they are 16-byte aligned, B_t, C_t and
//   the states when ds % 4 == 0 (and aligned); otherwise as 4-byte copies.
// - A channel's states split over kLanes adjacent lanes, kSpl =
//   REPRO_SSM_BWD_STATES_PER_LANE (4) each: at ds 16 four lanes, so a warp
//   covers 8 channels and a block of 128 threads 32. du and ddt join the
//   channel's lanes by a fixed xor tree.
// - No float atomics. dB_t and dC_t sum over d_in channels. A lane's 2 kSpl
//   terms of a step join the warp's other channels by a transposing
//   butterfly: each xor step over a channel bit swaps half of the values
//   with the partner lane and adds, so the 8 channels of a warp take 7
//   shuffles a lane, not 24, and lane l ends with one (term, state) of the
//   warp's sum. The warps of a block add in order through shared memory,
//   and the 8 blocks of a thread block cluster add their sums in rank order
//   through distributed shared memory, each block a share of the (step,
//   term, state) elements: one partial a 256-channel slab (64 at Jamba's
//   shape, 8.4 MB), not one a 16-channel block (134 MB). The cluster's
//   barrier is split: a block arrives when its chunk's sum is written and
//   waits only after its next chunk's sweep, then adds the cluster's sums
//   of that chunk. da and dd_skip keep one partial a batch row. A second
//   launch sums the partials in order. So two calls give the same bits.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

// the choices of the design, set at build time so that a sweep
// (tools/ssm_scan_sweep.py --backward) can compare them: states a lane
// holds, the chunk's states in shared memory (1) or registers (0), blocks
// an SM should hold at once (the register cap: 65536 / (128 x that))
#ifndef REPRO_SSM_BWD_STATES_PER_LANE
#define REPRO_SSM_BWD_STATES_PER_LANE 4
#endif
#ifndef REPRO_SSM_BWD_SMEM_STATES
#define REPRO_SSM_BWD_SMEM_STATES 1
#endif
#ifndef REPRO_SSM_BWD_MIN_BLOCKS
#define REPRO_SSM_BWD_MIN_BLOCKS 3
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 16;     // steps between the forward's saved states
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;    // blocks whose dB and dC share a partial
constexpr int kStatesPerLane = REPRO_SSM_BWD_STATES_PER_LANE;
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kStatesPerLane == 2 || kStatesPerLane == 4 ||
                  kStatesPerLane == 8,
              "states per lane: 2, 4 or 8");

constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x >> 1); }

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// BYTES from src to shared dst, or zeros there when !pred (src-size 0: no
// byte of src is read)
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool pred) {
  const int n = pred ? BYTES : 0;
  if (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

template <int DS>
struct Shape {
  static constexpr int kSpl = DS < kStatesPerLane ? DS : kStatesPerLane;
  static constexpr int kLanes = DS / kSpl;            // lanes a channel
  static constexpr int kChannels = kThreads / kLanes; // channels a block
  // dB and dC terms a lane holds a step, and the butterfly over the warp's
  // channel bits: its transposing steps and the values a lane keeps
  static constexpr int kValues = 2 * kSpl;
  static constexpr int kSteps = ilog2(32 / kLanes);
  static constexpr int kSwaps =
      kSteps < ilog2(kValues) ? kSteps : ilog2(kValues);
  static constexpr int kKeep = kValues >> kSwaps;
  // the channel bits of the plain steps after the swaps: lanes with any of
  // them set hold copies of their partners' sums
  static constexpr int kCopyBits = 2 * (16 >> kSwaps) - kLanes;
  // one buffer: u, dt, dy [kChunk][kChannels], B_t, C_t [kChunk][DS], the
  // entering states [kChannels][DS]
  static constexpr int kBufFloats =
      3 * kChunk * kChannels + 2 * kChunk * DS + kChannels * DS;
  static constexpr int kRedFloats = kWarps * kChunk * 2 * DS;   // warps'
  static constexpr int kBlkFloats = 2 * kChunk * 2 * DS;  // block's, x2
  static constexpr int kOutFloats = 2 * kChunk * kChannels;  // du, ddt
  static constexpr int kStateFloats =
      REPRO_SSM_BWD_SMEM_STATES ? kChunk * kSpl * kThreads : 0;
  static constexpr int kSmemBytes =
      4 * (2 * kBufFloats + kRedFloats + kBlkFloats + kOutFloats +
           kStateFloats);
};

// Start the copies of chunk k into `buf`: rows t0 + tt < T of u, dt, dy
// (this block's channels) and of B_t, C_t (states s < ds), and the states
// entering the chunk; everything else zero-filled, the padding states too.
template <int DS, bool VEC_U, bool VEC_BC>
__device__ __forceinline__ void stage_chunk(
    float* buf, const float* __restrict__ u, const float* __restrict__ dt,
    const float* __restrict__ dy, const float* __restrict__ bmat,
    const float* __restrict__ cmat, const float* __restrict__ h_chunks,
    int b, int k, int n_chunks, int T, int ch0, int d_in, int ds) {
  using S = Shape<DS>;
  constexpr int C = S::kChannels;
  float* su = buf;
  float* sdt = su + kChunk * C;
  float* sdy = sdt + kChunk * C;
  float* sb = sdy + kChunk * C;
  float* sc = sb + kChunk * DS;
  float* sh = sc + kChunk * DS;
  const long long row0 = static_cast<long long>(b) * T;
  const int t0 = k * kChunk;
  const int tc = min(kChunk, T - t0);
  const long long hrow = (static_cast<long long>(b) * n_chunks + k) * d_in;
  if (VEC_U) {
    constexpr int kQuads = C / 4;
    for (int i = threadIdx.x; i < kChunk * kQuads; i += kThreads) {
      const int tt = i / kQuads;
      const int c = 4 * (i - tt * kQuads);
      const bool ok = tt < tc && ch0 + c < d_in;
      const long long off = ok ? (row0 + t0 + tt) * d_in + ch0 + c : 0;
      cp_async<16>(su + tt * C + c, u + off, ok);
      cp_async<16>(sdt + tt * C + c, dt + off, ok);
      cp_async<16>(sdy + tt * C + c, dy + off, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kChunk * C; i += kThreads) {
      const int tt = i / C;
      const int c = i - tt * C;
      const bool ok = tt < tc && ch0 + c < d_in;
      const long long off = ok ? (row0 + t0 + tt) * d_in + ch0 + c : 0;
      cp_async<4>(su + i, u + off, ok);
      cp_async<4>(sdt + i, dt + off, ok);
      cp_async<4>(sdy + i, dy + off, ok);
    }
  }
  if (VEC_BC) {
    constexpr int kQuads = DS / 4;
    for (int i = threadIdx.x; i < kChunk * kQuads; i += kThreads) {
      const int tt = i / kQuads;
      const int s = 4 * (i - tt * kQuads);
      const bool ok = tt < tc && s < ds;
      const long long off = ok ? (row0 + t0 + tt) * ds + s : 0;
      cp_async<16>(sb + tt * DS + s, bmat + off, ok);
      cp_async<16>(sc + tt * DS + s, cmat + off, ok);
    }
    for (int i = threadIdx.x; i < C * kQuads; i += kThreads) {
      const int c = i / kQuads;
      const int s = 4 * (i - c * kQuads);
      const bool ok = ch0 + c < d_in && s < ds;
      cp_async<16>(sh + c * DS + s,
                   h_chunks + (ok ? (hrow + ch0 + c) * ds + s : 0), ok);
    }
  } else {
    for (int i = threadIdx.x; i < kChunk * DS; i += kThreads) {
      const int tt = i / DS;
      const int s = i - tt * DS;
      const bool ok = tt < tc && s < ds;
      const long long off = ok ? (row0 + t0 + tt) * ds + s : 0;
      cp_async<4>(sb + i, bmat + off, ok);
      cp_async<4>(sc + i, cmat + off, ok);
    }
    for (int i = threadIdx.x; i < C * DS; i += kThreads) {
      const int c = i / DS;
      const int s = i - c * DS;
      const bool ok = ch0 + c < d_in && s < ds;
      cp_async<4>(sh + i, h_chunks + (ok ? (hrow + ch0 + c) * ds + s : 0),
                  ok);
    }
  }
}

// n consecutive floats of shared memory at p (16-byte aligned when n % 4
// == 0) into x
template <int N>
__device__ __forceinline__ void load_row(float* x, const float* p) {
  if (N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + j);
      x[j] = v.x, x[j + 1] = v.y, x[j + 2] = v.z, x[j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = p[j];
  }
}

template <int N>
__device__ __forceinline__ void store_row(float* p, const float* x) {
  if (N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 4)
      *reinterpret_cast<float4*>(p + j) =
          make_float4(x[j], x[j + 1], x[j + 2], x[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) p[j] = x[j];
  }
}

// barrier.cluster in two halves: arrive (release: this thread's writes to
// shared memory are seen by the cluster's blocks after their wait), then
// wait (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <int DS, bool VEC_U, bool VEC_BC>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreads, REPRO_SSM_BWD_MIN_BLOCKS)
scan_bwd(const float* __restrict__ u, const float* __restrict__ dt,
         const float* __restrict__ bmat, const float* __restrict__ cmat,
         const float* __restrict__ a, const float* __restrict__ d_skip,
         const float* __restrict__ h_chunks, const float* __restrict__ dy,
         const float* __restrict__ dh, float* __restrict__ du,
         float* __restrict__ ddt, float* __restrict__ part_b,
         float* __restrict__ part_c, float* __restrict__ part_a,
         float* __restrict__ part_d, int batch, int T, int d_in, int ds) {
  using S = Shape<DS>;
  constexpr int kSpl = S::kSpl;
  constexpr int kLanes = S::kLanes;
  constexpr int C = S::kChannels;
  constexpr int kV2 = 2 * DS;   // dB and dC elements of a step
  extern __shared__ __align__(16) float smem[];
  float* red = smem + 2 * S::kBufFloats;   // [kWarps][kChunk][2 DS]
  float* blk = red + S::kRedFloats;        // [2][kChunk][2 DS]
  float* sdu = blk + S::kBlkFloats;        // [kChunk][C]
  float* sddt = sdu + kChunk * C;          // [kChunk][C]
  // REPRO_SSM_BWD_SMEM_STATES: the chunk's states, [kChunk][kThreads][kSpl]
  float* hsm = sddt + kChunk * C + threadIdx.x * kSpl;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int ch0 = blockIdx.x * C;
  const int cl = threadIdx.x / kLanes;
  const int sub = threadIdx.x - cl * kLanes;
  const int ch = ch0 + cl;
  const int s0 = sub * kSpl;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool live = ch < d_in;
  const long long row0 = static_cast<long long>(b) * T;
  const int n_chunks = (T + kChunk - 1) / kChunk;
  const int slab = blockIdx.x / kCluster;

  float an[kSpl], a2[kSpl], g[kSpl], da[kSpl];
#pragma unroll
  for (int j = 0; j < kSpl; ++j) {
    const bool in = live && s0 + j < ds;
    an[j] = in ? a[static_cast<long long>(ch) * ds + s0 + j] : 0.f;
    a2[j] = an[j] * kLog2e;
    g[j] = in && dh != nullptr
               ? dh[(static_cast<long long>(b) * d_in + ch) * ds + s0 + j]
               : 0.f;
    da[j] = 0.f;
  }
  const float dsk = live ? d_skip[ch] : 0.f;
  float dd = 0.f;

  // this block's share of the cluster's dB and dC at chunk k: the
  // blocks' sums in rank order
  auto reduce_cluster = [&](int k) {
    const int t0 = k * kChunk;
    const int tc = min(kChunk, T - t0);
    const float* bk = blk + (k & 1) * kChunk * kV2;
    for (int i = rank + kCluster * threadIdx.x; i < tc * kV2;
         i += kCluster * kThreads) {
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < kCluster; ++q)
        acc += cluster.map_shared_rank(bk, q)[i];
      const int tt = i / kV2;
      const int v = i - tt * kV2;
      const int kind = v / DS;
      const int s = v - kind * DS;
      if (s < ds)
        (kind == 0 ? part_b : part_c)[((static_cast<long long>(slab) * batch +
                                        b) * T + t0 + tt) * ds + s] = acc;
    }
  };

  stage_chunk<DS, VEC_U, VEC_BC>(smem + ((n_chunks - 1) & 1) * S::kBufFloats,
                                 u, dt, dy, bmat, cmat, h_chunks, b,
                                 n_chunks - 1, n_chunks, T, ch0, d_in, ds);
  cp_async_commit();
  for (int k = n_chunks - 1; k >= 0; --k) {
    const int t0 = k * kChunk;
    const int tc = min(kChunk, T - t0);
    if (k > 0)
      stage_chunk<DS, VEC_U, VEC_BC>(smem + ((k - 1) & 1) * S::kBufFloats,
                                     u, dt, dy, bmat, cmat, h_chunks, b,
                                     k - 1, n_chunks, T, ch0, d_in, ds);
    cp_async_commit();
    cp_async_wait_one();  // this thread's copies of chunk k have landed
    __syncthreads();      // and every other thread's
    const float* su = smem + (k & 1) * S::kBufFloats;
    const float* sdt = su + kChunk * C;
    const float* sdy = sdt + kChunk * C;
    const float* sb = sdy + kChunk * C;
    const float* sc = sb + kChunk * DS;
    const float* sh = sc + kChunk * DS;

    // the chunk's states and decays, as the forward computed them: step
    // tt's state in hs[tt] (or shared memory), its decays in es[tt]
    float h0[kSpl], h[kSpl], hc[kSpl], es[kChunk][kSpl], hs[kChunk][kSpl];
    load_row<kSpl>(h0, sh + cl * DS + s0);
#pragma unroll
    for (int j = 0; j < kSpl; ++j) h[j] = h0[j];
    auto recompute = [&](int tt) {
      const float dtt = sdt[tt * C + cl];
      const float dtu = dtt * su[tt * C + cl];
      float bv[kSpl];
      load_row<kSpl>(bv, sb + tt * DS + s0);
#pragma unroll
      for (int j = 0; j < kSpl; ++j) {
        es[tt][j] = exp2_approx(dtt * a2[j]);
        h[j] = fmaf(es[tt][j], h[j], dtu * bv[j]);
        hs[tt][j] = h[j];
      }
      if (REPRO_SSM_BWD_SMEM_STATES)
        store_row<kSpl>(hsm + tt * kThreads * kSpl, h);
    };
    // the adjoint at step tt (hc: the state after it, then before it)
    auto sweep = [&](int tt) {
      const float ut = su[tt * C + cl];
      const float dtt = sdt[tt * C + cl];
      const float dyt = sdy[tt * C + cl];
      const float dtu = dtt * ut;
      float bv[kSpl], cv[kSpl], hp[kSpl], v[S::kValues];
      load_row<kSpl>(bv, sb + tt * DS + s0);
      load_row<kSpl>(cv, sc + tt * DS + s0);
      if (tt == 0) {
#pragma unroll
        for (int j = 0; j < kSpl; ++j) hp[j] = h0[j];
      } else if (REPRO_SSM_BWD_SMEM_STATES) {
        load_row<kSpl>(hp, hsm + (tt - 1) * kThreads * kSpl);
      } else {
#pragma unroll
        for (int j = 0; j < kSpl; ++j) hp[j] = hs[tt > 0 ? tt - 1 : 0][j];
      }
      float gb = 0.f, gha = 0.f;
#pragma unroll
      for (int j = 0; j < kSpl; ++j) {
        g[j] = fmaf(cv[j], dyt, g[j]);
        const float e = es[tt][j];
        const float geh = g[j] * e * hp[j];
        gb = fmaf(g[j], bv[j], gb);
        gha = fmaf(geh, an[j], gha);
        da[j] = fmaf(geh, dtt, da[j]);
        v[j] = g[j] * dtu;          // dB_t's term
        v[kSpl + j] = hc[j] * dyt;  // dC_t's term
        g[j] *= e;
        hc[j] = hp[j];
      }
#pragma unroll
      for (int off = 1; off < kLanes; off <<= 1) {
        gb += __shfl_xor_sync(0xffffffffu, gb, off);
        gha += __shfl_xor_sync(0xffffffffu, gha, off);
      }
      if (sub == 0) {
        sdu[tt * C + cl] = fmaf(dtt, gb, dsk * dyt);
        sddt[tt * C + cl] = fmaf(ut, gb, gha);
      }
      dd = fmaf(dyt, ut, dd);
      // the warp's channels, high channel bit first: a swap step keeps
      // the lower half of the values on a lane whose bit is 0 and the
      // upper half on its partner, each adding the other's
#pragma unroll
      for (int st = 0; st < S::kSteps; ++st) {
        const int off = 16 >> st;
        if (st < S::kSwaps) {
          const int half = S::kValues >> (st + 1);
          const bool up = (lane & off) != 0;
#pragma unroll
          for (int i = 0; i < half; ++i) {
            const float send = up ? v[i] : v[i + half];
            const float mine = up ? v[i + half] : v[i];
            v[i] = mine + __shfl_xor_sync(0xffffffffu, send, off);
          }
        } else {
#pragma unroll
          for (int i = 0; i < S::kKeep; ++i)
            v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
        }
      }
      // v[i] is the warp's sum of the lanes' value i + the sum over the
      // swap steps st of (bit 16 >> st of this lane) x (kValues >> (st +
      // 1)): values below kSpl are dB's, the rest dC's, of states s0 + ..
      int idx = 0;
#pragma unroll
      for (int st = 0; st < S::kSwaps; ++st)
        if (lane & (16 >> st)) idx += S::kValues >> (st + 1);
      if ((lane & S::kCopyBits) == 0) {
#pragma unroll
        for (int i = 0; i < S::kKeep; ++i) {
          const int x = idx + i;
          const int kind = x / kSpl;
          red[(warp * kChunk + tt) * kV2 + kind * DS + s0 + x - kind * kSpl] =
              v[i];
        }
      }
    };
    if (tc == kChunk) {   // whole chunks: no step guarded, so the steps'
                          // shuffles and loads interleave
#pragma unroll
      for (int tt = 0; tt < kChunk; ++tt) recompute(tt);
#pragma unroll
      for (int j = 0; j < kSpl; ++j) hc[j] = h[j];
#pragma unroll
      for (int tt = kChunk - 1; tt >= 0; --tt) sweep(tt);
    } else {
#pragma unroll
      for (int tt = 0; tt < kChunk; ++tt)
        if (tt < tc) recompute(tt);
#pragma unroll
      for (int j = 0; j < kSpl; ++j) hc[j] = h[j];
#pragma unroll
      for (int tt = kChunk - 1; tt >= 0; --tt)
        if (tt < tc) sweep(tt);
    }
    __syncthreads();   // every warp's dB, dC terms and du, ddt rows are in
    // the cluster's sums of chunk k + 1, once every block has them
    if (k + 1 < n_chunks) {
      cluster_wait();
      reduce_cluster(k + 1);
    }
    // the block's sum of dB and dC at the chunk's steps: warps in order
    float* bk = blk + (k & 1) * kChunk * kV2;
    for (int i = threadIdx.x; i < tc * kV2; i += kThreads) {
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) acc += red[w * kChunk * kV2 + i];
      bk[i] = acc;
    }
    // du and ddt of the chunk, as whole rows
    for (int i = threadIdx.x; i < tc * C; i += kThreads) {
      const int tt = i / C;
      const int c = i - tt * C;
      if (ch0 + c < d_in) {
        const long long at = (row0 + t0 + tt) * d_in + ch0 + c;
        du[at] = sdu[i];
        ddt[at] = sddt[i];
      }
    }
    // chunk k's sum is out; every block has read chunk k + 1's (blk[k & 1]
    // was chunk k + 2's, read before the blocks' last arrive)
    cluster_arrive();
    __syncthreads();   // this chunk's buffer, red and the rows are free
  }
  cluster_wait();
  reduce_cluster(0);
  // no block leaves while another may still read its shared memory
  cluster_arrive();
  cluster_wait();
  if (!live) return;
#pragma unroll
  for (int j = 0; j < kSpl; ++j)
    if (s0 + j < ds)
      part_a[(static_cast<long long>(b) * d_in + ch) * ds + s0 + j] = da[j];
  if (sub == 0) part_d[static_cast<long long>(b) * d_in + ch] = dd;
}

// out_j[i] = sum over s of in_j[s * len_j + i], s in order, for the four
// jobs j (blockIdx.y): dB and dC over the slabs, da and dd_skip over the
// batch rows
struct Sums {
  const float* in[4];
  float* out[4];
  int n[4];
  long long len[4];
};

__global__ void __launch_bounds__(256) sum_partials(Sums job) {
  const int j = blockIdx.y;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= job.len[j]) return;
  const float* in = job.in[j];
  float acc = 0.f;
#pragma unroll 8
  for (int s = 0; s < job.n[j]; ++s) acc += in[s * job.len[j] + i];
  job.out[j][i] = acc;
}

template <int DS>
int slabs(int d_in) {
  const int blocks = (d_in + Shape<DS>::kChannels - 1) / Shape<DS>::kChannels;
  return (blocks + kCluster - 1) / kCluster;
}

int slabs_for(int ds, int d_in) {
  if (ds <= 4) return slabs<4>(d_in);
  if (ds <= 8) return slabs<8>(d_in);
  if (ds <= 16) return slabs<16>(d_in);
  if (ds <= 32) return slabs<32>(d_in);
  return slabs<64>(d_in);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int DS, bool VEC_U, bool VEC_BC>
cudaError_t launch3(const float* u, const float* dt, const float* bmat,
                    const float* cmat, const float* a, const float* d_skip,
                    const float* h_chunks, const float* dy, const float* dh,
                    float* du, float* ddt, float* part_b, float* part_c,
                    float* part_a, float* part_d, int batch, int T,
                    int d_in, int ds, cudaStream_t stream) {
  using S = Shape<DS>;
  auto kernel = scan_bwd<DS, VEC_U, VEC_BC>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(slabs<DS>(d_in) * kCluster, batch);
  kernel<<<grid, kThreads, S::kSmemBytes, stream>>>(
      u, dt, bmat, cmat, a, d_skip, h_chunks, dy, dh, du, ddt, part_b,
      part_c, part_a, part_d, batch, T, d_in, ds);
  return cudaGetLastError();
}

template <int DS>
cudaError_t launch(const float* u, const float* dt, const float* bmat,
                   const float* cmat, const float* a, const float* d_skip,
                   const float* h_chunks, const float* dy, const float* dh,
                   float* du, float* ddt, float* dbmat, float* dcmat,
                   float* da, float* dd, float* work, int batch, int T,
                   int d_in, int ds, cudaStream_t stream) {
  const int n_slabs = slabs<DS>(d_in);
  const long long bc = static_cast<long long>(batch) * T * ds;
  const long long ad = static_cast<long long>(d_in) * ds;
  float* part_b = work;
  float* part_c = part_b + n_slabs * bc;
  float* part_a = part_c + n_slabs * bc;
  float* part_d = part_a + batch * ad;
  const bool vec_u = d_in % 4 == 0 && aligned16(u) && aligned16(dt) &&
                     aligned16(dy);
  const bool vec_bc = ds % 4 == 0 && aligned16(bmat) && aligned16(cmat) &&
                      aligned16(h_chunks);
  cudaError_t err;
  if (vec_u && vec_bc)
    err = launch3<DS, true, true>(u, dt, bmat, cmat, a, d_skip, h_chunks, dy,
                                  dh, du, ddt, part_b, part_c, part_a, part_d,
                                  batch, T, d_in, ds, stream);
  else if (vec_u)
    err = launch3<DS, true, false>(u, dt, bmat, cmat, a, d_skip, h_chunks,
                                   dy, dh, du, ddt, part_b, part_c, part_a,
                                   part_d, batch, T, d_in, ds, stream);
  else if (vec_bc)
    err = launch3<DS, false, true>(u, dt, bmat, cmat, a, d_skip, h_chunks,
                                   dy, dh, du, ddt, part_b, part_c, part_a,
                                   part_d, batch, T, d_in, ds, stream);
  else
    err = launch3<DS, false, false>(u, dt, bmat, cmat, a, d_skip, h_chunks,
                                    dy, dh, du, ddt, part_b, part_c, part_a,
                                    part_d, batch, T, d_in, ds, stream);
  if (err != cudaSuccess) return err;
  Sums job;
  job.in[0] = part_b, job.out[0] = dbmat, job.n[0] = n_slabs, job.len[0] = bc;
  job.in[1] = part_c, job.out[1] = dcmat, job.n[1] = n_slabs, job.len[1] = bc;
  job.in[2] = part_a, job.out[2] = da, job.n[2] = batch, job.len[2] = ad;
  job.in[3] = part_d, job.out[3] = dd, job.n[3] = batch, job.len[3] = d_in;
  const long long widest = bc > ad ? bc : ad;
  sum_partials<<<dim3(static_cast<unsigned>((widest + 255) / 256), 4), 256,
                 0, stream>>>(job);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Floats of the workspace repro_ssm_scan_bwd takes: the partials of dB and
// dC (one a slab of channels), of da and dd_skip (one a batch row).
extern "C" long long repro_ssm_scan_bwd_workspace(int batch, int T, int d_in,
                                                  int ds) {
  const long long n_slabs = slabs_for(ds, d_in);
  return 2 * n_slabs * batch * T * ds +
         static_cast<long long>(batch) * d_in * (ds + 1);
}

// All fp32 and contiguous: u, dt, dy, du, ddt [batch, T, d_in]; bmat, cmat,
// dbmat, dcmat [batch, T, ds]; a, da [d_in, ds]; d_skip, dd [d_in]; dh
// (the final state's cotangent, or null for zero) [batch, d_in, ds];
// h_chunks the forward's states entering each chunk of `chunk` steps
// [batch, ceil(T / chunk), d_in, ds]; work repro_ssm_scan_bwd_workspace
// floats. Every output is written whole. The wrapper checks 1 <= ds <= 64,
// T >= 1, 1 <= batch <= 65535. Returns cudaErrorInvalidValue unless chunk
// is the kernel's kChunk.
extern "C" int repro_ssm_scan_bwd(
    const void* u, const void* dt, const void* bmat, const void* cmat,
    const void* a, const void* d_skip, const void* h_chunks, const void* dy,
    const void* dh, void* du, void* ddt, void* dbmat, void* dcmat, void* da,
    void* dd, void* work, int chunk, int batch, int T, int d_in, int ds,
    void* stream) {
  if (chunk != kChunk) return static_cast<int>(cudaErrorInvalidValue);
  const float* pu = static_cast<const float*>(u);
  const float* pdt = static_cast<const float*>(dt);
  const float* pb = static_cast<const float*>(bmat);
  const float* pc = static_cast<const float*>(cmat);
  const float* pa = static_cast<const float*>(a);
  const float* pd = static_cast<const float*>(d_skip);
  const float* phc = static_cast<const float*>(h_chunks);
  const float* pdy = static_cast<const float*>(dy);
  const float* pdh = static_cast<const float*>(dh);
  float* o[6] = {static_cast<float*>(du), static_cast<float*>(ddt),
                 static_cast<float*>(dbmat), static_cast<float*>(dcmat),
                 static_cast<float*>(da), static_cast<float*>(dd)};
  float* w = static_cast<float*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (ds <= 4) {
    err = launch<4>(pu, pdt, pb, pc, pa, pd, phc, pdy, pdh, o[0], o[1], o[2],
                    o[3], o[4], o[5], w, batch, T, d_in, ds, s);
  } else if (ds <= 8) {
    err = launch<8>(pu, pdt, pb, pc, pa, pd, phc, pdy, pdh, o[0], o[1], o[2],
                    o[3], o[4], o[5], w, batch, T, d_in, ds, s);
  } else if (ds <= 16) {
    err = launch<16>(pu, pdt, pb, pc, pa, pd, phc, pdy, pdh, o[0], o[1],
                     o[2], o[3], o[4], o[5], w, batch, T, d_in, ds, s);
  } else if (ds <= 32) {
    err = launch<32>(pu, pdt, pb, pc, pa, pd, phc, pdy, pdh, o[0], o[1],
                     o[2], o[3], o[4], o[5], w, batch, T, d_in, ds, s);
  } else {
    err = launch<64>(pu, pdt, pb, pc, pa, pd, phc, pdy, pdh, o[0], o[1],
                     o[2], o[3], o[4], o[5], w, batch, T, d_in, ds, s);
  }
  return static_cast<int>(err);
}
