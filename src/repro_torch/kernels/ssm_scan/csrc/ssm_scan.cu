// Mamba (S6) selective scan for sm_90a: the sequence recurrence of every
// Mamba layer of a prefill.
//
// Replaces the TPU kernel ssm_scan (body _ssm_kernel) in
// src/repro/kernels/ssm_scan/kernel.py: from u, dt [B, T, d_in], B_t, C_t
// [B, T, ds], a [d_in, ds] and d_skip [d_in], per (b, channel) the state
// h [ds] runs h <- exp(dt_t a) * h + (dt_t u_t) B_t, and
// y_t = sum_s h C_t + u_t d_skip; it returns y [B, T, d_in] and the final h
// [B, d_in, ds], all fp32. The state never leaves fast memory during the
// time sweep (on the TPU: VMEM; here: registers).
//
// Bound on the H100: the exponentials. At the serve path's shape (B 4,
// T 2048, d_in 16384, ds 16) it takes B*T*d_in*ds = 2.1 G of them, 0.51 ms
// at the SFU's 16 per clock per SM; it reads u and dt and writes y, 1.6 GB
// (0.48 ms at 3.35 TB/s).
//
// Design, against that bound:
// - The exponent on the SFU alone. a is prescaled by log2(e) once, in
//   registers, so each (t, s) is one multiply (dt * a2), one
//   ex2.approx.ftz (a single MUFU.EX2; expf would wrap it in a range
//   reduction of several FP32 instructions) and two fma: the SFU, not the
//   FP32 pipe, sets the pace. The recurrence is held to the plain version
//   at atol 2e-5 + rtol 1e-5 (ref.ssm_scan_exp2 is this arithmetic on the
//   CPU).
// - A channel's states split over L adjacent lanes (kStatesPerLane states
//   each, L = DS / kStatesPerLane), so a block of kChannels channels runs
//   kChannels * L threads; y_t is the lanes' partial sums joined by
//   __shfl_xor_sync, each lane's states summed in ascending order. More
//   lanes mean more warps in flight but more work per state (the shuffles,
//   u and dt read by every lane): at ds 16 on an H100, 16 states a lane
//   (no split) measured fastest against 8 and 4 (tools/ssm_scan_sweep.py;
//   the times are in PERF.md), so only ds 32 and 64 split, over 2 and 4
//   lanes.
// - u, dt, B_t and C_t of a chunk of kChunk steps are staged in shared
//   memory with cp.async, double-buffered: the next chunk's copies are in
//   flight while this one computes, and a block waits at most once per
//   chunk. u and dt go as 16-byte copies when d_in % 4 == 0 and the
//   tensors are 16-byte aligned, B_t and C_t when ds % 4 == 0 (and
//   aligned); otherwise as 4-byte copies.
// - The state width is a template argument (ds rounded up to 4, 8, 16, 32
//   or 64), the padding states held at a = 0 and B = C = 0 so they stay 0.
//   Any T and d_in are taken: channels past d_in and steps past T are
//   zero-filled in the stage and never written out. The TPU's sequential
//   grid axis over time tiles becomes the in-block loop over chunks.
// - For training, the state entering each chunk (h before step k kChunk,
//   zero for chunk 0) is written to h_chunks [B, ceil(T / kChunk), d_in,
//   ds] when that pointer is non-null: the backward kernel
//   (ssm_scan_bwd.cu) recomputes each chunk's states from it. Serving
//   passes null; y and h take the same arithmetic either way.
#include <cuda_runtime.h>
#include <stdint.h>

// the choices of the design, set at build time so that a sweep
// (tools/ssm_scan_sweep.py) can compare them: states a lane holds, time
// steps staged per chunk, channels per block
#ifndef REPRO_SSM_STATES_PER_LANE
#define REPRO_SSM_STATES_PER_LANE 16
#endif
#ifndef REPRO_SSM_CHUNK
#define REPRO_SSM_CHUNK 16
#endif
#ifndef REPRO_SSM_CHANNELS
#define REPRO_SSM_CHANNELS 64
#endif

namespace {

constexpr int kStatesPerLane = REPRO_SSM_STATES_PER_LANE;
constexpr int kChunk = REPRO_SSM_CHUNK;
constexpr int kChannels = REPRO_SSM_CHANNELS;  // channels per block
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kStatesPerLane == 4 || kStatesPerLane == 8 ||
                  kStatesPerLane == 16 || kStatesPerLane == 32,
              "states per lane: 4, 8, 16 or 32");
static_assert(kChannels % 32 == 0 && kChannels <= 128,
              "channels per block: a multiple of 32 up to 128");

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
  static constexpr int kLanes = DS / kSpl;  // lanes per channel
  static constexpr int kThreads = kChannels * kLanes;
  // blocks an SM should hold at once, for __launch_bounds__: 512 threads,
  // so ptxas may give a thread up to 128 registers (without the hint it
  // spilled a few bytes at 80 in the 4-byte-copy forms at ds 16)
  static constexpr int kMinBlocks = kThreads < 512 ? 512 / kThreads : 1;
  // one buffer: u and dt [kChunk][kChannels], B_t and C_t [kChunk][DS]
  static constexpr int kBufFloats = 2 * kChunk * kChannels + 2 * kChunk * DS;
  static constexpr int kSmemBytes = 2 * kBufFloats * 4;
};

// Start the copies of chunk t0 into `buf`: rows t0 + tt < T of u, dt (this
// block's channels) and of B_t, C_t (states s < ds); everything else
// zero-filled, the padding states of B_t and C_t too.
template <int DS, bool VEC_U, bool VEC_BC>
__device__ __forceinline__ void stage_chunk(
    float* buf, const float* __restrict__ u, const float* __restrict__ dt,
    const float* __restrict__ bmat, const float* __restrict__ cmat,
    long long row0, int t0, int T, int ch0, int d_in, int ds) {
  using S = Shape<DS>;
  float* su = buf;
  float* sdt = su + kChunk * kChannels;
  float* sb = sdt + kChunk * kChannels;
  float* sc = sb + kChunk * DS;
  const int tc = min(kChunk, T - t0);
  if (VEC_U) {
    constexpr int kQuads = kChannels / 4;
    for (int i = threadIdx.x; i < kChunk * kQuads; i += S::kThreads) {
      const int tt = i / kQuads;
      const int c = 4 * (i - tt * kQuads);
      const bool ok = tt < tc && ch0 + c < d_in;
      const long long off = ok ? (row0 + t0 + tt) * d_in + ch0 + c : 0;
      cp_async<16>(su + tt * kChannels + c, u + off, ok);
      cp_async<16>(sdt + tt * kChannels + c, dt + off, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kChunk * kChannels; i += S::kThreads) {
      const int tt = i / kChannels;
      const int c = i - tt * kChannels;
      const bool ok = tt < tc && ch0 + c < d_in;
      const long long off = ok ? (row0 + t0 + tt) * d_in + ch0 + c : 0;
      cp_async<4>(su + i, u + off, ok);
      cp_async<4>(sdt + i, dt + off, ok);
    }
  }
  if (VEC_BC) {
    constexpr int kQuads = DS / 4;
    for (int i = threadIdx.x; i < kChunk * kQuads; i += S::kThreads) {
      const int tt = i / kQuads;
      const int s = 4 * (i - tt * kQuads);
      const bool ok = tt < tc && s < ds;
      const long long off = ok ? (row0 + t0 + tt) * ds + s : 0;
      cp_async<16>(sb + tt * DS + s, bmat + off, ok);
      cp_async<16>(sc + tt * DS + s, cmat + off, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kChunk * DS; i += S::kThreads) {
      const int tt = i / DS;
      const int s = i - tt * DS;
      const bool ok = tt < tc && s < ds;
      const long long off = ok ? (row0 + t0 + tt) * ds + s : 0;
      cp_async<4>(sb + i, bmat + off, ok);
      cp_async<4>(sc + i, cmat + off, ok);
    }
  }
}

template <int DS, bool VEC_U, bool VEC_BC>
__global__ void __launch_bounds__(Shape<DS>::kThreads, Shape<DS>::kMinBlocks)
ssm_scan_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                const float* __restrict__ bmat, const float* __restrict__ cmat,
                const float* __restrict__ a, const float* __restrict__ d_skip,
                float* __restrict__ y, float* __restrict__ h_out,
                float* __restrict__ h_chunks, int T, int d_in, int ds) {
  using S = Shape<DS>;
  constexpr int kSpl = S::kSpl;
  constexpr int kLanes = S::kLanes;
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int ch0 = blockIdx.x * kChannels;
  const int cl = threadIdx.x / kLanes;   // channel within the block
  const int sub = threadIdx.x - cl * kLanes;
  const int ch = ch0 + cl;
  const int s0 = sub * kSpl;             // this lane's first state
  const bool live = ch < d_in;
  const long long row0 = static_cast<long long>(b) * T;  // first (b, t) row

  float h[kSpl], a2[kSpl];
#pragma unroll
  for (int j = 0; j < kSpl; ++j) {
    h[j] = 0.f;
    const int s = s0 + j;
    a2[j] = live && s < ds
                ? a[static_cast<long long>(ch) * ds + s] * kLog2e
                : 0.f;
  }
  const float dsk = live ? d_skip[ch] : 0.f;

  const int n_chunks = (T + kChunk - 1) / kChunk;
  stage_chunk<DS, VEC_U, VEC_BC>(smem, u, dt, bmat, cmat, row0, 0, T, ch0,
                                 d_in, ds);
  cp_async_commit();
  for (int k = 0; k < n_chunks; ++k) {
    const int t0 = k * kChunk;
    if (k + 1 < n_chunks)
      stage_chunk<DS, VEC_U, VEC_BC>(smem + ((k + 1) & 1) * S::kBufFloats, u,
                                     dt, bmat, cmat, row0, t0 + kChunk, T,
                                     ch0, d_in, ds);
    cp_async_commit();
    cp_async_wait_one();  // this thread's copies of chunk k have landed
    __syncthreads();      // and every other thread's
    const float* su = smem + (k & 1) * S::kBufFloats;
    const float* sdt = su + kChunk * kChannels;
    const float* sb = sdt + kChunk * kChannels;
    const float* sc = sb + kChunk * DS;
    const int tc = min(kChunk, T - t0);
    if (h_chunks != nullptr && live) {
      float* hc = h_chunks + ((static_cast<long long>(b) * n_chunks + k)
                              * d_in + ch) * ds;
#pragma unroll
      for (int j = 0; j < kSpl; ++j)
        if (s0 + j < ds) hc[s0 + j] = h[j];
    }
#pragma unroll 4
    for (int tt = 0; tt < tc; ++tt) {
      const float ut = su[tt * kChannels + cl];
      const float dtt = sdt[tt * kChannels + cl];
      const float dtu = dtt * ut;
      float bv[kSpl], cv[kSpl];
#pragma unroll
      for (int j = 0; j < kSpl; j += 4) {
        const float4 b4 =
            *reinterpret_cast<const float4*>(sb + tt * DS + s0 + j);
        const float4 c4 =
            *reinterpret_cast<const float4*>(sc + tt * DS + s0 + j);
        bv[j] = b4.x, bv[j + 1] = b4.y, bv[j + 2] = b4.z, bv[j + 3] = b4.w;
        cv[j] = c4.x, cv[j + 1] = c4.y, cv[j + 2] = c4.z, cv[j + 3] = c4.w;
      }
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kSpl; ++j) {
        h[j] = fmaf(exp2_approx(dtt * a2[j]), h[j], dtu * bv[j]);
        acc = fmaf(h[j], cv[j], acc);
      }
#pragma unroll
      for (int off = 1; off < kLanes; off <<= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (live && sub == 0)
        y[(row0 + t0 + tt) * d_in + ch] = fmaf(ut, dsk, acc);
    }
    __syncthreads();  // chunk k's buffer is free for chunk k + 2
  }
  if (!live) return;
  float* hb = h_out + (static_cast<long long>(b) * d_in + ch) * ds;
#pragma unroll
  for (int j = 0; j < kSpl; ++j)
    if (s0 + j < ds) hb[s0 + j] = h[j];
}

template <int DS, bool VEC_U, bool VEC_BC>
cudaError_t launch3(const float* u, const float* dt, const float* bmat,
                    const float* cmat, const float* a, const float* d_skip,
                    float* y, float* h_out, float* h_chunks, int batch,
                    int T, int d_in, int ds, cudaStream_t stream) {
  using S = Shape<DS>;
  auto kernel = ssm_scan_kernel<DS, VEC_U, VEC_BC>;
  if (S::kSmemBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((d_in + kChannels - 1) / kChannels, batch);
  kernel<<<grid, S::kThreads, S::kSmemBytes, stream>>>(
      u, dt, bmat, cmat, a, d_skip, y, h_out, h_chunks, T, d_in, ds);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int DS>
cudaError_t launch(const float* u, const float* dt, const float* bmat,
                   const float* cmat, const float* a, const float* d_skip,
                   float* y, float* h_out, float* h_chunks, int batch, int T,
                   int d_in, int ds, cudaStream_t stream) {
  const bool vec_u = d_in % 4 == 0 && aligned16(u) && aligned16(dt);
  const bool vec_bc = ds % 4 == 0 && aligned16(bmat) && aligned16(cmat);
  if (vec_u && vec_bc)
    return launch3<DS, true, true>(u, dt, bmat, cmat, a, d_skip, y, h_out,
                                   h_chunks, batch, T, d_in, ds, stream);
  if (vec_u)
    return launch3<DS, true, false>(u, dt, bmat, cmat, a, d_skip, y, h_out,
                                    h_chunks, batch, T, d_in, ds, stream);
  if (vec_bc)
    return launch3<DS, false, true>(u, dt, bmat, cmat, a, d_skip, y, h_out,
                                    h_chunks, batch, T, d_in, ds, stream);
  return launch3<DS, false, false>(u, dt, bmat, cmat, a, d_skip, y, h_out,
                                   h_chunks, batch, T, d_in, ds, stream);
}

int run(const void* u, const void* dt, const void* bmat, const void* cmat,
        const void* a, const void* d_skip, void* y, void* h_out,
        void* h_chunks, int batch, int T, int d_in, int ds, void* stream) {
  const float* pu = static_cast<const float*>(u);
  const float* pdt = static_cast<const float*>(dt);
  const float* pb = static_cast<const float*>(bmat);
  const float* pc = static_cast<const float*>(cmat);
  const float* pa = static_cast<const float*>(a);
  const float* pd = static_cast<const float*>(d_skip);
  float* py = static_cast<float*>(y);
  float* ph = static_cast<float*>(h_out);
  float* pk = static_cast<float*>(h_chunks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (ds <= 4) {
    err = launch<4>(pu, pdt, pb, pc, pa, pd, py, ph, pk, batch, T, d_in, ds,
                    s);
  } else if (ds <= 8) {
    err = launch<8>(pu, pdt, pb, pc, pa, pd, py, ph, pk, batch, T, d_in, ds,
                    s);
  } else if (ds <= 16) {
    err = launch<16>(pu, pdt, pb, pc, pa, pd, py, ph, pk, batch, T, d_in, ds,
                     s);
  } else if (ds <= 32) {
    err = launch<32>(pu, pdt, pb, pc, pa, pd, py, ph, pk, batch, T, d_in, ds,
                     s);
  } else {
    err = launch<64>(pu, pdt, pb, pc, pa, pd, py, ph, pk, batch, T, d_in, ds,
                     s);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// All fp32 and contiguous: u, dt, y [batch, T, d_in]; bmat, cmat
// [batch, T, ds]; a [d_in, ds]; d_skip [d_in]; h_out [batch, d_in, ds].
// The wrapper checks 1 <= ds <= 64, T >= 1, 1 <= batch <= 65535.
extern "C" int repro_ssm_scan(const void* u, const void* dt, const void* bmat,
                              const void* cmat, const void* a,
                              const void* d_skip, void* y, void* h_out,
                              int batch, int T, int d_in, int ds,
                              void* stream) {
  return run(u, dt, bmat, cmat, a, d_skip, y, h_out, nullptr, batch, T, d_in,
             ds, stream);
}

// The same, also writing the state entering each chunk of `chunk` steps
// into h_chunks, contiguous fp32 [batch, ceil(T / chunk), d_in, ds] (the
// training forward). Returns cudaErrorInvalidValue unless chunk is the
// kernel's kChunk.
extern "C" int repro_ssm_scan_chunks(const void* u, const void* dt,
                                     const void* bmat, const void* cmat,
                                     const void* a, const void* d_skip,
                                     void* y, void* h_out, void* h_chunks,
                                     int chunk, int batch, int T, int d_in,
                                     int ds, void* stream) {
  if (chunk != kChunk) return static_cast<int>(cudaErrorInvalidValue);
  return run(u, dt, bmat, cmat, a, d_skip, y, h_out, h_chunks, batch, T,
             d_in, ds, stream);
}
