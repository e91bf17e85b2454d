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
// Bound on the H100: the exponentials (each e_t is recomputed twice: once
// to rebuild the chunk's states, once in the sweep) at the SFU's 16 per
// clock per SM, or the bytes, whichever is larger. At Jamba's layer shape
// (B 2, T 512, d_in 16384, ds 16): 0.54 G exponentials, 0.128 ms; about
// 0.4 GB read and written, 0.12 ms.
//
// Design:
// - h_{t-1} is never rebuilt by dividing by e_t (e_t underflows to 0 at
//   Jamba's a = -exp(a_log) with a large dt). The forward writes the state
//   entering every chunk of kChunk = 16 steps (ssm_scan.cu, h_chunks); the
//   backward walks the chunks last to first, recomputes the chunk's 16
//   states from its entering state in registers, with the forward's own
//   arithmetic (e_t = ex2.approx(dt a log2(e)), one fma), then sweeps them
//   backward.
// - A channel's states split over kLanes adjacent lanes (kSpl states
//   each): all of them up to ds 16, 16 lanes above. du and ddt join the
//   channel's lanes by a fixed xor tree.
// - No float atomics. dB_t and dC_t sum over d_in channels: the channels of
//   a warp join by a fixed xor tree, the warps of a block in order through
//   shared memory, into one partial per block of channels; da and dd_skip
//   keep one partial per batch row. A second kernel sums the partials in
//   order (sum_slabs). So two calls give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;     // steps between the forward's saved states
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int DS>
struct Shape {
  static constexpr int kLanes = DS < 16 ? DS : 16;   // lanes per channel
  static constexpr int kSpl = DS / kLanes;           // states per lane
  static constexpr int kChannels = kThreads / kLanes;
  // the per-step partials of dB and dC of each warp, for one chunk
  static constexpr int kSmemBytes = 2 * kWarps * kChunk * DS * 4;
};

template <int DS>
__global__ void __launch_bounds__(kThreads)
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
  extern __shared__ __align__(16) float smem[];
  float* red_b = smem;                            // [kWarps][kChunk][DS]
  float* red_c = red_b + kWarps * kChunk * DS;
  const int b = blockIdx.y;
  const int cb = blockIdx.x;
  const int cl = threadIdx.x / kLanes;
  const int sub = threadIdx.x - cl * kLanes;
  const int ch = cb * S::kChannels + cl;
  const int s0 = sub * kSpl;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool live = ch < d_in;
  const long long row0 = static_cast<long long>(b) * T;
  const int n_chunks = (T + kChunk - 1) / kChunk;

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

  for (int k = n_chunks - 1; k >= 0; --k) {
    const int t0 = k * kChunk;
    const int tc = min(kChunk, T - t0);
    const float* hc =
        h_chunks +
        ((static_cast<long long>(b) * n_chunks + k) * d_in + ch) * ds;
    float h0[kSpl], h[kSpl], hs[kChunk][kSpl];
#pragma unroll
    for (int j = 0; j < kSpl; ++j) {
      h0[j] = live && s0 + j < ds ? hc[s0 + j] : 0.f;
      h[j] = h0[j];
    }
    // the chunk's states, as the forward computed them
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) {
      if (tt < tc) {
        const long long at = row0 + t0 + tt;
        const float ut = live ? u[at * d_in + ch] : 0.f;
        const float dtt = live ? dt[at * d_in + ch] : 0.f;
        const float dtu = dtt * ut;
#pragma unroll
        for (int j = 0; j < kSpl; ++j) {
          const float bv = s0 + j < ds ? bmat[at * ds + s0 + j] : 0.f;
          h[j] = fmaf(exp2_approx(dtt * a2[j]), h[j], dtu * bv);
          hs[tt][j] = h[j];
        }
      }
    }
    // the adjoint, last step first
#pragma unroll
    for (int tt = kChunk - 1; tt >= 0; --tt) {
      if (tt < tc) {
        const long long at = row0 + t0 + tt;
        const float ut = live ? u[at * d_in + ch] : 0.f;
        const float dtt = live ? dt[at * d_in + ch] : 0.f;
        const float dyt = live ? dy[at * d_in + ch] : 0.f;
        const float dtu = dtt * ut;
        float gb = 0.f, gha = 0.f, vb[kSpl], vc[kSpl];
#pragma unroll
        for (int j = 0; j < kSpl; ++j) {
          const bool in = s0 + j < ds;
          const float bv = in ? bmat[at * ds + s0 + j] : 0.f;
          const float cv = in ? cmat[at * ds + s0 + j] : 0.f;
          g[j] = fmaf(cv, dyt, g[j]);
          const float hp = tt > 0 ? hs[tt > 0 ? tt - 1 : 0][j] : h0[j];
          const float e = exp2_approx(dtt * a2[j]);
          const float geh = g[j] * e * hp;
          gb = fmaf(g[j], bv, gb);
          gha = fmaf(geh, an[j], gha);
          da[j] = fmaf(geh, dtt, da[j]);
          vb[j] = g[j] * dtu;
          vc[j] = hs[tt][j] * dyt;
          g[j] *= e;
        }
#pragma unroll
        for (int off = 1; off < kLanes; off <<= 1) {
          gb += __shfl_xor_sync(0xffffffffu, gb, off);
          gha += __shfl_xor_sync(0xffffffffu, gha, off);
        }
        if (live && sub == 0) {
          du[at * d_in + ch] = fmaf(dtt, gb, dsk * dyt);
          ddt[at * d_in + ch] = fmaf(ut, gb, gha);
        }
        dd = fmaf(dyt, ut, dd);
        // the warp's channels, joined by a fixed xor tree
#pragma unroll
        for (int j = 0; j < kSpl; ++j) {
#pragma unroll
          for (int off = kLanes; off < 32; off <<= 1) {
            vb[j] += __shfl_xor_sync(0xffffffffu, vb[j], off);
            vc[j] += __shfl_xor_sync(0xffffffffu, vc[j], off);
          }
        }
        if (lane < kLanes) {
#pragma unroll
          for (int j = 0; j < kSpl; ++j) {
            red_b[(warp * kChunk + tt) * DS + s0 + j] = vb[j];
            red_c[(warp * kChunk + tt) * DS + s0 + j] = vc[j];
          }
        }
      }
    }
    __syncthreads();
    // the block's partial of dB and dC at the chunk's steps: warps in order
    for (int i = threadIdx.x; i < tc * ds; i += kThreads) {
      const int tt = i / ds;
      const int s = i - tt * ds;
      float sb = 0.f, sc = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        sb += red_b[(w * kChunk + tt) * DS + s];
        sc += red_c[(w * kChunk + tt) * DS + s];
      }
      const long long at =
          ((static_cast<long long>(cb) * batch + b) * T + t0 + tt) * ds + s;
      part_b[at] = sb;
      part_c[at] = sc;
    }
    __syncthreads();   // red_b and red_c are free for the next chunk
  }
  if (!live) return;
#pragma unroll
  for (int j = 0; j < kSpl; ++j)
    if (s0 + j < ds)
      part_a[(static_cast<long long>(b) * d_in + ch) * ds + s0 + j] = da[j];
  if (sub == 0) part_d[static_cast<long long>(b) * d_in + ch] = dd;
}

// out[i] = sum over s of in[s * len + i], s in order
__global__ void sum_slabs(const float* __restrict__ in, float* __restrict__ out,
                          int n_slabs, long long len) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float acc = 0.f;
  for (int s = 0; s < n_slabs; ++s) acc += in[s * len + i];
  out[i] = acc;
}

cudaError_t sum(const float* in, float* out, int n_slabs, long long len,
                cudaStream_t stream) {
  sum_slabs<<<static_cast<unsigned>((len + 255) / 256), 256, 0, stream>>>(
      in, out, n_slabs, len);
  return cudaGetLastError();
}

template <int DS>
int channel_blocks(int d_in) {
  return (d_in + Shape<DS>::kChannels - 1) / Shape<DS>::kChannels;
}

int blocks_for(int ds, int d_in) {
  if (ds <= 4) return channel_blocks<4>(d_in);
  if (ds <= 8) return channel_blocks<8>(d_in);
  if (ds <= 16) return channel_blocks<16>(d_in);
  if (ds <= 32) return channel_blocks<32>(d_in);
  return channel_blocks<64>(d_in);
}

template <int DS>
cudaError_t launch(const float* u, const float* dt, const float* bmat,
                   const float* cmat, const float* a, const float* d_skip,
                   const float* h_chunks, const float* dy, const float* dh,
                   float* du, float* ddt, float* dbmat, float* dcmat,
                   float* da, float* dd, float* work, int batch, int T,
                   int d_in, int ds, cudaStream_t stream) {
  using S = Shape<DS>;
  auto kernel = scan_bwd<DS>;
  if (S::kSmemBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
    if (err != cudaSuccess) return err;
  }
  const int n_cb = channel_blocks<DS>(d_in);
  const long long bc = static_cast<long long>(batch) * T * ds;
  const long long ad = static_cast<long long>(d_in) * ds;
  float* part_b = work;
  float* part_c = part_b + n_cb * bc;
  float* part_a = part_c + n_cb * bc;
  float* part_d = part_a + batch * ad;
  kernel<<<dim3(n_cb, batch), kThreads, S::kSmemBytes, stream>>>(
      u, dt, bmat, cmat, a, d_skip, h_chunks, dy, dh, du, ddt, part_b, part_c,
      part_a, part_d, batch, T, d_in, ds);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = sum(part_b, dbmat, n_cb, bc, stream);
  if (err == cudaSuccess) err = sum(part_c, dcmat, n_cb, bc, stream);
  if (err == cudaSuccess) err = sum(part_a, da, batch, ad, stream);
  if (err == cudaSuccess) err = sum(part_d, dd, batch, d_in, stream);
  return err;
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Floats of the workspace repro_ssm_scan_bwd takes: the partials of dB and
// dC (one slab a block of channels), of da and dd_skip (one a batch row).
extern "C" long long repro_ssm_scan_bwd_workspace(int batch, int T, int d_in,
                                                  int ds) {
  const long long n_cb = blocks_for(ds, d_in);
  return 2 * n_cb * batch * T * ds +
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
