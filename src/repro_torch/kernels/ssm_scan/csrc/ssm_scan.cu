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
// Bound on the H100: bytes and the exponentials, about level. At the serve
// path's shape (B 4, T 2048, d_in 16384, ds 16) it reads u and dt and
// writes y, 1.6 GB (0.48 ms at 3.35 TB/s), and takes B*T*d_in*ds = 2.1 G
// exponentials (about 0.5 ms at the SFU's 16 per clock per SM).
//
// Design: one thread per (b, channel), with its h[ds] and its row of a in
// registers (ds <= 64; the state width is a template argument rounded up
// to a power of two, the padding lanes held at a = 0 and B = C = 0 so they
// stay 0). A block holds 128 channels of one b. The TPU's sequential grid
// axis over time tiles becomes the in-thread loop over t. Every thread of
// a block reads the same B_t and C_t, so each chunk of 64 time steps of
// them is staged in shared memory and read as a broadcast; u and dt are
// read, and y written, coalesced across the block's channels. Any T and
// d_in are taken (masked tails). expf, not __expf: the recurrence is held
// to the plain version at 2e-5.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kChunk = 64;     // time steps of B_t and C_t staged at once

template <int DS>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                const float* __restrict__ bmat, const float* __restrict__ cmat,
                const float* __restrict__ a, const float* __restrict__ d_skip,
                float* __restrict__ y, float* __restrict__ h_out, int T,
                int d_in, int ds) {
  __shared__ float bs[kChunk][DS];
  __shared__ float cs[kChunk][DS];
  const int b = blockIdx.y;
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  const bool live = ch < d_in;

  float h[DS], av[DS];
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    h[s] = 0.f;
    av[s] = live && s < ds ? a[static_cast<long long>(ch) * ds + s] : 0.f;
  }
  const float dsk = live ? d_skip[ch] : 0.f;
  const long long row0 = static_cast<long long>(b) * T;  // first (b, t) row

  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int tc = min(kChunk, T - t0);
    __syncthreads();  // the previous chunk's reads of bs and cs are done
    for (int idx = threadIdx.x; idx < kChunk * DS; idx += kThreads) {
      const int tt = idx / DS;
      const int s = idx - tt * DS;
      const bool ok = tt < tc && s < ds;
      const long long off = (row0 + t0 + tt) * ds + s;
      bs[tt][s] = ok ? bmat[off] : 0.f;
      cs[tt][s] = ok ? cmat[off] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll 4
    for (int tt = 0; tt < tc; ++tt) {
      const long long off = (row0 + t0 + tt) * d_in + ch;
      const float ut = u[off];
      const float dtt = dt[off];
      const float dtu = dtt * ut;
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < DS; ++s) {
        h[s] = expf(dtt * av[s]) * h[s] + dtu * bs[tt][s];
        acc += h[s] * cs[tt][s];
      }
      y[off] = acc + ut * dsk;
    }
  }
  if (!live) return;
  float* hb = h_out + (static_cast<long long>(b) * d_in + ch) * ds;
#pragma unroll
  for (int s = 0; s < DS; ++s)
    if (s < ds) hb[s] = h[s];
}

template <int DS>
cudaError_t launch(const float* u, const float* dt, const float* bmat,
                   const float* cmat, const float* a, const float* d_skip,
                   float* y, float* h_out, int batch, int T, int d_in, int ds,
                   cudaStream_t stream) {
  const dim3 grid((d_in + kThreads - 1) / kThreads, batch);
  ssm_scan_kernel<DS><<<grid, kThreads, 0, stream>>>(
      u, dt, bmat, cmat, a, d_skip, y, h_out, T, d_in, ds);
  return cudaGetLastError();
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
  const float* pu = static_cast<const float*>(u);
  const float* pdt = static_cast<const float*>(dt);
  const float* pb = static_cast<const float*>(bmat);
  const float* pc = static_cast<const float*>(cmat);
  const float* pa = static_cast<const float*>(a);
  const float* pd = static_cast<const float*>(d_skip);
  float* py = static_cast<float*>(y);
  float* ph = static_cast<float*>(h_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (ds <= 4) {
    err = launch<4>(pu, pdt, pb, pc, pa, pd, py, ph, batch, T, d_in, ds, s);
  } else if (ds <= 8) {
    err = launch<8>(pu, pdt, pb, pc, pa, pd, py, ph, batch, T, d_in, ds, s);
  } else if (ds <= 16) {
    err = launch<16>(pu, pdt, pb, pc, pa, pd, py, ph, batch, T, d_in, ds, s);
  } else if (ds <= 32) {
    err = launch<32>(pu, pdt, pb, pc, pa, pd, py, ph, batch, T, d_in, ds, s);
  } else {
    err = launch<64>(pu, pdt, pb, pc, pa, pd, py, ph, batch, T, d_in, ds, s);
  }
  return static_cast<int>(err);
}
