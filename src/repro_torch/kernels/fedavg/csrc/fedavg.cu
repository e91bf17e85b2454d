// The Steps 2+5 aggregate and the communicate stage's diagnostics of
// BLADE-FL (paper §3.1) for sm_90a.
//
// fedavg_flat replaces the TPU kernel fedavg_flat (body _fedavg_kernel) in
// src/repro/kernels/fedavg/kernel.py: from x [C, N] and normalised weights
// w [C], out[c, n] = sum_k w[k] * x[k, n] (+ noise[c, n]) for every c.
//   Bound on the H100: memory. It reads C*N floats and writes C*N floats and
//   does 2 flops per element read (about half a flop per byte).
//   Design: one thread per column, neighbouring threads on neighbouring
//   columns so every load and store of a warp is one coalesced transaction.
//   The thread walks c = 0..C-1 in a fixed order with one fp32 accumulator,
//   then writes the mean (+ noise) to all C rows, so the mean never goes
//   back to device memory between the reduction and the broadcast.
//
// digest_div_flat replaces the TPU kernel digest_div_flat (body
// _digest_div_kernel) in the same file: one sweep of x [C, N] gives the leaf
// sum (it feeds the model digest) and, per client, sum_n (x[c,n] -
// colmean[n])^2 (the divergence of Definition 1).
//   Bound on the H100: memory, one read of C*N floats.
//   Design: no float atomics. The digest hashes the fp32 bits of the leaf
//   sum, so a summation order that changed from run to run would change the
//   ledger from run to run. Pass 1: each block owns a tile of columns, forms
//   the column means into shared memory while summing the tile, then sweeps
//   the tile again per client (the second sweep is served by L1/L2) and
//   writes its partials to scratch [n_blocks] and [n_blocks, C]. Pass 2: one
//   block reduces the partials in a fixed order. Every reduction is a fixed
//   tree (warp shuffles, then one warp), so the result is the same on every
//   run at the same N.
//
// mix_rows_flat replaces the TPU kernel mix_rows_flat (body _mix_rows_kernel)
// in the same file: out[R, N] = w_rows[R, K] @ x[K, N], fp32, the dense mix
// of a topology whose W is not the full mesh (R = local clients, K = C).
//   Bound on the H100: memory. It reads K*N and writes R*N floats and does
//   2*R*K flops per column (R = K = 20: 5 flops per byte moved, below the
//   fp32 ridge of 67 Tflop/s over 3.35 TB/s = 20).
//   Design: w_rows (R, K <= 64, at most 16 KiB) is staged transposed in
//   shared memory, where all threads of a warp read the same word (a
//   broadcast). One thread per column, neighbouring threads on neighbouring
//   columns, so every load of x and store of out coalesces. The thread holds
//   the accumulators of RB output rows in registers (RB in 8..32, a template
//   argument picked from R, so R = 20 pads to 24 rows, not 32) and walks k =
//   0..K-1 in ascending order, issuing kMixLoads loads of its column before
//   it uses them, so a warp has that many in flight instead of one; for
//   R > 32 it walks its column again per row chunk (the re-reads hit L1).
//   Each term is a rounded product added with a rounded sum (__fmul_rn,
//   __fadd_rn: never contracted into an fma), in the order of the plain
//   version's loop over k, so the kernel gives the plain version's bits on
//   every run, and a run mixes the same on the card as on the CPU.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMixMax = 64;   // largest R and K of mix_rows (ops.MIX_MAX)
constexpr int kMixLoads = 8;  // loads of x a mix_rows thread keeps in flight

// Sum over the block, valid in thread 0. `red` holds 32 floats; the trailing
// barrier lets the caller reuse it at once.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  }
  __syncthreads();
  return v;
}

__global__ void __launch_bounds__(kThreads)
fedavg_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ noise, float* __restrict__ out,
              int n_clients, long long n) {
  const long long col = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (col >= n) return;
  float acc = 0.f;
  for (int c = 0; c < n_clients; ++c) acc = fmaf(w[c], x[c * n + col], acc);
  if (noise != nullptr) {
    for (int c = 0; c < n_clients; ++c) out[c * n + col] = acc + noise[c * n + col];
  } else {
    for (int c = 0; c < n_clients; ++c) out[c * n + col] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
digest_div_partial(const float* __restrict__ x, int n_clients, long long n,
                   int tile, float* __restrict__ part_sum,
                   float* __restrict__ part_res) {
  extern __shared__ float colmean[];  // [tile]
  __shared__ float red[32];
  const long long start = blockIdx.x * static_cast<long long>(tile);
  const int cols = static_cast<int>(min(static_cast<long long>(tile), n - start));
  const float inv_c = 1.f / static_cast<float>(n_clients);
  float tsum = 0.f;
  for (int j = threadIdx.x; j < cols; j += blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < n_clients; ++c) s += x[c * n + start + j];
    colmean[j] = s * inv_c;
    tsum += s;
  }
  tsum = block_sum(tsum, red);  // its barriers also publish colmean
  if (threadIdx.x == 0) part_sum[blockIdx.x] = tsum;
  for (int c = 0; c < n_clients; ++c) {
    const float* row = x + c * n + start;
    float r = 0.f;
    for (int j = threadIdx.x; j < cols; j += blockDim.x) {
      const float d = row[j] - colmean[j];
      r = fmaf(d, d, r);
    }
    r = block_sum(r, red);
    if (threadIdx.x == 0) part_res[blockIdx.x * n_clients + c] = r;
  }
}

__global__ void __launch_bounds__(kThreads)
digest_div_finish(const float* __restrict__ part_sum,
                  const float* __restrict__ part_res, int n_blocks,
                  int n_clients, float* __restrict__ out_sum,
                  float* __restrict__ out_res) {
  __shared__ float red[32];
  for (int q = 0; q <= n_clients; ++q) {
    float v = 0.f;
    for (int b = threadIdx.x; b < n_blocks; b += blockDim.x)
      v += q == 0 ? part_sum[b] : part_res[b * n_clients + (q - 1)];
    v = block_sum(v, red);
    if (threadIdx.x == 0) {
      if (q == 0) {
        *out_sum = v;
      } else {
        out_res[q - 1] = v;
      }
    }
  }
}

// RB: output rows whose accumulators a thread holds in registers at once
// (the launch picks the smallest of 8, 16, 24, 32 that covers R, else 32).
template <int RB>
__global__ void __launch_bounds__(kThreads)
mix_rows_kernel(const float* __restrict__ w, const float* __restrict__ x,
                float* __restrict__ out, int rows, int depth, long long n) {
  // w_rows transposed, ws[k * rpad + r], rows zero-padded to a multiple of RB
  __shared__ float ws[kMixMax * kMixMax];
  const int rpad = (rows + RB - 1) / RB * RB;
  for (int i = threadIdx.x; i < depth * rpad; i += blockDim.x) {
    const int k = i / rpad;
    const int r = i - k * rpad;
    ws[i] = r < rows ? w[r * depth + k] : 0.f;
  }
  __syncthreads();
  const long long col = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (col >= n) return;
  for (int r0 = 0; r0 < rows; r0 += RB) {
    float acc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = 0.f;
    for (int k0 = 0; k0 < depth; k0 += kMixLoads) {
      // issue kMixLoads loads of the column before using any of them
      float xv[kMixLoads];
#pragma unroll
      for (int j = 0; j < kMixLoads; ++j)
        xv[j] = k0 + j < depth ? x[(k0 + j) * n + col] : 0.f;
#pragma unroll
      for (int j = 0; j < kMixLoads; ++j) {
        if (k0 + j < depth) {
          const float* wk = ws + (k0 + j) * rpad + r0;
#pragma unroll
          for (int r = 0; r < RB; ++r)
            acc[r] = __fadd_rn(acc[r], __fmul_rn(wk[r], xv[j]));
        }
      }
    }
    const int nr = min(RB, rows - r0);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < nr) out[(r0 + r) * n + col] = acc[r];
    }
  }
}

template <int RB>
cudaError_t launch_mix_rows(const void* w, const void* x, void* out, int rows,
                            int depth, long long n, cudaStream_t stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  mix_rows_kernel<RB><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const float*>(w), static_cast<const float*>(x),
      static_cast<float*>(out), rows, depth, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, noise (nullable), out: f32 [n_clients, n]; w: f32 [n_clients].
extern "C" int repro_fedavg_flat(const void* x, const void* w, const void* noise,
                                 void* out, int n_clients, long long n,
                                 void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  fedavg_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(noise), static_cast<float*>(out), n_clients, n);
  return static_cast<int>(cudaGetLastError());
}

// x: f32 [n_clients, n]; part_sum: f32 [n_blocks]; part_res: f32
// [n_blocks, n_clients] with n_blocks = ceil(n / tile); out_sum: f32 [1];
// out_res: f32 [n_clients].
extern "C" int repro_digest_div(const void* x, int n_clients, long long n,
                                int tile, void* part_sum, void* part_res,
                                void* out_sum, void* out_res, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_blocks = static_cast<int>((n + tile - 1) / tile);
  digest_div_partial<<<n_blocks, kThreads, sizeof(float) * tile, s>>>(
      static_cast<const float*>(x), n_clients, n, tile,
      static_cast<float*>(part_sum), static_cast<float*>(part_res));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  digest_div_finish<<<1, kThreads, 0, s>>>(
      static_cast<const float*>(part_sum), static_cast<const float*>(part_res),
      n_blocks, n_clients, static_cast<float*>(out_sum),
      static_cast<float*>(out_res));
  return static_cast<int>(cudaGetLastError());
}

// w: f32 [rows, depth]; x: f32 [depth, n]; out: f32 [rows, n]; 1 <= rows,
// depth <= kMixMax (the wrapper checks).
extern "C" int repro_mix_rows(const void* w, const void* x, void* out,
                              int rows, int depth, long long n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (rows <= 8) {
    err = launch_mix_rows<8>(w, x, out, rows, depth, n, s);
  } else if (rows <= 16) {
    err = launch_mix_rows<16>(w, x, out, rows, depth, n, s);
  } else if (rows <= 24) {
    err = launch_mix_rows<24>(w, x, out, rows, depth, n, s);
  } else {
    err = launch_mix_rows<32>(w, x, out, rows, depth, n, s);
  }
  return static_cast<int>(err);
}
