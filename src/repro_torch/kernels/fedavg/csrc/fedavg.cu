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
//   fp32 ridge of 67 Tflop/s over 3.35 TB/s = 20). The exact rounding costs
//   two instructions per term (a rounded product, then a rounded sum): 800
//   at R = K = 20 per column, about 5 us of issue on 132 SMs for the widest
//   leaf, so a design that also pays a shared-memory load per term is bound
//   by instruction issue, not by bytes.
//   Design: four adjacent columns per thread. x is loaded and out stored as
//   float4 (16 B a thread, neighbouring threads on neighbouring addresses).
//   A block owns RB rows of the output (blockIdx.y) and stages its rows of
//   w_rows transposed in shared memory, ws[k][RB], with every load of the
//   stage in flight at once and after the thread's first loads of x, so the
//   two latencies overlap. Each k reads ws as float4 over 4 rows: every
//   lane of a warp reads the same address (a broadcast), and one 16-byte
//   load feeds 16 multiply-adds (4 rows x 4 columns). The thread holds RB x
//   4 accumulators (RB a template argument, a multiple of 4 up to 32: R = 20
//   runs 20 rows, R > 32 splits into equal chunks over blockIdx.y) and walks
//   k = 0..K-1 in ascending order, with the loads of the next KL k in flight
//   while it multiplies the current ones. An input too narrow to fill the
//   card (fewer column groups than 256 per SM, the SM count read from the
//   device) runs RB = 4, its R/4 row chunks side by side, so its few columns
//   spread over many short warps. Blocks of 64 threads spread the one-wave grid evenly
//   (N = 200 704 is 784 blocks, about 6 per SM). The float4 path needs
//   N % 4 == 0 and x and out 16-byte aligned; otherwise the same kernel runs
//   its scalar form (the leaf b2 has N = 10; a view with a storage offset is
//   misaligned), with the same arithmetic. Each term is a rounded product
//   added with a rounded sum (__fmul_rn, __fadd_rn: never contracted into an
//   fma), in the order of the plain version's loop over k, so the kernel
//   gives the plain version's bits on every run, and a run mixes the same
//   on the card as on the CPU.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kMixMax = 64;      // largest R and K of mix_rows (ops.MIX_MAX)
constexpr int kMixThreads = 64;  // threads per mix_rows block
// an input with fewer column groups than this many per SM runs mix_rows in
// 4-row chunks
constexpr long long kMixWidePerSm = 256;

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

// The four columns [c0, c0 + 4) of row `row` of x, zero past n. VEC: one
// aligned float4 load (n % 4 == 0, so the group is whole).
template <bool VEC>
__device__ __forceinline__ float4 load_cols(const float* __restrict__ x,
                                            long long row, long long n,
                                            long long c0) {
  const float* p = x + row * n + c0;
  if (VEC) return __ldg(reinterpret_cast<const float4*>(p));
  float4 v;
  v.x = __ldg(p);
  v.y = c0 + 1 < n ? __ldg(p + 1) : 0.f;
  v.z = c0 + 2 < n ? __ldg(p + 2) : 0.f;
  v.w = c0 + 3 < n ? __ldg(p + 3) : 0.f;
  return v;
}

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// acc[e] += w * x[e], each product and sum rounded on its own
__device__ __forceinline__ void mul_add4(float* acc, float w, float4 x) {
  acc[0] = __fadd_rn(acc[0], __fmul_rn(w, x.x));
  acc[1] = __fadd_rn(acc[1], __fmul_rn(w, x.y));
  acc[2] = __fadd_rn(acc[2], __fmul_rn(w, x.z));
  acc[3] = __fadd_rn(acc[3], __fmul_rn(w, x.w));
}

// RB: output rows whose accumulators a thread holds (a multiple of 4, at
// most 32): rows [RB * blockIdx.y, RB * blockIdx.y + RB). VEC: the float4
// path.
template <int RB, bool VEC>
__global__ void __launch_bounds__(kMixThreads, RB <= 24 ? 6 : 4)
mix_rows_kernel(const float* __restrict__ w, const float* __restrict__ x,
                float* __restrict__ out, int rows, int depth, long long n) {
  constexpr int KL = RB <= 8 ? 8 : 4;   // k loaded ahead of the multiply
  constexpr int kStage = kMixMax * RB / kMixThreads;
  // this block's rows of w_rows transposed, ws[k * RB + r], zero past R
  __shared__ __align__(16) float ws[kMixMax * RB];
  const int r0 = RB * blockIdx.y;
  const long long c0 =
      4 * (blockIdx.x * static_cast<long long>(kMixThreads) + threadIdx.x);
  const bool active = c0 < n;
  // the first loads of x go out before w_rows is staged: the two overlap
  float4 cur[KL], next[KL];
#pragma unroll
  for (int j = 0; j < KL; ++j)
    cur[j] = active && j < depth ? load_cols<VEC>(x, j, n, c0) : zero4();
  {
    float v[kStage];   // every load of the stage in flight at once
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int i = threadIdx.x + u * kMixThreads;
      const int k = i / RB;
      const int r = r0 + i - k * RB;
      v[u] = k < depth && r < rows ? w[r * depth + k] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) ws[threadIdx.x + u * kMixThreads] = v[u];
  }
  __syncthreads();
  if (!active) return;
  float acc[RB][4];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
  for (int k0 = 0; k0 < depth; k0 += KL) {
    // the next KL k go out before this chunk's multiplies
#pragma unroll
    for (int j = 0; j < KL; ++j) {
      const int k = k0 + KL + j;
      next[j] = k < depth ? load_cols<VEC>(x, k, n, c0) : zero4();
    }
#pragma unroll
    for (int j = 0; j < KL; ++j) {
      if (k0 + j < depth) {
        const float* wk = ws + (k0 + j) * RB;
#pragma unroll
        for (int r = 0; r < RB; r += 4) {
          const float4 w4 = *reinterpret_cast<const float4*>(wk + r);
          mul_add4(acc[r], w4.x, cur[j]);
          mul_add4(acc[r + 1], w4.y, cur[j]);
          mul_add4(acc[r + 2], w4.z, cur[j]);
          mul_add4(acc[r + 3], w4.w, cur[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < KL; ++j) cur[j] = next[j];
  }
  const int nr = min(RB, rows - r0);
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (r < nr) {
      float* o = out + (r0 + r) * n + c0;
      if (VEC) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c0 + e < n) o[e] = acc[r][e];
      }
    }
  }
}

template <int RB>
cudaError_t launch_mix_rows(const float* w, const float* x, float* out,
                            int rows, int depth, long long n,
                            cudaStream_t stream) {
  const long long groups = (n + 3) / 4;
  const dim3 blocks(
      static_cast<unsigned>((groups + kMixThreads - 1) / kMixThreads),
      (rows + RB - 1) / RB);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    mix_rows_kernel<RB, true><<<blocks, kMixThreads, 0, stream>>>(
        w, x, out, rows, depth, n);
  } else {
    mix_rows_kernel<RB, false><<<blocks, kMixThreads, 0, stream>>>(
        w, x, out, rows, depth, n);
  }
  return cudaGetLastError();
}

// Rows a mix_rows thread holds: for a narrow input (fewer than
// kMixWidePerSm column groups per SM of the card, `sms`) 4, so the row
// chunks run side by side; else the fewest chunks of at most 32 rows, each
// rounded up to a multiple of 4 (R = 20 runs 20 rows).
int mix_rows_block(int rows, long long n, int sms) {
  if ((n + 3) / 4 < kMixWidePerSm * sms) return 4;
  const int chunks = (rows + 31) / 32;
  return ((rows + chunks - 1) / chunks + 3) / 4 * 4;
}

cudaError_t launch_mix_rows_rb(int rb, const float* w, const float* x,
                               float* out, int rows, int depth, long long n,
                               cudaStream_t s) {
  switch (rb) {
    case 4: return launch_mix_rows<4>(w, x, out, rows, depth, n, s);
    case 8: return launch_mix_rows<8>(w, x, out, rows, depth, n, s);
    case 12: return launch_mix_rows<12>(w, x, out, rows, depth, n, s);
    case 16: return launch_mix_rows<16>(w, x, out, rows, depth, n, s);
    case 20: return launch_mix_rows<20>(w, x, out, rows, depth, n, s);
    case 24: return launch_mix_rows<24>(w, x, out, rows, depth, n, s);
    case 28: return launch_mix_rows<28>(w, x, out, rows, depth, n, s);
    default: return launch_mix_rows<32>(w, x, out, rows, depth, n, s);
  }
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
// depth <= kMixMax (the wrapper checks). The SM count of the current device
// is read on its first call and kept.
extern "C" int repro_mix_rows(const void* w, const void* x, void* out,
                              int rows, int depth, long long n, void* stream) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> sm_counts[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int sms = sm_counts[dev].load(std::memory_order_relaxed);
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    sm_counts[dev].store(sms, std::memory_order_relaxed);
  }
  return static_cast<int>(launch_mix_rows_rb(
      mix_rows_block(rows, n, sms), static_cast<const float*>(w),
      static_cast<const float*>(x), static_cast<float*>(out), rows, depth, n,
      static_cast<cudaStream_t>(stream)));
}
