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
//   Design: one read of x from device memory and one launch. No float
//   atomics: the digest hashes the fp32 bits of the leaf sum, so a
//   summation order that changed from run to run would change the ledger
//   from run to run; every sum below runs in a fixed order, so the same
//   shape on the same card gives the same bits on every run.
//   - C <= kDigestMaxC (the register form, C a template bucket of 4): a
//     thread holds its four columns' C values in registers (float4 loads
//     when N % 4 == 0 and x is 16-byte aligned, else scalar loads and a
//     zero tail), sums each column in ascending c, takes the mean as s / C
//     (as the plain and JAX versions do), then adds each client's
//     (x - mean)^2 into one of C registers: never the cancelling
//     sum x^2 - C m^2. The grid is one wave of the card (the SM count and
//     the kernel's occupancy read from the device), a grid-stride loop
//     beyond it; a leaf of a few columns runs one block.
//   - Larger C (the slab form): a block stages a [C, tile] slab of x in
//     shared memory (tile sized to 47 KB), forms the column means from it,
//     and its warps sweep one client each over the slab. Above C = 12 031
//     not one column fits, and the same form reads x again from L2
//     instead of the slab.
//   Each block reduces its C + 1 values at once (the shuffle trees of all
//   of them side by side, one shared [warps][C + 1] table, one barrier). A
//   launch of one block (a narrow leaf) writes them out and is done. Else
//   they go to a row of the partials [blocks, C + 1], and the last block
//   to finish, found with an integer ticket taken after __threadfence,
//   reduces the partials in block order, eight outputs a warp at once, and
//   resets the ticket to 0 for the next launch. That assumes launches that
//   share a ticket never overlap: the wrapper keeps one ticket per stream,
//   and a stream runs its kernels one after another.
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
//   while it multiplies the current ones. The stage holds 64 k of the
//   block's rows; a larger K restages it between chunks of 64 (a barrier
//   either side) while the k loop runs on across them, so any R and K run
//   with the same order of sums. An input too narrow to fill the
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
constexpr int kMixMax = 64;      // k of w_rows a mix_rows block stages at once
constexpr int kMixThreads = 64;  // threads per mix_rows block
// an input with fewer column groups than this many per SM runs mix_rows in
// 4-row chunks
constexpr long long kMixWidePerSm = 256;
constexpr int kDigestThreads = 128;  // register form
constexpr int kDigestMaxC = 32;      // largest C of the register form
constexpr int kSlabThreads = 256;    // slab form
constexpr int kSlabMaxTile = 256;    // columns of a slab, at most
// dynamic shared memory of a slab block: 47 KB, so that with its static
// shared memory it stays under the 48 KB a launch takes without opt-in
constexpr int kSlabBytes = 47 * 1024;
constexpr int kMaxDevices = 64;

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// Output q of this block (q = 0: the leaf sum; q = c + 1: client c's
// residual). A one-block launch writes it straight to the outputs; any other
// writes its row of part [gridDim.x, nq] and makes the store visible to the
// block that finishes the launch.
__device__ __forceinline__ void digest_store(int q, float v, int nq,
                                             float* part,
                                             float* __restrict__ out_sum,
                                             float* __restrict__ out_res) {
  if (gridDim.x == 1) {
    if (q == 0) {
      *out_sum = v;
    } else {
      out_res[q - 1] = v;
    }
  } else {
    part[static_cast<long long>(blockIdx.x) * nq + q] = v;
    __threadfence();
  }
}

// The end of a digest_div launch of several blocks, after every block has
// stored its row (digest_store): the last block to take a ticket sums the
// rows in block order, each warp eight outputs at a time (lane-strided
// sums, then shuffle trees), writes out_sum and out_res, and resets the
// ticket for the next launch.
__device__ __forceinline__ void digest_finish(const float* part, int nq,
                                              unsigned* ticket,
                                              float* __restrict__ out_sum,
                                              float* __restrict__ out_res) {
  constexpr int kPerWarp = 8;
  __shared__ bool last;
  if (gridDim.x == 1) return;
  __syncthreads();  // every store of this block's row is fenced
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int blocks = static_cast<int>(gridDim.x);
  for (int q0 = warp * kPerWarp; q0 < nq; q0 += warps * kPerWarp) {
    float v[kPerWarp];
#pragma unroll
    for (int k = 0; k < kPerWarp; ++k) v[k] = 0.f;
#pragma unroll 2
    for (int b = lane; b < blocks; b += 32) {
      const float* row = part + static_cast<long long>(b) * nq;
#pragma unroll
      for (int k = 0; k < kPerWarp; ++k)
        if (q0 + k < nq) v[k] += __ldcg(row + q0 + k);
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
#pragma unroll
      for (int k = 0; k < kPerWarp; ++k)
        v[k] += __shfl_xor_sync(0xffffffffu, v[k], s);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kPerWarp; ++k) {
        const int q = q0 + k;
        if (q == 0) {
          *out_sum = v[k];
        } else if (q < nq) {
          out_res[q - 1] = v[k];
        }
      }
    }
  }
  if (threadIdx.x == 0) atomicExch(ticket, 0u);
}

// Register form, C <= CB (a multiple of 4 up to kDigestMaxC). VEC: float4
// loads.
template <int CB, bool VEC>
__global__ void __launch_bounds__(kDigestThreads)
digest_div_reg(const float* __restrict__ x, int n_clients, long long n,
               float* part, unsigned* ticket, float* __restrict__ out_sum,
               float* __restrict__ out_res) {
  __shared__ float red[kDigestThreads / 32][CB + 1];
  const float fc = static_cast<float>(n_clients);
  const long long groups = (n + 3) / 4;
  float tsum = 0.f;
  float res[CB];
#pragma unroll
  for (int c = 0; c < CB; ++c) res[c] = 0.f;
  for (long long g = blockIdx.x * static_cast<long long>(kDigestThreads) +
                     threadIdx.x;
       g < groups; g += static_cast<long long>(gridDim.x) * kDigestThreads) {
    float4 v[CB];
#pragma unroll
    for (int c = 0; c < CB; ++c)
      v[c] = c < n_clients ? load_cols<VEC>(x, c, n, 4 * g) : zero4();
    float4 s = zero4();
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      if (c < n_clients) {
        s.x += v[c].x;
        s.y += v[c].y;
        s.z += v[c].z;
        s.w += v[c].w;
      }
    }
    tsum += s.x;
    tsum += s.y;
    tsum += s.z;
    tsum += s.w;
    const float4 m = make_float4(s.x / fc, s.y / fc, s.z / fc, s.w / fc);
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      if (c < n_clients) {
        float d = v[c].x - m.x;
        float r = d * d;
        d = v[c].y - m.y;
        r = fmaf(d, d, r);
        d = v[c].z - m.z;
        r = fmaf(d, d, r);
        d = v[c].w - m.w;
        r = fmaf(d, d, r);
        res[c] += r;
      }
    }
  }
  // the block's C + 1 sums at once: the shuffle trees of all of them side
  // by side (res[c] is 0 past C), one table, one barrier
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    tsum += __shfl_xor_sync(0xffffffffu, tsum, s);
#pragma unroll
    for (int c = 0; c < CB; ++c)
      res[c] += __shfl_xor_sync(0xffffffffu, res[c], s);
  }
  if (lane == 0) {
    red[warp][0] = tsum;
#pragma unroll
    for (int c = 0; c < CB; ++c) red[warp][c + 1] = res[c];
  }
  __syncthreads();
  const int nq = n_clients + 1;
  if (threadIdx.x < nq) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kDigestThreads / 32; ++w) v += red[w][threadIdx.x];
    digest_store(threadIdx.x, v, nq, part, out_sum, out_res);
  }
  digest_finish(part, nq, ticket, out_sum, out_res);
}

// Slab form, any C: a block owns columns [blockIdx.x * tile, + tile).
// STAGED: the block's [C, tile] slab of x sits in shared memory, so x is
// read from device memory once; else (a slab of even one column would not
// fit: C > 12 031) the block reads its columns of x twice, the second time
// from L2.
template <bool STAGED>
__global__ void __launch_bounds__(kSlabThreads)
digest_div_slab(const float* __restrict__ x, int n_clients, long long n,
                int tile, float* part, unsigned* ticket,
                float* __restrict__ out_sum, float* __restrict__ out_res) {
  extern __shared__ float slab[];  // STAGED: [C][tile]; then the means [tile]
  __shared__ float red[kSlabThreads / 32];
  float* mean = STAGED ? slab + n_clients * tile : slab;
  const long long start = blockIdx.x * static_cast<long long>(tile);
  const int cols =
      static_cast<int>(min(static_cast<long long>(tile), n - start));
  const float* xs = x + start;
  auto at = [&](int c, int j) {
    return STAGED ? slab[c * tile + j] : xs[c * n + j];
  };
  if (STAGED) {
    for (int i = threadIdx.x; i < n_clients * cols; i += kSlabThreads) {
      const int c = i / cols;
      const int j = i - c * cols;
      slab[c * tile + j] = xs[c * n + j];
    }
    __syncthreads();
  }
  const float fc = static_cast<float>(n_clients);
  float tsum = 0.f;
  for (int j = threadIdx.x; j < cols; j += kSlabThreads) {
    float s = 0.f;
    for (int c = 0; c < n_clients; ++c) s += at(c, j);
    mean[j] = s / fc;
    tsum += s;
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  tsum = warp_sum(tsum);
  if (lane == 0) red[warp] = tsum;
  __syncthreads();  // also publishes the means
  const int nq = n_clients + 1;
  for (int c = warp; c < n_clients; c += kSlabThreads / 32) {
    float r = 0.f;
    for (int j = lane; j < cols; j += 32) {
      const float d = at(c, j) - mean[j];
      r = fmaf(d, d, r);
    }
    r = warp_sum(r);
    if (lane == 0) digest_store(c + 1, r, nq, part, out_sum, out_res);
  }
  if (threadIdx.x == 0) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kSlabThreads / 32; ++w) v += red[w];
    digest_store(0, v, nq, part, out_sum, out_res);
  }
  digest_finish(part, nq, ticket, out_sum, out_res);
}

// Columns of a staged slab-form block for C clients, so that the slab and
// the means fit in kSlabBytes; 0 when not even one column fits.
int slab_tile(int n_clients) {
  const int fit = kSlabBytes / 4 / (n_clients + 1);
  return fit < kSlabMaxTile ? fit : kSlabMaxTile;
}

// The SM count of the current device, read once per device; `dev` set.
cudaError_t device_sms(int* dev, int* sms) {
  static std::atomic<int> counts[kMaxDevices];
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev >= kMaxDevices) return cudaErrorInvalidDevice;
  *sms = counts[*dev].load(std::memory_order_relaxed);
  if (*sms == 0) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *dev);
    if (err != cudaSuccess) return err;
    counts[*dev].store(*sms, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

// Blocks of a register-form launch: one per kDigestThreads column groups,
// at most one wave of the card (its occupancy read once per device).
template <int CB, bool VEC>
cudaError_t digest_reg_blocks(long long n, int* blocks) {
  static std::atomic<int> per_sm[kMaxDevices];
  int dev = 0, sms = 0;
  cudaError_t err = device_sms(&dev, &sms);
  if (err != cudaSuccess) return err;
  int occ = per_sm[dev].load(std::memory_order_relaxed);
  if (occ == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, digest_div_reg<CB, VEC>, kDigestThreads, 0);
    if (err != cudaSuccess) return err;
    occ = occ < 1 ? 1 : occ;
    per_sm[dev].store(occ, std::memory_order_relaxed);
  }
  const long long need = ((n + 3) / 4 + kDigestThreads - 1) / kDigestThreads;
  const long long wave = static_cast<long long>(occ) * sms;
  *blocks = static_cast<int>(need < wave ? need : wave);
  return cudaSuccess;
}

// Blocks of a digest_div launch at (C, n, VEC); with `launch`, also launch
// it (x, part [blocks, C + 1], ticket, outputs).
template <int CB>
cudaError_t digest_reg(bool vec, bool launch, const float* x, int n_clients,
                       long long n, float* part, unsigned* ticket,
                       float* out_sum, float* out_res, int* blocks,
                       cudaStream_t s) {
  cudaError_t err = vec ? digest_reg_blocks<CB, true>(n, blocks)
                        : digest_reg_blocks<CB, false>(n, blocks);
  if (err != cudaSuccess || !launch) return err;
  if (vec) {
    digest_div_reg<CB, true><<<*blocks, kDigestThreads, 0, s>>>(
        x, n_clients, n, part, ticket, out_sum, out_res);
  } else {
    digest_div_reg<CB, false><<<*blocks, kDigestThreads, 0, s>>>(
        x, n_clients, n, part, ticket, out_sum, out_res);
  }
  return cudaGetLastError();
}

cudaError_t digest_div(bool launch, const float* x, int n_clients,
                       long long n, float* part, unsigned* ticket,
                       float* out_sum, float* out_res, int* blocks,
                       cudaStream_t s) {
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  switch ((n_clients + 3) / 4) {
    case 1: return digest_reg<4>(vec, launch, x, n_clients, n, part, ticket,
                                 out_sum, out_res, blocks, s);
    case 2: return digest_reg<8>(vec, launch, x, n_clients, n, part, ticket,
                                 out_sum, out_res, blocks, s);
    case 3: return digest_reg<12>(vec, launch, x, n_clients, n, part,
                                  ticket, out_sum, out_res, blocks, s);
    case 4: return digest_reg<16>(vec, launch, x, n_clients, n, part,
                                  ticket, out_sum, out_res, blocks, s);
    case 5: return digest_reg<20>(vec, launch, x, n_clients, n, part,
                                  ticket, out_sum, out_res, blocks, s);
    case 6: return digest_reg<24>(vec, launch, x, n_clients, n, part,
                                  ticket, out_sum, out_res, blocks, s);
    case 7: return digest_reg<28>(vec, launch, x, n_clients, n, part,
                                  ticket, out_sum, out_res, blocks, s);
    case 8: return digest_reg<32>(vec, launch, x, n_clients, n, part,
                                  ticket, out_sum, out_res, blocks, s);
    default: break;
  }
  const int fit = slab_tile(n_clients);
  const int tile = fit > 0 ? fit : kSlabMaxTile;
  *blocks = static_cast<int>((n + tile - 1) / tile);
  if (!launch) return cudaSuccess;
  if (fit > 0) {
    const size_t smem = sizeof(float) * (static_cast<size_t>(n_clients) + 1) *
                        static_cast<size_t>(tile);
    digest_div_slab<true><<<*blocks, kSlabThreads, smem, s>>>(
        x, n_clients, n, tile, part, ticket, out_sum, out_res);
  } else {
    digest_div_slab<false><<<*blocks, kSlabThreads, sizeof(float) * tile,
                             s>>>(x, n_clients, n, tile, part, ticket,
                                  out_sum, out_res);
  }
  return cudaGetLastError();
}

// Stage rows [r0, r0 + RB) of w_rows, at k in [kc, kc + kMixMax),
// transposed into ws[(k - kc) * RB + r], zero past R and past K: every load
// in flight at once, then the stores. WIDE: R x K may pass 2^31, so the
// offsets are 64-bit.
template <int RB, bool WIDE>
__device__ __forceinline__ void stage_w(const float* __restrict__ w,
                                        float* ws, int r0, int rows,
                                        int depth, int kc) {
  constexpr int kStage = kMixMax * RB / kMixThreads;
  float v[kStage];
#pragma unroll
  for (int u = 0; u < kStage; ++u) {
    const int i = threadIdx.x + u * kMixThreads;
    const int k = kc + i / RB;
    const int r = r0 + i - (i / RB) * RB;
    v[u] = k < depth && r < rows
               ? w[WIDE ? static_cast<long long>(r) * depth + k
                        : r * depth + k] : 0.f;
  }
#pragma unroll
  for (int u = 0; u < kStage; ++u) ws[threadIdx.x + u * kMixThreads] = v[u];
}

// RB: output rows whose accumulators a thread holds (a multiple of 4, at
// most 32): rows [RB * blockIdx.y, RB * blockIdx.y + RB). VEC: the float4
// path. CHUNKED: K > kMixMax, so ws holds kMixMax k of the block's rows at
// a time, restaged between chunks while the k loop runs on in ascending
// order across them (the sums keep the plain version's order). Without
// CHUNKED the kernel has no barrier in its k loop and no thread past N
// stays: the restaging, kept out of that form, cost the K = 20 mix 16 %.
template <int RB, bool VEC, bool CHUNKED>
__global__ void __launch_bounds__(kMixThreads, RB <= 24 ? 6 : 4)
mix_rows_kernel(const float* __restrict__ w, const float* __restrict__ x,
                float* __restrict__ out, int rows, int depth, long long n) {
  constexpr int KL = RB <= 8 ? 8 : 4;   // k loaded ahead of the multiply
  static_assert(kMixMax % KL == 0, "a chunk of k ends on a load group");
  // this block's rows of w_rows for one chunk of k, transposed
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
  stage_w<RB, CHUNKED>(w, ws, r0, rows, depth, 0);
  __syncthreads();
  // with one chunk no barrier follows, so a thread past N may leave; with
  // more it stays for the restaging barriers and multiplies zeros
  if (!CHUNKED && !active) return;
  float acc[RB][4];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
  for (int k0 = 0; k0 < depth; k0 += KL) {
    const int kk = CHUNKED ? k0 % kMixMax : k0;   // k0's place in ws
    if (CHUNKED && kk == 0 && k0 > 0) {   // the next chunk (uniform)
      __syncthreads();
      stage_w<RB, CHUNKED>(w, ws, r0, rows, depth, k0);
      __syncthreads();
    }
    // the next KL k go out before this chunk's multiplies
#pragma unroll
    for (int j = 0; j < KL; ++j) {
      const int k = k0 + KL + j;
      next[j] = (!CHUNKED || active) && k < depth
                    ? load_cols<VEC>(x, k, n, c0) : zero4();
    }
#pragma unroll
    for (int j = 0; j < KL; ++j) {
      if (k0 + j < depth) {
        const float* wk = ws + (kk + j) * RB;
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
  if (CHUNKED && !active) return;
  const int nr = min(RB, rows - r0);
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (r < nr) {
      float* o = out + static_cast<long long>(r0 + r) * n + c0;
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
  const bool chunked = depth > kMixMax;
  if (vec && chunked) {
    mix_rows_kernel<RB, true, true><<<blocks, kMixThreads, 0, stream>>>(
        w, x, out, rows, depth, n);
  } else if (vec) {
    mix_rows_kernel<RB, true, false><<<blocks, kMixThreads, 0, stream>>>(
        w, x, out, rows, depth, n);
  } else if (chunked) {
    mix_rows_kernel<RB, false, true><<<blocks, kMixThreads, 0, stream>>>(
        w, x, out, rows, depth, n);
  } else {
    mix_rows_kernel<RB, false, false><<<blocks, kMixThreads, 0, stream>>>(
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

// Rows of the partials a digest_div launch at (n_clients, n) for x needs:
// its block count (>= 1), or minus a CUDA error.
extern "C" long long repro_digest_div_blocks(const void* x, int n_clients,
                                             long long n) {
  int blocks = 0;
  const cudaError_t err =
      digest_div(false, static_cast<const float*>(x), n_clients, n, nullptr,
                 nullptr, nullptr, nullptr, &blocks, nullptr);
  return err == cudaSuccess ? blocks : -static_cast<long long>(err);
}

// x: f32 [n_clients, n]; part: f32 [repro_digest_div_blocks(x, n_clients,
// n), n_clients + 1]; ticket: one uint32, 0 before the launch and 0 again
// after it (the launch resets it), used by no launch that may overlap this
// one; out_sum: f32 [1]; out_res: f32 [n_clients]. One launch.
extern "C" int repro_digest_div(const void* x, int n_clients, long long n,
                                void* part, void* ticket, void* out_sum,
                                void* out_res, void* stream) {
  int blocks = 0;
  return static_cast<int>(digest_div(
      true, static_cast<const float*>(x), n_clients, n,
      static_cast<float*>(part), static_cast<unsigned*>(ticket),
      static_cast<float*>(out_sum), static_cast<float*>(out_res), &blocks,
      static_cast<cudaStream_t>(stream)));
}

// w: f32 [rows, depth]; x: f32 [depth, n]; out: f32 [rows, n]; rows >= 1,
// depth >= 1, and rows of at most 65 535 row blocks (blockIdx.y), of 4 rows
// at the narrowest: rows <= 262 140 (the wrapper checks). The SM count of
// the current device is read on its first call and kept.
extern "C" int repro_mix_rows(const void* w, const void* x, void* out,
                              int rows, int depth, long long n, void* stream) {
  int dev = 0, sms = 0;
  const cudaError_t err = device_sms(&dev, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_mix_rows_rb(
      mix_rows_block(rows, n, sms), static_cast<const float*>(w),
      static_cast<const float*>(x), static_cast<float*>(out), rows, depth, n,
      static_cast<cudaStream_t>(stream)));
}
