// Blocked (flash) attention backward for sm_90a: the gradient of the
// forward in flash_attention.cu, for training the LM zoo's attention layers.
//
// No TPU kernel corresponds: the JAX package differentiates its attention
// through XLA, and its Pallas kernel (src/repro/kernels/flash_attention/
// kernel.py, flash_attention) has no custom_vjp. This is the gradient of
// what that kernel computes, in the FlashAttention-2 form: the
// probabilities are recomputed from the forward's row logsumexp (lse), never
// stored. With dO the output's cotangent and D_i = sum_d dO_i O_i:
//   P = exp(scale Q K^T - lse)  (0 where the mask drops a pair)
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - D),
//   dK = scale dS^T Q,  dQ = scale dS K.
// The masks are the forward's: causal (cols <= rows), under it the prefix-LM
// square (rows and cols both below prefix_len), the window (cols > rows -
// window), and the ragged tail (cols, rows < seq). fp32 only.
//
// Bound on the H100: operations. Per kept (row, key) pair the two passes
// below do 7 D fused multiply-adds (S and dP twice, dV, dK, dQ): about 10 D
// flops of the algorithm's own (S, dP, dV, dK, dQ at 2 D each) on the fp32
// pipe at 67 Tflop/s. At phi4-mini's training shape (B 2, H 24, S 512,
// D 128, causal) 6.3 M pairs, 8.1 Gflop, 0.12 ms.
//
// Design (simple and deterministic first; tensor cores, wgmma and TMA are
// later work). Three launches on the caller's stream, no atomics, every sum
// in a fixed order, so two calls give the same bits:
// 1. delta: D_i, one warp a row, each lane's columns summed in ascending
//    order and the lanes joined by a fixed xor tree.
// 2. dK/dV, kv-tile-major: a block owns a 32-key tile of one kv head and
//    walks the rep = H / Hkv query heads of its group in order, and for each
//    the 32-row q tiles that the mask's band reaches, in order. dK and dV
//    stay in registers and are written once, at Hkv heads: GQA needs
//    neither a repeat nor atomics.
// 3. dQ, q-tile-major: a block owns a 32-row tile of one query head and
//    walks the kv tiles in the band, in order.
// Both passes share one tile step: Q, dO (32 rows) and K, V (32 keys) are
// staged in shared memory as fp32 rows of dim + 1 floats (an odd stride, so
// the lanes of a warp, which read 32 keys at one column, hit 32 banks);
// warp w computes S and dP for rows w + 8 r (r < 4), lane j for key j, with
// fp32 FMAs over D; P and dS go to shared memory. The accumulations then
// give warp w the keys (pass 2) or rows (pass 3) w + 8 r and lane l the
// columns l + 32 c: P and dS are broadcast reads, dO, Q and K rows are read
// along a row. Tiles wholly outside the band are skipped, as in the
// forward; within a tile every pair is masked by the same test. At D 256 a
// block stages 140 KB (one block an SM), at D 128 74 KB.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 32;                 // rows of a q tile, keys of a kv tile
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = kB / kWarps;     // rows (or keys) a warp owns

// element strides of the batch, sequence and head axes (head_dim stride 1)
struct Strides {
  long long b, s, h;
};

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  const float* lse;   // [batch, n_heads, seq]
  float* delta;       // [batch, n_heads, seq]
  float* dq;
  float* dk;
  float* dv;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int n_heads, rep, seq, dim, causal, window, prefix;
  float scale;
};

// D_i = sum_d dO_i O_i for every (batch, head, row): one warp a row
__global__ void __launch_bounds__(kThreads)
delta_kernel(Args p, long long rows) {
  const long long r =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long bh = r / p.seq;
  const int i = static_cast<int>(r - bh * p.seq);
  const int b = static_cast<int>(bh / p.n_heads);
  const int h = static_cast<int>(bh - static_cast<long long>(b) * p.n_heads);
  const float* orow = p.o + b * p.so.b + h * p.so.h + i * p.so.s;
  const float* drow = p.dout + b * p.sdo.b + h * p.sdo.h + i * p.sdo.s;
  float acc = 0.f;
  for (int d = lane; d < p.dim; d += 32) acc = fmaf(drow[d], orow[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[r] = acc;
}

// rows [row0, row0 + kB) of one head into dst (row stride sd floats); rows
// at or past seq are zero
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      long long row_stride, int row0, int seq,
                                      int dim, int sd) {
  for (int e = threadIdx.x; e < kB * dim; e += kThreads) {
    const int r = e / dim;
    const int c = e - r * dim;
    const int row = row0 + r;
    dst[r * sd + c] = row < seq ? src[row * row_stride + c] : 0.f;
  }
}

// lse and delta of the q tile's rows (0 past seq)
__device__ __forceinline__ void stage_rows(float* lse_s, float* delta_s,
                                           const Args& p, int b, int h,
                                           int q0) {
  if (threadIdx.x < kB) {
    const int row = q0 + threadIdx.x;
    const long long at =
        (static_cast<long long>(b) * p.n_heads + h) * p.seq + row;
    lse_s[threadIdx.x] = row < p.seq ? p.lse[at] : 0.f;
    delta_s[threadIdx.x] = row < p.seq ? p.delta[at] : 0.f;
  }
}

// P and dS of the tile pair (q rows q0 + [0, kB), keys k0 + [0, kB)) into
// ps and dss ([kB][kB], row-major by query row)
__device__ __forceinline__ void tile_p_ds(const float* qs, const float* dos,
                                          const float* ks, const float* vs,
                                          const float* lse_s,
                                          const float* delta_s, float* ps,
                                          float* dss, const Args& p, int q0,
                                          int k0, int sd) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float s[kRows], dp[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
  const float* kr = ks + lane * sd;
  const float* vr = vs + lane * sd;
  for (int d = 0; d < p.dim; ++d) {
    const float kd = kr[d];
    const float vd = vr[d];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = warp + kWarps * r;
      s[r] = fmaf(qs[i * sd + d], kd, s[r]);
      dp[r] = fmaf(dos[i * sd + d], vd, dp[r]);
    }
  }
  const int col = k0 + lane;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = warp + kWarps * r;
    const int row = q0 + i;
    bool ok = row < p.seq && col < p.seq;
    if (p.causal)
      ok = ok && (col <= row || (row < p.prefix && col < p.prefix));
    if (p.window > 0) ok = ok && col > row - p.window;
    const float pv = ok ? expf(s[r] * p.scale - lse_s[i]) : 0.f;
    ps[i * kB + lane] = pv;
    dss[i * kB + lane] = pv * (dp[r] - delta_s[i]);
  }
}

// shared memory of both passes: Q, dO, K, V tiles, P, dS, lse, delta
size_t smem_bytes(int dim) {
  return sizeof(float) * (4 * kB * (dim + 1) + 2 * kB * kB + 2 * kB);
}

// NCOL: 32-column groups a lane covers (ceil(dim / 32), bucketed)
template <int NCOL>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(Args p) {
  extern __shared__ float smem[];
  const int sd = p.dim + 1;
  float* qs = smem;
  float* dos = qs + kB * sd;
  float* ks = dos + kB * sd;
  float* vs = ks + kB * sd;
  float* ps = vs + kB * sd;
  float* dss = ps + kB * kB;
  float* lse_s = dss + kB * kB;
  float* delta_s = lse_s + kB;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_kv = p.n_heads / p.rep;
  const int b = blockIdx.y / n_kv;
  const int hk = blockIdx.y - b * n_kv;
  const int k0 = blockIdx.x * kB;

  stage(ks, p.k + b * p.sk.b + hk * p.sk.h, p.sk.s, k0, p.seq, p.dim, sd);
  stage(vs, p.v + b * p.sv.b + hk * p.sv.h, p.sv.s, k0, p.seq, p.dim, sd);

  // the q rows that can see a key of this tile: under causal rows >= k0
  // (every row when the tile starts inside the prefix); under a window rows
  // < last key + window
  const int q_lo = p.causal && k0 >= p.prefix ? k0 : 0;
  const int q_hi = p.window > 0 ? min(p.seq, k0 + kB - 1 + p.window) : p.seq;
  const int t_begin = q_lo / kB;
  const int t_end = (q_hi + kB - 1) / kB;

  float dk[kRows][NCOL], dv[kRows][NCOL];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < NCOL; ++c) dk[r][c] = dv[r][c] = 0.f;

  for (int g = 0; g < p.rep; ++g) {
    const int h = hk * p.rep + g;
    for (int t = t_begin; t < t_end; ++t) {
      const int q0 = t * kB;
      __syncthreads();   // every warp is done with the last tile's Q, dO, P
      stage(qs, p.q + b * p.sq.b + h * p.sq.h, p.sq.s, q0, p.seq, p.dim, sd);
      stage(dos, p.dout + b * p.sdo.b + h * p.sdo.h, p.sdo.s, q0, p.seq,
            p.dim, sd);
      stage_rows(lse_s, delta_s, p, b, h, q0);
      __syncthreads();
      tile_p_ds(qs, dos, ks, vs, lse_s, delta_s, ps, dss, p, q0, k0, sd);
      __syncthreads();
      // dV[j] += sum_i P[i][j] dO[i], dK[j] += sum_i dS[i][j] Q[i], i in order
      for (int i = 0; i < kB; ++i) {
        float pj[kRows], sj[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          pj[r] = ps[i * kB + warp + kWarps * r];
          sj[r] = dss[i * kB + warp + kWarps * r];
        }
#pragma unroll
        for (int c = 0; c < NCOL; ++c) {
          const int d = min(lane + 32 * c, p.dim - 1);   // past dim: unused
          const float dov = dos[i * sd + d];
          const float qv = qs[i * sd + d];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            dv[r][c] = fmaf(pj[r], dov, dv[r][c]);
            dk[r][c] = fmaf(sj[r], qv, dk[r][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int key = k0 + warp + kWarps * r;
    if (key >= p.seq) continue;
    float* dkr = p.dk + b * p.sdk.b + hk * p.sdk.h + key * p.sdk.s;
    float* dvr = p.dv + b * p.sdv.b + hk * p.sdv.h + key * p.sdv.s;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      const int d = lane + 32 * c;
      if (d < p.dim) {
        dkr[d] = dk[r][c] * p.scale;
        dvr[d] = dv[r][c];
      }
    }
  }
}

template <int NCOL>
__global__ void __launch_bounds__(kThreads) dq_kernel(Args p) {
  extern __shared__ float smem[];
  const int sd = p.dim + 1;
  float* qs = smem;
  float* dos = qs + kB * sd;
  float* ks = dos + kB * sd;
  float* vs = ks + kB * sd;
  float* ps = vs + kB * sd;
  float* dss = ps + kB * kB;
  float* lse_s = dss + kB * kB;
  float* delta_s = lse_s + kB;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y / p.n_heads;
  const int h = blockIdx.y - b * p.n_heads;
  const int hk = h / p.rep;
  const int q0 = blockIdx.x * kB;

  stage(qs, p.q + b * p.sq.b + h * p.sq.h, p.sq.s, q0, p.seq, p.dim, sd);
  stage(dos, p.dout + b * p.sdo.b + h * p.sdo.h, p.sdo.s, q0, p.seq, p.dim,
        sd);
  stage_rows(lse_s, delta_s, p, b, h, q0);

  // the forward's band: keys up to the tile's last row (and to the prefix
  // for a tile that starts inside it), from its first row's window
  int kv_begin = 0, kv_end = p.seq;
  if (p.causal)
    kv_end = min(p.seq, max(q0 + kB, q0 < p.prefix ? p.prefix : 0));
  if (p.window > 0) kv_begin = max(0, q0 - p.window + 1);
  const int t_begin = kv_begin / kB;
  const int t_end = (kv_end + kB - 1) / kB;

  float dq[kRows][NCOL];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < NCOL; ++c) dq[r][c] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kB;
    __syncthreads();   // every warp is done with the last tile's K and dS
    stage(ks, p.k + b * p.sk.b + hk * p.sk.h, p.sk.s, k0, p.seq, p.dim, sd);
    stage(vs, p.v + b * p.sv.b + hk * p.sv.h, p.sv.s, k0, p.seq, p.dim, sd);
    __syncthreads();
    tile_p_ds(qs, dos, ks, vs, lse_s, delta_s, ps, dss, p, q0, k0, sd);
    __syncthreads();
    // dQ[i] += sum_j dS[i][j] K[j], j in order
    for (int j = 0; j < kB; ++j) {
      float sj[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) sj[r] = dss[(warp + kWarps * r) * kB + j];
#pragma unroll
      for (int c = 0; c < NCOL; ++c) {
        const float kv = ks[j * sd + min(lane + 32 * c, p.dim - 1)];
#pragma unroll
        for (int r = 0; r < kRows; ++r) dq[r][c] = fmaf(sj[r], kv, dq[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + warp + kWarps * r;
    if (row >= p.seq) continue;
    float* dqr = p.dq + b * p.sdq.b + h * p.sdq.h + row * p.sdq.s;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      const int d = lane + 32 * c;
      if (d < p.dim) dqr[d] = dq[r][c] * p.scale;
    }
  }
}

template <int NCOL>
cudaError_t launch(const Args& p, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.dim);
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<NCOL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_kernel<NCOL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (p.seq + kB - 1) / kB;
  dkdv_kernel<NCOL><<<dim3(tiles, batch * (p.n_heads / p.rep)), kThreads,
                      smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<NCOL><<<dim3(tiles, batch * p.n_heads), kThreads, smem,
                    stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// All fp32. q, o, dout, dq: [batch, seq, n_heads, dim] and k, v, dk, dv:
// [batch, seq, n_kv_heads, dim], in any axis order given by element strides
// (b, s, h), each with a head_dim stride of 1; lse (the forward's) and the
// workspace delta: contiguous [batch, n_heads, seq]. Head h reads kv head
// h / (n_heads / n_kv_heads). dq, dk and dv are written whole (every row
// below seq, every column below dim). The wrapper checks: 4 <= dim <= 256,
// n_heads % n_kv_heads == 0, batch * n_heads <= 65535, seq >= 1, and passes
// 0 <= prefix_len <= seq.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int batch, int n_heads, int n_kv_heads, int seq, int dim,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    long long do_sb, long long do_ss, long long do_sh, long long dq_sb,
    long long dq_ss, long long dq_sh, long long dk_sb, long long dk_ss,
    long long dk_sh, long long dv_sb, long long dv_ss, long long dv_sh,
    float scale, int causal, int window, int prefix_len, void* stream) {
  Args p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<const float*>(o);
  p.dout = static_cast<const float*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.sq = Strides{q_sb, q_ss, q_sh};
  p.sk = Strides{k_sb, k_ss, k_sh};
  p.sv = Strides{v_sb, v_ss, v_sh};
  p.so = Strides{o_sb, o_ss, o_sh};
  p.sdo = Strides{do_sb, do_ss, do_sh};
  p.sdq = Strides{dq_sb, dq_ss, dq_sh};
  p.sdk = Strides{dk_sb, dk_ss, dk_sh};
  p.sdv = Strides{dv_sb, dv_ss, dv_sh};
  p.n_heads = n_heads;
  p.rep = n_heads / n_kv_heads;
  p.seq = seq;
  p.dim = dim;
  p.causal = causal;
  p.window = window;
  p.prefix = prefix_len;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  const long long rows = static_cast<long long>(batch) * n_heads * seq;
  delta_kernel<<<static_cast<unsigned>((rows + kWarps - 1) / kWarps),
                 kThreads, 0, s>>>(p, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ncol = (dim + 31) / 32;
  if (ncol <= 2) {
    err = launch<2>(p, batch, s);
  } else if (ncol <= 4) {
    err = launch<4>(p, batch, s);
  } else if (ncol <= 6) {
    err = launch<6>(p, batch, s);
  } else {
    err = launch<8>(p, batch, s);
  }
  return static_cast<int>(err);
}
