// Blocked (flash) attention forward for sm_90a: the prefill attention of
// the LM zoo's GQA layers.
//
// Replaces the TPU kernel flash_attention (body _attn_kernel) in
// src/repro/kernels/flash_attention/kernel.py: per (batch, head, query row)
// a full-row softmax over the keys with online fp32 statistics (m, l, acc),
// q scaled by `scale` first, the causal mask cols <= rows, the window mask
// cols > rows - window when window > 0, masked logits at -1e30, l clamped to
// 1e-30, output in the input's type (fp32 or bf16; fp32 inside).
//
// Bound on the H100: operations. At the serve path's shape (B 4, H 64,
// S 2048, D 128, causal) QK^T and PV are 2*B*H*S^2*D = 0.27 Tflop after the
// causal half, 4.1 ms at the 67 Tflop/s of fp32 outside the tensor cores,
// against 0.6 GB of q, k, v and o (0.18 ms at 3.35 TB/s).
//
// Design: one block of 256 threads per (b*h, 64-query tile). The query
// tile (pre-scaled) and each 64-key tile of K and V are staged in shared
// memory as fp32 rows padded to an odd number of float4s, so the float4
// reads of 8 neighbouring rows fall in distinct banks. Thread (ty, tx) of
// the 16 x 16 grid owns rows ty + 16i and, for the scores, keys tx + 16j
// (i, j < 4): it reads a float4 of q (the same address across its
// half-warp, a broadcast) and a float4 of each of its 4 keys per 4 lanes
// of D, 64 FMAs per 8 loads. The softmax statistics of a row live in the 16
// lanes that share ty and are reduced with shuffles. P goes to shared
// memory over the K tile (K is no longer read by then), and the thread
// accumulates O for its 4 rows and the float4 columns 64n + 4tx in
// registers. kv tiles wholly outside the causal and window band are not
// visited; the ragged tail of S is masked (cols >= S), so any S >= 1 is
// taken. Causal blocks are scheduled heaviest first. Heads are read
// through strides, and head h reads kv head h / rep, so GQA needs neither
// a transpose nor a repeat of K and V. No tensor cores: fp32 matches the
// plain version to 3e-5; a wgmma design is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per shared-memory tile
constexpr int kThreads = 256;  // a 16 x 16 grid
constexpr int kPStride = 80;   // floats per row of P: rows ty, ty+1 16 banks apart
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// element strides of the batch, sequence and head axes (head_dim stride 1)
struct Strides {
  long long b, s, h;
};

// Load rows [row0, row0 + 64) of one head into `dst` (row stride `stride`
// floats), times `mul`; rows at or past `seq` are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long row_stride, int row0,
                                          int seq, int dim, int stride,
                                          float mul) {
  for (int idx = threadIdx.x; idx < kBQ * dim; idx += kThreads) {
    const int r = idx / dim;
    const int d = idx - r * dim;
    const int row = row0 + r;
    dst[r * stride + d] =
        row < seq ? to_f(src[row * row_stride + d]) * mul : 0.f;
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, Strides sq, Strides sk,
          Strides sv, Strides so, int n_heads, int rep, int seq, int dim,
          int stride, float scale, int causal, int window) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                              // [kBQ][stride]
  float* ks = qs + kBQ * stride;                 // [kBK][stride], then P
  const int kp_floats = max(kBK * stride, kBQ * kPStride);
  float* vs = ks + kp_floats;                    // [kBK][stride]
  float* ps = ks;                                // [kBQ][kPStride]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const int hk = h / rep;
  // under a causal mask later query tiles have more keys: start them first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kBQ;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  load_tile(qs, qb, sq.s, q0, seq, dim, stride, scale);

  int kv_begin = 0, kv_end = seq;
  if (causal) kv_end = min(seq, q0 + kBQ);
  if (window > 0) kv_begin = max(0, q0 - window + 1);
  const int t_begin = kv_begin / kBK;
  const int t_end = (kv_end + kBK - 1) / kBK;

  float m[4], l[4], acc[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's reads of P and V are done
    load_tile(ks, kb, sk.s, k0, seq, dim, stride, 1.f);
    load_tile(vs, vb, sv.s, k0, seq, dim, stride, 1.f);
    __syncthreads();

    // scores s[i][j] = (scale q[row i]) . k[key j]
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dim; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&qs[(ty + 16 * i) * stride + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&ks[(tx + 16 * j) * stride + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }
    __syncthreads();  // every read of K is done: P overwrites it

    // mask, online softmax, P to shared memory, rescale O
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        bool ok = col < seq;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && col > row - window;
        s[i][j] = ok ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] *= alpha;
    }
    __syncthreads();

    // O[rows, cols] += P[rows, keys] V[keys, cols]
    for (int j = 0; j < kBK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&ps[(ty + 16 * i) * kPStride + j]);
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int col = 64 * n + 4 * tx;
        if (col < dim) {
          const float4 v0 = *reinterpret_cast<const float4*>(&vs[(j + 0) * stride + col]);
          const float4 v1 = *reinterpret_cast<const float4*>(&vs[(j + 1) * stride + col]);
          const float4 v2 = *reinterpret_cast<const float4*>(&vs[(j + 2) * stride + col]);
          const float4 v3 = *reinterpret_cast<const float4*>(&vs[(j + 3) * stride + col]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float* a = acc[i][n];
            a[0] = fmaf(pv[i].x, v0.x, a[0]);
            a[1] = fmaf(pv[i].x, v0.y, a[1]);
            a[2] = fmaf(pv[i].x, v0.z, a[2]);
            a[3] = fmaf(pv[i].x, v0.w, a[3]);
            a[0] = fmaf(pv[i].y, v1.x, a[0]);
            a[1] = fmaf(pv[i].y, v1.y, a[1]);
            a[2] = fmaf(pv[i].y, v1.z, a[2]);
            a[3] = fmaf(pv[i].y, v1.w, a[3]);
            a[0] = fmaf(pv[i].z, v2.x, a[0]);
            a[1] = fmaf(pv[i].z, v2.y, a[1]);
            a[2] = fmaf(pv[i].z, v2.z, a[2]);
            a[3] = fmaf(pv[i].z, v2.w, a[3]);
            a[0] = fmaf(pv[i].w, v3.x, a[0]);
            a[1] = fmaf(pv[i].w, v3.y, a[1]);
            a[2] = fmaf(pv[i].w, v3.z, a[2]);
            a[3] = fmaf(pv[i].w, v3.w, a[3]);
          }
        }
      }
    }
  }

  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= seq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int col = 64 * n + 4 * tx;
      if (col < dim) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ob[row * so.s + col + e] = from_f<T>(acc[i][n][e] / denom);
      }
    }
  }
}

// Row stride in floats of a staged tile: dim padded to an odd count of
// float4s, so 8 neighbouring rows start in 8 distinct bank groups.
int tile_stride(int dim) {
  int s4 = dim / 4 + 1;
  if (s4 % 2 == 0) ++s4;
  return 4 * s4;
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   Strides sq, Strides sk, Strides sv, Strides so, int batch,
                   int n_heads, int rep, int seq, int dim, float scale,
                   int causal, int window, cudaStream_t stream) {
  const int stride = tile_stride(dim);
  const int kp_floats = kBK * stride > kBQ * kPStride ? kBK * stride
                                                      : kBQ * kPStride;
  const size_t smem = sizeof(float) * (2 * kBQ * stride + kp_floats);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBQ - 1) / kBQ, batch * n_heads);
  flash_fwd<T, NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, sv, so, n_heads,
      rep, seq, dim, stride, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     Strides sq, Strides sk, Strides sv, Strides so, int batch,
                     int n_heads, int rep, int seq, int dim, float scale,
                     int causal, int window, cudaStream_t stream) {
  switch ((dim + 63) / 64) {
    case 1:
      return launch<T, 1>(q, k, v, o, sq, sk, sv, so, batch, n_heads, rep,
                          seq, dim, scale, causal, window, stream);
    case 2:
      return launch<T, 2>(q, k, v, o, sq, sk, sv, so, batch, n_heads, rep,
                          seq, dim, scale, causal, window, stream);
    case 3:
      return launch<T, 3>(q, k, v, o, sq, sk, sv, so, batch, n_heads, rep,
                          seq, dim, scale, causal, window, stream);
    default:
      return launch<T, 4>(q, k, v, o, sq, sk, sv, so, batch, n_heads, rep,
                          seq, dim, scale, causal, window, stream);
  }
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, o: [batch, seq, n_heads, dim] and k, v: [batch, seq, n_kv_heads, dim]
// in any axis order, given by element strides (b, s, h) each with a
// head_dim stride of 1; fp32 (is_bf16 = 0) or bf16. Head h reads kv head
// h / (n_heads / n_kv_heads). The wrapper checks: 4 <= dim <= 256, dim % 4
// == 0, n_heads % n_kv_heads == 0, batch * n_heads <= 65535, seq >= 1.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int is_bf16,
    int batch, int n_heads, int n_kv_heads, int seq, int dim,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, int window, void* stream) {
  const Strides sq{q_sb, q_ss, q_sh}, sk{k_sb, k_ss, k_sh},
      sv{v_sb, v_ss, v_sh}, so{o_sb, o_ss, o_sh};
  const int rep = n_heads / n_kv_heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, sq, sk, sv, so, batch,
                                        n_heads, rep, seq, dim, scale, causal,
                                        window, s)
              : dispatch<float>(q, k, v, o, sq, sk, sv, so, batch, n_heads,
                                rep, seq, dim, scale, causal, window, s);
  return static_cast<int>(err);
}
