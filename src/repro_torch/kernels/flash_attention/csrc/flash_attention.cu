// Blocked (flash) attention forward for sm_90a: the prefill attention of
// the LM zoo's GQA layers.
//
// Replaces the TPU kernel flash_attention (body _attn_kernel) in
// src/repro/kernels/flash_attention/kernel.py: per (batch, head, query row)
// a full-row softmax over the keys with online fp32 statistics (m, l, acc),
// the causal mask cols <= rows, the window mask cols > rows - window when
// window > 0, masked logits at -1e30, l clamped to 1e-30, output in the
// input's type (fp32 or bf16; fp32 inside). Beyond the TPU kernel, the
// prefix-LM mask of the VLM (the JAX model's attention.build_mask): under
// causal, rows and keys both below prefix_len also attend both ways, so the
// mask is (cols <= rows || (rows < P && cols < P)) && the window.
//
// Bound on the H100: operations. At the serve path's shape (B 4, H 64,
// S 2048, D 128, causal) QK^T and PV are 2*B*H*S^2*D = 0.275 Tflop after
// the causal half. Held to fp32 (3e-5), each product runs as three TF32
// passes on the tensor cores: 0.82 Tflop at the dense TF32 rate of 495
// Tflop/s, 1.67 ms, against 0.6 GB of q, k, v and o (0.18 ms at 3.35 TB/s)
// and 0.54 G exponentials (0.13 ms).
//
// Design: both products on the tensor cores with
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 in 3xTF32. Every
// operand x splits into hi = rna(x) and lo = rna(x - hi), rna being
// cvt.rna.tf32.f32 done on the integer ALUs (the same bits; the conversion
// instruction itself runs on a slow pipe); each 16x8x8 step accumulates
// lo*hi and hi*lo first and hi*hi last, in fp32, and drops lo*lo. One TF32
// pass would miss the fp32 tolerance by ~50x; three carry about 22 bits of
// each operand. The steps run pass-major over a warp's tiles, so two mmas
// that share an accumulator are never adjacent. Warps own rows: a block of
// 4 warps takes a 128-query tile, each warp two m-tiles of 16 rows (rows
// 16 w + [0, 16) and 64 + 16 w + [0, 16)), so every split of a K or V
// fragment feeds two m-tiles; above D 128, where O would take 256
// registers a lane, a warp takes one m-tile of a 64-query tile. The row
// statistics (m, l) and O stay in the warp's registers, and a row's max and
// sum take two shuffles within a quad. S feeds the PV product straight from
// registers, with no shuffle and no shared memory: the m16n8 accumulator
// gives a lane the keys 2t and 2t+1 of its rows (t = lane % 4), and the
// m16n8k8 A operand wants k = t and t+4; the PV step takes the keys of each
// 8-key slice in the order (0, 2, 4, 6, 1, 3, 5, 7), which is the
// accumulator's layout, and reads V's rows in the same order, so the sum
// over keys is unchanged. Q and 32-key tiles of K and V are staged in
// shared memory as fp32 rows of a stride = 4 (mod 32) floats, so every
// fragment load of a warp hits 32 distinct banks; a head dim that is not a
// multiple of the mma depth 8 (minicpm's 36) is zero-padded to it in shared
// memory (zeros add nothing). K and V each have one buffer and their tiles
// load with 16-byte cp.async.cg in turn, so every load overlaps a product:
// V of tile t lands while S = Q K_t^T is computed, K of tile t + 1 while
// O += P V_t is. That keeps shared memory at 101 KB at D 128 (two blocks,
// eight warps, per SM); double buffers for both would take 135 KB and one
// block. Tiles are staged by a 2-D thread map stepped without a division
// per element. bf16 inputs (and fp32 tensors whose base or strides are not
// 16-byte aligned) take the same path with synchronous loads that convert
// to fp32 while they stage. kv tiles wholly outside the causal and window
// band are not visited; masks are applied only in tiles that cross a band
// edge or the ragged tail of S (cols >= S), so any S >= 1 is taken. A q
// tile that starts below the prefix length P reads keys up to P as well; a
// kv tile inside the prefix square of a q tile inside it needs no mask,
// and one that straddles P takes the per-element mask with the prefix
// term. At P = 0 both tests reduce to the causal ones, so the causal
// arithmetic is unchanged. Causal blocks are scheduled heaviest first; the
// q tiles inside a prefix come last and stay among the cheapest (P keys at
// most). Heads are read through strides, and head h reads kv head h / rep,
// so GQA needs neither a transpose nor a repeat of K and V. TF32 wgmma would need V transposed in shared memory
// (it takes K-major operands only): later work.
//
// For training the forward also writes each query row's logsumexp, lse =
// m + log(l) in natural units ([B, H, S] fp32), which the backward kernel
// (flash_attention_bwd.cu) recomputes the probabilities from. It is written
// only when its pointer is non-null; serving passes null, and the output's
// arithmetic is the same either way.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 32;        // keys per K/V tile
constexpr int kNT = kBK / 8;   // 8-key n-tiles of S per warp
constexpr int kThreads = 128;  // 4 warps

// 16-row m-tiles a warp owns at a head-dim bucket NC (O takes 32 NC
// registers a lane per m-tile), and the block's query rows
template <int NC>
__host__ __device__ constexpr int m_tiles() {
  return NC <= 2 ? 2 : 1;
}
template <int NC>
__host__ __device__ constexpr int block_q() {
  return 64 * m_tiles<NC>();
}
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// A thread's walk over the 16-byte chunks of a [rows, dim] tile: it starts at
// row r, chunk c, and steps kThreads chunks at a time, (dr, dc) rows and
// chunks, with cpr = dim / 4 chunks a row.
struct ChunkMap {
  int r, c, dr, dc, cpr;
};

__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  // src-size 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage rows [row0, row0 + ROWS) of one head into `dst` (row stride `stride`
// floats) as fp32; rows at or past `seq` are zero. ASYNC: cp.async (fp32,
// 16-byte aligned rows); else plain loads that convert while they stage.
template <int ROWS, typename T, bool ASYNC>
__device__ __forceinline__ void stage_tile(float* dst,
                                           const T* __restrict__ src,
                                           long long row_stride, int row0,
                                           int seq, int stride, ChunkMap m) {
  int r = m.r, c = m.c;
  while (r < ROWS) {
    const int row = row0 + r;
    const bool ok = row < seq;
    float* d = dst + r * stride + 4 * c;
    const T* s = src + (ok ? row * row_stride : 0) + 4 * c;
    if (ASYNC) {
      cp_async16(d, s, ok);
    } else {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ok) {
        v.x = to_f(s[0]);
        v.y = to_f(s[1]);
        v.z = to_f(s[2]);
        v.w = to_f(s[3]);
      }
      *reinterpret_cast<float4*>(d) = v;
    }
    c += m.dc;
    r += m.dr;
    if (c >= m.cpr) {
      c -= m.cpr;
      ++r;
    }
  }
}

// cvt.rna.tf32.f32 on the integer ALUs: half the unit of the 13 dropped
// bits added to the magnitude, then those bits cleared. The same bits as the
// instruction for finite x; the instruction itself issues to a conversion
// pipe much narrower than the ALUs, and the kernel splits every operand.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo to about 22 bits, each part a TF32 value
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// NC: 64-wide chunks of the padded head dim (O holds 8 * NC n-tiles of 8
// columns a warp). ASYNC: the cp.async staging path.
template <typename T, int NC, bool ASYNC>
__global__ void __launch_bounds__(kThreads, NC <= 2 ? 2 : 1)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
          Strides sq, Strides sk, Strides sv, Strides so, int n_heads,
          int rep, int seq, int dim, int dpad, int stride, float scale_log2,
          int causal, int window, int prefix) {
  constexpr int MT = m_tiles<NC>();
  constexpr int kBQ = block_q<NC>();
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                // [kBQ][stride]
  float* ks = qs + kBQ * stride;   // [kBK][stride]
  float* vs = ks + kBK * stride;   // [kBK][stride]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // the fragment's row (and B's column) group
  const int tq = lane & 3;   // the lane within its quad
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

  // the pad columns [dim, dpad) of the three tiles (at most 4) stay zero
  if (dpad > dim) {
    for (int i = threadIdx.x; i < (kBQ + 2 * kBK) * 4; i += kThreads) {
      const int col = dim + (i & 3);
      if (col < dpad) smem[(i >> 2) * stride + col] = 0.f;
    }
  }
  ChunkMap map;
  map.cpr = dim >> 2;
  map.r = threadIdx.x / map.cpr;
  map.c = threadIdx.x - map.r * map.cpr;
  map.dr = kThreads / map.cpr;
  map.dc = kThreads - map.dr * map.cpr;

  int kv_begin = 0, kv_end = seq;
  if (causal) kv_end = min(seq, max(q0 + kBQ, q0 < prefix ? prefix : 0));
  if (window > 0) kv_begin = max(0, q0 - window + 1);
  const int t_begin = kv_begin / kBK;
  const int t_end = (kv_end + kBK - 1) / kBK;

  stage_tile<kBQ, T, ASYNC>(qs, qb, sq.s, q0, seq, stride, map);
  stage_tile<kBK, T, ASYNC>(ks, kb, sk.s, t_begin * kBK, seq, stride, map);
  cp_async_commit();

  // m-tile i of the warp holds the block's rows 16 (warp + 4 i) + [0, 16):
  // rows row_a[i] (accumulator elements 0, 1) and row_a[i] + 8 (2, 3)
  int row_a[MT];
  const float* qw[MT];
  float m[MT][2], l[MT][2];   // l: this lane's part of the row sums
  float acc[MT][8 * NC][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    row_a[i] = q0 + 16 * (warp + 4 * i) + g;
    qw[i] = qs + (16 * (warp + 4 * i) + g) * stride + tq;
    m[i][0] = m[i][1] = kNegInf;
    l[i][0] = l[i][1] = 0.f;
#pragma unroll
    for (int n = 0; n < 8 * NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    cp_async_wait_all();
    __syncthreads();  // K_t (and Q) landed; every warp is done with V_{t-1}
    stage_tile<kBK, T, ASYNC>(vs, vb, sv.s, k0, seq, stride, map);
    cp_async_commit();

    // s = Q K_t^T: kNT n-tiles of 8 keys per m-tile, D in steps of 8. Each
    // 3xTF32 step runs pass-major (lo*hi, then hi*lo, then hi*hi over all
    // tiles), so MT * kNT independent mmas separate two that share an
    // accumulator, and each split of K feeds MT m-tiles.
    float s[MT][kNT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][j][e] = 0.f;
#pragma unroll 2
    for (int d = 0; d < dpad; d += 8) {
      uint32_t ah[MT][4], al[MT][4], bh[kNT][2], bl[kNT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        split(qw[i][d], ah[i][0], al[i][0]);
        split(qw[i][8 * stride + d], ah[i][1], al[i][1]);
        split(qw[i][d + 4], ah[i][2], al[i][2]);
        split(qw[i][8 * stride + d + 4], ah[i][3], al[i][3]);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int off = (8 * j + g) * stride + d + tq;
        split(ks[off], bh[j][0], bl[j][0]);
        split(ks[off + 4], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_tf32(s[i][j], al[i], bh[j]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_tf32(s[i][j], ah[i], bl[j]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_tf32(s[i][j], ah[i], bh[j]);
    }

    // mask (only where the tile crosses a band edge or the tail), online
    // softmax in log2 units, rescale O
    const bool full = k0 + kBK <= seq &&
                      (!causal || k0 + kBK - 1 <= q0 ||
                       (q0 + kBQ <= prefix && k0 + kBK <= prefix)) &&
                      (window <= 0 || k0 > q0 + kBQ - 1 - window);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[i][j][e] * scale_log2;
          if (!full) {
            const int col = k0 + 8 * j + 2 * tq + (e & 1);
            const int row = row_a[i] + 8 * (e >> 1);
            bool ok = col < seq;
            if (causal)
              ok = ok && (col <= row || (row < prefix && col < prefix));
            if (window > 0) ok = ok && col > row - window;
            x = ok ? x : kNegInf;
          }
          s[i][j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[i][r], mx[r]);
        alpha[r] = fast_exp2(m[i][r] - m_new);
        m[i][r] = m_new;
        l[i][r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = fast_exp2(s[i][j][e] - m[i][e >> 1]);
          s[i][j][e] = p;
          l[i][e >> 1] += p;
        }
#pragma unroll
      for (int n = 0; n < 8 * NC; ++n) {
        acc[i][n][0] *= alpha[0];
        acc[i][n][1] *= alpha[0];
        acc[i][n][2] *= alpha[1];
        acc[i][n][3] *= alpha[1];
      }
    }

    cp_async_wait_all();
    __syncthreads();  // V_t landed; every warp is done with K_t
    if (t + 1 < t_end)
      stage_tile<kBK, T, ASYNC>(ks, kb, sk.s, k0 + kBK, seq, stride, map);
    cp_async_commit();

    // O += P V_t, 8 keys a step in the order (0, 2, 4, 6, 1, 3, 5, 7): A's
    // k = tq is key 2 tq (elements 0, 2), k = tq + 4 is key 2 tq + 1
    // (1, 3). Pass-major over each 64-column chunk of O, as for S; each
    // split of V feeds MT m-tiles.
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        split(s[i][j][0], ah[i][0], al[i][0]);
        split(s[i][j][2], ah[i][1], al[i][1]);
        split(s[i][j][1], ah[i][2], al[i][2]);
        split(s[i][j][3], ah[i][3], al[i][3]);
      }
      const int voff = (8 * j + 2 * tq) * stride + g;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (64 * c < dpad) {
          uint32_t bh[8][2], bl[8][2];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            // n-tiles past dpad are skipped below; read nothing for them
            const bool in = 64 * c + 8 * u < dpad;
            const int col = voff + 64 * c + 8 * u;
            split(in ? vs[col] : 0.f, bh[u][0], bl[u][0]);
            split(in ? vs[col + stride] : 0.f, bh[u][1], bl[u][1]);
          }
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (64 * c + 8 * u < dpad)
                mma_tf32(acc[i][8 * c + u], al[i], bh[u]);
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (64 * c + 8 * u < dpad)
                mma_tf32(acc[i][8 * c + u], ah[i], bl[u]);
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (64 * c + 8 * u < dpad)
                mma_tf32(acc[i][8 * c + u], ah[i], bh[u]);
        }
      }
    }
  }
  cp_async_wait_all();

  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float li = l[i][r];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const int row = row_a[i] + 8 * r;
      if (row >= seq) continue;
      const float denom = fmaxf(li, 1e-30f);
      if (lse != nullptr && tq == 0)   // m is in log2 units
        lse[static_cast<long long>(bh) * seq + row] =
            (m[i][r] + log2f(denom)) * kLn2;
      T* orow = ob + row * so.s;
#pragma unroll
      for (int n = 0; n < 8 * NC; ++n) {
        const int col = 8 * n + 2 * tq;
        if (col < dim) {   // dim % 4 == 0, so col + 1 < dim too
          orow[col] = from_f<T>(acc[i][n][2 * r] / denom);
          orow[col + 1] = from_f<T>(acc[i][n][2 * r + 1] / denom);
        }
      }
    }
}

// Row stride in floats of a staged tile: the smallest count >= dpad that
// is 4 (mod 32), so the 8 rows a fragment load touches start 4 banks apart.
int tile_stride(int dpad) { return (dpad + 27) / 32 * 32 + 4; }

template <typename T, int NC, bool ASYNC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, Strides sq, Strides sk, Strides sv,
                   Strides so, int batch, int n_heads, int rep, int seq,
                   int dim, int dpad, float scale, int causal, int window,
                   int prefix, cudaStream_t stream) {
  constexpr int kBQ = block_q<NC>();
  const int stride = tile_stride(dpad);
  const size_t smem = sizeof(float) * (kBQ + 2 * kBK) * stride;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, NC, ASYNC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBQ - 1) / kBQ, batch * n_heads);
  flash_fwd<T, NC, ASYNC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, sk, sv, so,
      n_heads, rep, seq, dim, dpad, stride, scale * kLog2e, causal, window,
      prefix);
  return cudaGetLastError();
}

template <typename T, bool ASYNC>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     float* lse, Strides sq, Strides sk, Strides sv,
                     Strides so, int batch, int n_heads, int rep, int seq,
                     int dim, float scale, int causal, int window, int prefix,
                     cudaStream_t stream) {
  const int dpad = (dim + 7) / 8 * 8;   // the mma depth
  switch ((dpad + 63) / 64) {
    case 1:
      return launch<T, 1, ASYNC>(q, k, v, o, lse, sq, sk, sv, so, batch,
                                 n_heads, rep, seq, dim, dpad, scale, causal,
                                 window, prefix, stream);
    case 2:
      return launch<T, 2, ASYNC>(q, k, v, o, lse, sq, sk, sv, so, batch,
                                 n_heads, rep, seq, dim, dpad, scale, causal,
                                 window, prefix, stream);
    case 3:
      return launch<T, 3, ASYNC>(q, k, v, o, lse, sq, sk, sv, so, batch,
                                 n_heads, rep, seq, dim, dpad, scale, causal,
                                 window, prefix, stream);
    default:
      return launch<T, 4, ASYNC>(q, k, v, o, lse, sq, sk, sv, so, batch,
                                 n_heads, rep, seq, dim, dpad, scale, causal,
                                 window, prefix, stream);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool rows_aligned(Strides s) { return (s.b | s.s | s.h) % 4 == 0; }

int run(const void* q, const void* k, const void* v, void* o, float* lse,
        int is_bf16, int batch, int n_heads, int n_kv_heads, int seq,
        int dim, Strides sq, Strides sk, Strides sv, Strides so, float scale,
        int causal, int window, int prefix_len, void* stream) {
  const int rep = n_heads / n_kv_heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    err = dispatch<__nv_bfloat16, false>(q, k, v, o, lse, sq, sk, sv, so,
                                         batch, n_heads, rep, seq, dim, scale,
                                         causal, window, prefix_len, s);
  } else if (aligned16(q) && aligned16(k) && aligned16(v) &&
             rows_aligned(sq) && rows_aligned(sk) && rows_aligned(sv)) {
    err = dispatch<float, true>(q, k, v, o, lse, sq, sk, sv, so, batch,
                                n_heads, rep, seq, dim, scale, causal, window,
                                prefix_len, s);
  } else {
    err = dispatch<float, false>(q, k, v, o, lse, sq, sk, sv, so, batch,
                                 n_heads, rep, seq, dim, scale, causal,
                                 window, prefix_len, s);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, o: [batch, seq, n_heads, dim] and k, v: [batch, seq, n_kv_heads, dim]
// in any axis order, given by element strides (b, s, h) each with a
// head_dim stride of 1; fp32 (is_bf16 = 0) or bf16. Head h reads kv head
// h / (n_heads / n_kv_heads). The wrapper checks: 4 <= dim <= 256, dim % 4
// == 0, n_heads % n_kv_heads == 0, batch * n_heads <= 65535, seq >= 1, and
// passes 0 <= prefix_len <= seq (read only under causal).
// fp32 q, k, v whose bases and strides are 16-byte aligned stage with
// cp.async; the rest with plain loads.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int is_bf16,
    int batch, int n_heads, int n_kv_heads, int seq, int dim,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, int window, int prefix_len, void* stream) {
  return run(q, k, v, o, nullptr, is_bf16, batch, n_heads, n_kv_heads, seq,
             dim, Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh},
             Strides{v_sb, v_ss, v_sh}, Strides{o_sb, o_ss, o_sh}, scale,
             causal, window, prefix_len, stream);
}

// The same, also writing each query row's logsumexp into lse, a contiguous
// fp32 [batch, n_heads, seq] (the training forward).
extern "C" int repro_flash_attention_lse(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int is_bf16, int batch, int n_heads, int n_kv_heads, int seq, int dim,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, int window, int prefix_len, void* stream) {
  return run(q, k, v, o, static_cast<float*>(lse), is_bf16, batch, n_heads,
             n_kv_heads, seq, dim, Strides{q_sb, q_ss, q_sh},
             Strides{k_sb, k_ss, k_sh}, Strides{v_sb, v_ss, v_sh},
             Strides{o_sb, o_ss, o_sh}, scale, causal, window, prefix_len,
             stream);
}
