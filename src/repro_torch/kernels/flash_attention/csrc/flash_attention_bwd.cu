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
// Bound on the H100: operations. The algorithm's own work is 10 D flops a
// kept (row, key) pair (S, dP, dV, dK, dQ at 2 D each); held to fp32 they
// run as three TF32 passes on the tensor cores, the forward's arithmetic.
// At phi4-mini's training shape (B 2, H 24, Hkv 8, S 512, D 128, causal)
// 6.30 M kept pairs, 8.1 Gflop, x3 at the dense TF32 rate of 495 Tflop/s:
// 0.0489 ms (its 80 MB of inputs and outputs take 0.024 ms at 3.35 TB/s).
// The two passes below do 14 D flops a pair (S and dP in both).
//
// Design: every product on the tensor cores with
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 in 3xTF32, as the
// forward does: each operand x splits into hi = rna(x) and lo = rna(x - hi)
// (rna on the integer ALUs), each 16x8x8 step accumulates lo*hi, hi*lo,
// then hi*hi in fp32, pass-major over a warp's n-tiles. Launches on the
// caller's stream, no atomics, every sum in a fixed order, so two calls
// give the same bits:
// 1. delta: D_i, one warp a row, each lane's columns summed in ascending
//    order and the lanes joined by a fixed xor tree.
// 2. dK/dV, kv-tile-major: a block of 4 warps owns a 64-key tile of one
//    query head (warp w the keys 16 w + [0, 16)) and walks the 32-row q
//    tiles that the mask's band reaches, in order. Per q tile it computes
//    S^T = K Q^T and dP^T = V dO^T with the keys as the mma's rows, so
//    P^T and dS^T come out in the accumulator layout, which feeds dV +=
//    P^T dO and dK += dS^T Q straight from registers as the A operand (the
//    forward's trick for P V: the m16n8 accumulator gives a lane the
//    columns 2t and 2t+1, the A operand wants k = t and t + 4, so each
//    8-row slice is taken in the order (0, 2, 4, 6, 1, 3, 5, 7) and dO and
//    Q are read in that order). dK and dV stay in registers for the whole
//    walk and are written once. A block holds at most 128 of their columns
//    (128 registers a lane); above D 128 the columns split over two blocks
//    (grid z), each recomputing S^T and dP^T. With GQA (rep = H / Hkv > 1)
//    each query head's dK and dV go to a workspace and a third launch sums
//    a group's heads in order, head 0 first, into dk and dv at Hkv heads:
//    a block per query head gives 3x the blocks of a block per kv head at
//    phi4-mini's shape (384, two an SM), for 50 MB more traffic.
// 3. dQ, q-tile-major: a block of 4 warps owns a 64-row q tile of one head
//    (warp w the rows 16 w + [0, 16)) and walks the 32-key tiles of the
//    band, in order: S = Q K^T and dP = dO V^T, dS in registers feeds dQ +=
//    dS K as the A operand, the same way.
// Tiles live in shared memory as fp32 rows of a stride = 4 (mod 32) floats,
// so every fragment load of a warp hits 32 distinct banks; a head dim that
// is not a multiple of the mma depth 8 (minicpm's 36) is zero-padded to it
// there (zeros add nothing). The streamed tiles load with cp.async (16-byte
// copies when the tensors are 16-byte aligned, 4-byte ones otherwise), one
// buffer each, ordered so that every load overlaps a product: in pass 2 the
// next dO tile lands while dK += dS^T Q runs and the next Q tile while the
// next dP^T runs; in pass 3 the next V tile lands during S and dQ, the next
// K tile during the next dP. At D 128 a block stages 101 KB, two blocks
// (eight warps) an SM; at D 256 200 KB, one. Tiles wholly outside the band
// are skipped; masks are applied only in tiles that cross a band edge or
// the ragged tail. Causal blocks are scheduled heaviest first: the tile
// index is the grid's slow axis, counted from the heavy end. TF32 wgmma
// with TMA would need transposed operands in shared memory: later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kKV = 64;         // keys of a dK/dV block (16 a warp)
constexpr int kQR = 32;         // query rows a dK/dV block takes a step
constexpr int kQ = 64;          // query rows of a dQ block (16 a warp)
constexpr int kKB = 32;         // keys a dQ block takes a step
constexpr int kMaxCols = 128;   // dK/dV columns a block holds
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDeltaWarps = 8;

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
  float* part_k;      // [batch, n_heads, seq, dim] when rep > 1, else null
  float* part_v;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int n_heads, rep, seq, dim, dpad, stride, cols, causal, window, prefix;
  float scale, scale_log2;
};

// D_i = sum_d dO_i O_i for every (batch, head, row): one warp a row
__global__ void __launch_bounds__(32 * kDeltaWarps)
delta_kernel(Args p, long long rows) {
  const long long r =
      static_cast<long long>(blockIdx.x) * kDeltaWarps + (threadIdx.x >> 5);
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

// W floats from src to shared dst, or zeros there when !valid (src-size 0:
// no byte of src is read)
template <int W>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (W == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every copy but those of the newest N committed groups has landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A thread's walk over the W-float copies of a [rows, dim] tile: it starts
// at row r, copy c, and steps kThreads copies at a time, (dr, dc) rows and
// copies, with cpr = dim / W copies a row.
struct CopyMap {
  int r, c, dr, dc, cpr;
};

template <int W>
__device__ __forceinline__ CopyMap copy_map(int dim) {
  CopyMap m;
  m.cpr = dim / W;
  m.r = threadIdx.x / m.cpr;
  m.c = threadIdx.x - m.r * m.cpr;
  m.dr = kThreads / m.cpr;
  m.dc = kThreads - m.dr * m.cpr;
  return m;
}

// Start the copies of rows [row0, row0 + ROWS) of one head into `dst` (row
// stride `stride` floats); rows at or past `seq` are zero-filled.
template <int ROWS, int W>
__device__ __forceinline__ void stage(float* dst,
                                      const float* __restrict__ src,
                                      long long row_stride, int row0,
                                      int seq, int stride, CopyMap m) {
  int r = m.r, c = m.c;
  while (r < ROWS) {
    const int row = row0 + r;
    const bool ok = row < seq;
    cp_async<W>(dst + r * stride + W * c,
                src + (ok ? row * row_stride : 0) + W * c, ok);
    c += m.dc;
    r += m.dr;
    if (c >= m.cpr) {
      c -= m.cpr;
      ++r;
    }
  }
}

// zero the pad columns [dim, dpad) (at most 4) of `rows` staged rows
__device__ __forceinline__ void zero_pad(float* smem, int rows, int dim,
                                         int dpad, int stride) {
  if (dpad == dim) return;
  for (int i = threadIdx.x; i < rows * 4; i += kThreads) {
    const int col = dim + (i & 3);
    if (col < dpad) smem[(i >> 2) * stride + col] = 0.f;
  }
}

// cvt.rna.tf32.f32 on the integer ALUs (flash_attention.cu's tf32_rna)
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

// Whether (row, col) is kept by the masks.
__device__ __forceinline__ bool keep(const Args& p, int row, int col) {
  bool ok = row < p.seq && col < p.seq;
  if (p.causal) ok = ok && (col <= row || (row < p.prefix && col < p.prefix));
  if (p.window > 0) ok = ok && col > row - p.window;
  return ok;
}

// Whether every pair of rows [q0, q0 + nq) and keys [k0, k0 + nk) is kept.
__device__ __forceinline__ bool full_tile(const Args& p, int q0, int nq,
                                          int k0, int nk) {
  return k0 + nk <= p.seq && q0 + nq <= p.seq &&
         (!p.causal || k0 + nk - 1 <= q0 ||
          (q0 + nq <= p.prefix && k0 + nk <= p.prefix)) &&
         (p.window <= 0 || k0 > q0 + nq - 1 - p.window);
}

// acc[j] (16 x 8, n-tile j) += A B^T over the padded head dim: A the 16
// staged rows at `a` (the warp's m-tile), B the staged rows 8 j + [0, 8)
// at `bmat`. 4 n-tiles: 32 rows of B.
__device__ __forceinline__ void product_abt(float (*acc)[4], const float* a,
                                            const float* bmat, int stride,
                                            int dpad) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const float* aw = a + g * stride + tq;
  const float* bw = bmat + g * stride + tq;
#pragma unroll 2
  for (int d = 0; d < dpad; d += 8) {
    uint32_t ah[4], al[4], bh[4][2], bl[4][2];
    split(aw[d], ah[0], al[0]);
    split(aw[8 * stride + d], ah[1], al[1]);
    split(aw[d + 4], ah[2], al[2]);
    split(aw[8 * stride + d + 4], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      split(bw[8 * j * stride + d], bh[j][0], bl[j][0]);
      split(bw[8 * j * stride + d + 4], bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_tf32(acc[j], al, bh[j]);
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_tf32(acc[j], ah, bl[j]);
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_tf32(acc[j], ah, bh[j]);
  }
}

// acc[u] (16 x 8, columns c0 + 8 u) += X Y for u < nt: X the 16 x 32 tile
// `x` in the accumulator layout (4 n-tiles), Y the 32 staged rows at `y`.
// X's 8-column slice j is the A operand in the order (0, 2, 4, 6, 1, 3, 5,
// 7), and Y's rows are read in the same order, so the sum over the 32 is
// unchanged.
template <int NT>
__device__ __forceinline__ void product_xy(float (*acc)[4],
                                           const float (*x)[4],
                                           const float* y, int stride,
                                           int c0, int nt) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t ah[4], al[4];
    split(x[j][0], ah[0], al[0]);
    split(x[j][2], ah[1], al[1]);
    split(x[j][1], ah[2], al[2]);
    split(x[j][3], ah[3], al[3]);
    const float* yj = y + (8 * j + 2 * tq) * stride + c0 + g;
#pragma unroll
    for (int cc = 0; cc < NT; cc += 8) {
      if (cc < nt) {
        uint32_t bh[8][2], bl[8][2];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          // n-tiles past nt are skipped below; read nothing for them
          const bool in = cc + u < nt;
          const int col = 8 * (cc + u);
          split(in ? yj[col] : 0.f, bh[u][0], bl[u][0]);
          split(in ? yj[col + stride] : 0.f, bh[u][1], bl[u][1]);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (cc + u < nt) mma_tf32(acc[cc + u], al, bh[u]);
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (cc + u < nt) mma_tf32(acc[cc + u], ah, bl[u]);
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (cc + u < nt) mma_tf32(acc[cc + u], ah, bh[u]);
      }
    }
  }
}

// NT: 8-column n-tiles of dK and dV a block holds (8 or 16). W: floats a
// cp.async copies (4: 16-byte aligned tensors; 1: any).
template <int NT, int W>
__global__ void __launch_bounds__(kThreads, 2) dkdv_kernel(Args p) {
  extern __shared__ __align__(16) float smem[];
  const int stride = p.stride;
  float* ks = smem;                     // [kKV][stride]
  float* vs = ks + kKV * stride;        // [kKV][stride]
  float* qs = vs + kKV * stride;        // [kQR][stride]
  float* dos = qs + kQR * stride;       // [kQR][stride]
  float* lse_s = dos + kQR * stride;    // [kQR]
  float* delta_s = lse_s + kQR;         // [kQR]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.n_heads;
  const int h = bh - b * p.n_heads;
  const int hk = h / p.rep;
  const int k0 = blockIdx.y * kKV;   // tile 0 first: under causal the heaviest
  const int c0 = blockIdx.z * p.cols;
  const int nt = min(p.cols, p.dpad - c0) / 8;

  const float* qb = p.q + b * p.sq.b + h * p.sq.h;
  const float* dob = p.dout + b * p.sdo.b + h * p.sdo.h;
  const float* kb = p.k + b * p.sk.b + hk * p.sk.h;
  const float* vb = p.v + b * p.sv.b + hk * p.sv.h;
  const long long row_at = static_cast<long long>(bh) * p.seq;

  zero_pad(smem, 2 * kKV + 2 * kQR, p.dim, p.dpad, stride);
  const CopyMap map = copy_map<W>(p.dim);

  // the q rows that can see a key of this tile: under causal rows >= k0
  // (every row when the tile starts inside the prefix); under a window rows
  // < last key + window
  const int q_lo = p.causal && k0 >= p.prefix ? k0 : 0;
  const int q_hi =
      p.window > 0 ? min(p.seq, k0 + kKV - 1 + p.window) : p.seq;
  const int t_begin = q_lo / kQR;
  const int t_end = (q_hi + kQR - 1) / kQR;

  // dO, lse and delta of q tile t; Q of q tile t
  auto stage_do = [&](int t) {
    const int q0 = t * kQR;
    stage<kQR, W>(dos, dob, p.sdo.s, q0, p.seq, stride, map);
    if (threadIdx.x < 2 * kQR) {
      const int i = threadIdx.x & (kQR - 1);
      const int row = q0 + i;
      const bool ok = row < p.seq;
      const float* src = threadIdx.x < kQR ? p.lse : p.delta;
      cp_async<1>((threadIdx.x < kQR ? lse_s : delta_s) + i,
                  src + (ok ? row_at + row : 0), ok);
    }
  };

  stage<kKV, W>(ks, kb, p.sk.s, k0, p.seq, stride, map);
  stage<kKV, W>(vs, vb, p.sv.s, k0, p.seq, stride, map);
  if (t_begin < t_end) stage_do(t_begin);
  cp_async_commit();
  if (t_begin < t_end)
    stage<kQR, W>(qs, qb, p.sq.s, t_begin * kQR, p.seq, stride, map);
  cp_async_commit();

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int u = 0; u < NT; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[u][e] = dv[u][e] = 0.f;
  const float* kw = ks + 16 * warp * stride;
  const float* vw = vs + 16 * warp * stride;
  const int key_a = k0 + 16 * warp + g;   // the lane's keys: key_a, key_a + 8

  for (int t = t_begin; t < t_end; ++t) {
    const int q0 = t * kQR;
    cp_async_wait<1>();
    __syncthreads();   // dO_t, lse, delta (and K, V) landed
    // dP^T = V dO^T and S^T = K Q^T: this warp's 16 keys x the 32 rows
    float dpt[4][4], st[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dpt[j][e] = st[j][e] = 0.f;
    product_abt(dpt, vw, dos, stride, p.dpad);
    cp_async_wait<0>();
    __syncthreads();   // Q_t landed
    product_abt(st, kw, qs, stride, p.dpad);

    // P^T and dS^T (element e: key key_a + 8 (e >> 1), row 8 j + 2 tq +
    // (e & 1) of the tile)
    const bool full = full_tile(p, q0, kQR, k0, kKV);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * j + 2 * tq + (e & 1);
        float pv = fast_exp2(st[j][e] * p.scale_log2 - lse_s[i] * kLog2e);
        if (!full && !keep(p, q0 + i, key_a + 8 * (e >> 1))) pv = 0.f;
        st[j][e] = pv;
        dpt[j][e] = pv * (dpt[j][e] - delta_s[i]);
      }
    // dV += P^T dO_t
    product_xy<NT>(dv, st, dos, stride, c0, nt);
    __syncthreads();   // every warp is done with dO_t, lse and delta
    if (t + 1 < t_end) stage_do(t + 1);
    cp_async_commit();
    // dK += dS^T Q_t
    product_xy<NT>(dk, dpt, qs, stride, c0, nt);
    __syncthreads();   // every warp is done with Q_t
    if (t + 1 < t_end)
      stage<kQR, W>(qs, qb, p.sq.s, q0 + kQR, p.seq, stride, map);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // this head's dK (scaled) and dV: at Hkv heads when rep is 1, else into
  // the workspace for the group sum
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_a + 8 * r;
    if (key >= p.seq) continue;
    float *dkr, *dvr;
    if (p.part_k == nullptr) {
      dkr = p.dk + b * p.sdk.b + hk * p.sdk.h + key * p.sdk.s;
      dvr = p.dv + b * p.sdv.b + hk * p.sdv.h + key * p.sdv.s;
    } else {
      const long long at = (row_at + key) * p.dim;
      dkr = p.part_k + at;
      dvr = p.part_v + at;
    }
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      const int col = c0 + 8 * u + 2 * tq;
      if (u < nt && col < p.dim) {   // dim % 4 == 0, so col + 1 < dim too
        dkr[col] = dk[u][2 * r] * p.scale;
        dkr[col + 1] = dk[u][2 * r + 1] * p.scale;
        dvr[col] = dv[u][2 * r];
        dvr[col + 1] = dv[u][2 * r + 1];
      }
    }
  }
}

// dk and dv at Hkv heads: each group's query heads summed in order, head 0
// first; one thread a 4 columns of one (batch, key, kv head)
__global__ void __launch_bounds__(256) group_sum_kernel(Args p, int batch) {
  const int n_kv = p.n_heads / p.rep;
  const int quads = p.dim >> 2;
  const long long n =
      static_cast<long long>(batch) * p.seq * n_kv * quads;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = static_cast<int>(i % quads);
  long long rest = i / quads;
  const int hk = static_cast<int>(rest % n_kv);
  rest /= n_kv;
  const int key = static_cast<int>(rest % p.seq);
  const int b = static_cast<int>(rest / p.seq);
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int r = 0; r < p.rep; ++r) {
    const long long at =
        ((static_cast<long long>(b) * p.n_heads + hk * p.rep + r) * p.seq +
         key) * p.dim + 4 * c;
    const float4 xk = *reinterpret_cast<const float4*>(p.part_k + at);
    const float4 xv = *reinterpret_cast<const float4*>(p.part_v + at);
    sk.x += xk.x, sk.y += xk.y, sk.z += xk.z, sk.w += xk.w;
    sv.x += xv.x, sv.y += xv.y, sv.z += xv.z, sv.w += xv.w;
  }
  float* dkr = p.dk + b * p.sdk.b + hk * p.sdk.h + key * p.sdk.s + 4 * c;
  float* dvr = p.dv + b * p.sdv.b + hk * p.sdv.h + key * p.sdv.s + 4 * c;
  dkr[0] = sk.x, dkr[1] = sk.y, dkr[2] = sk.z, dkr[3] = sk.w;
  dvr[0] = sv.x, dvr[1] = sv.y, dvr[2] = sv.z, dvr[3] = sv.w;
}

// NT: 8-column n-tiles of the padded head dim (8, 16, 24 or 32). W as for
// dkdv_kernel.
template <int NT, int W>
__global__ void __launch_bounds__(kThreads, 2) dq_kernel(Args p) {
  extern __shared__ __align__(16) float smem[];
  const int stride = p.stride;
  float* qs = smem;                 // [kQ][stride]
  float* dos = qs + kQ * stride;    // [kQ][stride]
  float* ks = dos + kQ * stride;    // [kKB][stride]
  float* vs = ks + kKB * stride;    // [kKB][stride]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.n_heads;
  const int h = bh - b * p.n_heads;
  const int hk = h / p.rep;
  // under a causal mask later q tiles have more keys: start them first
  const int qt = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kQ;
  const int nt = p.dpad / 8;

  const float* kb = p.k + b * p.sk.b + hk * p.sk.h;
  const float* vb = p.v + b * p.sv.b + hk * p.sv.h;

  zero_pad(smem, 2 * kQ + 2 * kKB, p.dim, p.dpad, stride);
  const CopyMap map = copy_map<W>(p.dim);

  // the forward's band: keys up to the tile's last row (and to the prefix
  // for a tile that starts inside it), from its first row's window
  int kv_begin = 0, kv_end = p.seq;
  if (p.causal)
    kv_end = min(p.seq, max(q0 + kQ, q0 < p.prefix ? p.prefix : 0));
  if (p.window > 0) kv_begin = max(0, q0 - p.window + 1);
  const int t_begin = kv_begin / kKB;
  const int t_end = (kv_end + kKB - 1) / kKB;

  stage<kQ, W>(qs, p.q + b * p.sq.b + h * p.sq.h, p.sq.s, q0, p.seq, stride,
               map);
  stage<kQ, W>(dos, p.dout + b * p.sdo.b + h * p.sdo.h, p.sdo.s, q0, p.seq,
               stride, map);
  if (t_begin < t_end)
    stage<kKB, W>(vs, vb, p.sv.s, t_begin * kKB, p.seq, stride, map);
  cp_async_commit();
  if (t_begin < t_end)
    stage<kKB, W>(ks, kb, p.sk.s, t_begin * kKB, p.seq, stride, map);
  cp_async_commit();

  // the lane's rows row_a and row_a + 8: lse (in log2 units) and delta
  const int row_a = q0 + 16 * warp + g;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    const long long at = static_cast<long long>(bh) * p.seq + row;
    lse2[r] = row < p.seq ? p.lse[at] * kLog2e : 0.f;
    dlt[r] = row < p.seq ? p.delta[at] : 0.f;
  }
  float dq[NT][4];
#pragma unroll
  for (int u = 0; u < NT; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[u][e] = 0.f;
  const float* qw = qs + 16 * warp * stride;
  const float* dow = dos + 16 * warp * stride;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kKB;
    cp_async_wait<1>();
    __syncthreads();   // V_t (and Q, dO) landed
    float dp[4][4], s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] = 0.f;
    product_abt(dp, dow, vs, stride, p.dpad);
    cp_async_wait<0>();
    __syncthreads();   // K_t landed; every warp is done with V_t
    if (t + 1 < t_end)
      stage<kKB, W>(vs, vb, p.sv.s, k0 + kKB, p.seq, stride, map);
    cp_async_commit();
    product_abt(s, qw, ks, stride, p.dpad);

    // dS (element e: row row_a + 8 (e >> 1), key k0 + 8 j + 2 tq + (e & 1))
    const bool full = full_tile(p, q0, kQ, k0, kKB);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float pv = fast_exp2(s[j][e] * p.scale_log2 - lse2[r]);
        if (!full && !keep(p, row_a + 8 * r, k0 + 8 * j + 2 * tq + (e & 1)))
          pv = 0.f;
        dp[j][e] = pv * (dp[j][e] - dlt[r]);
      }
    // dQ += dS K_t
    product_xy<NT>(dq, dp, ks, stride, 0, nt);
    __syncthreads();   // every warp is done with K_t
    if (t + 1 < t_end)
      stage<kKB, W>(ks, kb, p.sk.s, k0 + kKB, p.seq, stride, map);
    cp_async_commit();
  }
  cp_async_wait<0>();

  float* dqb = p.dq + b * p.sdq.b + h * p.sdq.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= p.seq) continue;
    float* dqr = dqb + row * p.sdq.s;
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      const int col = 8 * u + 2 * tq;
      if (u < nt && col < p.dim) {
        dqr[col] = dq[u][2 * r] * p.scale;
        dqr[col + 1] = dq[u][2 * r + 1] * p.scale;
      }
    }
  }
}

// Row stride in floats of a staged tile: the smallest count >= dpad that
// is 4 (mod 32), so the 8 rows a fragment load touches start 4 banks apart.
int tile_stride(int dpad) { return (dpad + 27) / 32 * 32 + 4; }

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int NT, int W>
cudaError_t launch_dkdv(const Args& p, int batch, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((2 * kKV + 2 * kQR) * p.stride + 2 * kQR);
  cudaError_t err = set_smem(dkdv_kernel<NT, W>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * p.n_heads, (p.seq + kKV - 1) / kKV,
                  (p.dpad + p.cols - 1) / p.cols);
  dkdv_kernel<NT, W><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int NT, int W>
cudaError_t launch_dq(const Args& p, int batch, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * kQ + 2 * kKB) * p.stride;
  cudaError_t err = set_smem(dq_kernel<NT, W>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * p.n_heads, (p.seq + kQ - 1) / kQ);
  dq_kernel<NT, W><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_all(const Args& p, int batch, cudaStream_t stream) {
  cudaError_t err = p.cols <= 64 ? launch_dkdv<8, W>(p, batch, stream)
                                 : launch_dkdv<16, W>(p, batch, stream);
  if (err != cudaSuccess) return err;
  if (p.part_k != nullptr) {
    const long long n = static_cast<long long>(batch) * p.seq *
                        (p.n_heads / p.rep) * (p.dim / 4);
    group_sum_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                       stream>>>(p, batch);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  switch (p.dpad / 8 > 24 ? 4 : p.dpad / 8 > 16 ? 3 : p.dpad / 8 > 8 ? 2 : 1) {
    case 1:
      return launch_dq<8, W>(p, batch, stream);
    case 2:
      return launch_dq<16, W>(p, batch, stream);
    case 3:
      return launch_dq<24, W>(p, batch, stream);
    default:
      return launch_dq<32, W>(p, batch, stream);
  }
}

bool aligned16(const void* x) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

bool rows_aligned(Strides s) { return (s.b | s.s | s.h) % 4 == 0; }

// floats of the workspace: the partials of dK and dV of every query head
// when rep > 1, then delta
long long partial_floats(int batch, int n_heads, int n_kv_heads, int seq,
                         int dim) {
  return n_heads == n_kv_heads
             ? 0
             : 2LL * batch * n_heads * static_cast<long long>(seq) * dim;
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Floats of the workspace repro_flash_attention_bwd takes as `delta`: the
// rows' D ([batch, n_heads, seq]) and, under GQA, each query head's dK and
// dV before the group sum.
extern "C" long long repro_flash_attention_bwd_workspace(int batch,
                                                         int n_heads,
                                                         int n_kv_heads,
                                                         int seq, int dim) {
  return partial_floats(batch, n_heads, n_kv_heads, seq, dim) +
         static_cast<long long>(batch) * n_heads * seq;
}

// All fp32. q, o, dout, dq: [batch, seq, n_heads, dim] and k, v, dk, dv:
// [batch, seq, n_kv_heads, dim], in any axis order given by element strides
// (b, s, h), each with a head_dim stride of 1; lse (the forward's):
// contiguous [batch, n_heads, seq]; delta: a 16-byte aligned workspace of
// repro_flash_attention_bwd_workspace floats. Head h reads kv head h /
// (n_heads / n_kv_heads). dq, dk and dv are written whole (every row below
// seq, every column below dim). The wrapper checks: 4 <= dim <= 256, dim %
// 4 == 0, n_heads % n_kv_heads == 0, batch * n_heads <= 65535, seq >= 1,
// and passes 0 <= prefix_len <= seq. q, k, v and dout whose bases and
// strides are 16-byte aligned stage with 16-byte copies, the rest with
// 4-byte ones.
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
  const long long parts =
      partial_floats(batch, n_heads, n_kv_heads, seq, dim);
  float* work = static_cast<float*>(delta);
  p.part_k = parts > 0 ? work : nullptr;
  p.part_v = parts > 0 ? work + parts / 2 : nullptr;
  p.delta = work + parts;
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
  p.dpad = (dim + 7) / 8 * 8;   // the mma depth
  p.stride = tile_stride(p.dpad);
  // dK/dV columns a block holds: all up to kMaxCols, else two blocks' worth
  p.cols = p.dpad <= kMaxCols ? p.dpad : (p.dpad / 2 + 7) / 8 * 8;
  p.causal = causal;
  p.window = window;
  p.prefix = prefix_len;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  const long long rows = static_cast<long long>(batch) * n_heads * seq;
  delta_kernel<<<static_cast<unsigned>((rows + kDeltaWarps - 1) /
                                       kDeltaWarps),
                 32 * kDeltaWarps, 0, s>>>(p, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = aligned16(q) && aligned16(k) && aligned16(v) &&
                   aligned16(dout) && rows_aligned(p.sq) &&
                   rows_aligned(p.sk) && rows_aligned(p.sv) &&
                   rows_aligned(p.sdo);
  err = vec ? launch_all<4>(p, batch, s) : launch_all<1>(p, batch, s);
  return static_cast<int>(err);
}
