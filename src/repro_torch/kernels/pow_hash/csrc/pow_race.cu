// The Step 3+4 mine stage of BLADE-FL (paper §3.1) for sm_90a: the PoW
// race and, in seal mode, the winner, the difficulty test and the hash
// link, in one launch.
//
// Replaces the TPU kernels in src/repro/kernels/pow_hash/kernel.py:
//   pow_race_kernel (body _pow_race_kernel): C clients race at once;
//   pow_search_kernel (body _pow_kernel): one pre-salted payload, which is
//   this kernel's flat mode at C = 1;
// and, in seal mode, what XLA fuses around the race in the JAX package's
// make_mine (src/repro/core/rounds.py): the per-client salt, the
// first-index argmin across clients, the difficulty test and the link.
//
// For client c and attempt j < n_attempts the hash is
//   avalanche(avalanche(prev * M1 ^ payload_c) ^ (off + j))   (mod 2^32)
// and the client's result is (min hash, nonce of the FIRST j reaching it),
// nonce 0 when the min is 0xFFFFFFFF: the reference's running minimum
// starts at (0xFFFFFFFF, nonce 0) and takes only a strictly smaller hash.
// Seal mode salts payload_c = digest ^ avalanche(c * M2) itself (or takes
// pre-salted payloads), picks the first client with the least hash, and
// links new_hash = mix_hash(prev, digest, nonce) with the UNSALTED digest.
//
// What bounds it on the H100: latency. The roofline bound is the ALU
// work (about 2e5 hashes of a dozen 32-bit operations at the paper's
// budget of 20 clients x 10240 attempts: some 40 ns of the card); no input
// is streamed, the nonces are made in registers. What a call costs is the
// launch (an empty kernel is about 0.9 us of device time), one load of the
// inputs, one SM's instruction rate over a client's hashes (about 0.6 us
// for 10240) and the block's reduction. The TPU design (XLA fusing the
// salt, the argmin and the link around the kernel) came over as three
// device operations a call (a memset of the per-client slots, the race, an
// unpack kernel) and some 80 int64 elementwise launches around it.
//
// Design: one launch, no memset and no second kernel.
// - Grid (tiles x clients) of 512 threads; the wrapper picks the tile: one
//   block a client up to 16 384 attempts (the paper's budget), else
//   enough blocks to fill the card. A thread walks its nonces in ascending
//   j, keeping its least hash and the first j reaching it with a strict
//   '<' (no 64-bit compare a hash).
// - The block's min of the packed key (hash << 32) | j by redux.sync: the
//   smaller key is the smaller hash and, on a tie, the smaller j.
// - Flat mode with one block a client: the block writes its client's
//   (hash, nonce) itself. A one-block seal (C = 1) seals itself.
// - Otherwise each block stores its key in a partial slot, fences, and
//   takes an integer ticket. The last block to take it reduces each
//   client's tiles (a warp a client) and, in seal mode, the clients' keys
//   (hash << 32) | c, whose min is the first client on equal hashes; the
//   thread that read the winner's key seals. It resets the ticket to 0.
//   Launches that share a ticket must not overlap: the wrapper keeps one
//   ticket per stream.
// Integer min is order-free, so the result depends neither on the tile nor
// on the order in which the blocks run; no float atomic is used. Spreading
// a client of the paper's budget over more SMs costs more than the hashing
// it saves: a ticket pass, or the barriers of a thread block cluster.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM1 = 2654435761u;
constexpr uint32_t kM2 = 2246822519u;
constexpr uint32_t kM3 = 3266489917u;
constexpr uint32_t kMax = 0xFFFFFFFFu;
// threads a block (on an H100 at the paper's budget, 512 beat 256 and
// 1024; 384 and 768 read the same as 512)
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned long long kNone = ~0ull;
static_assert(kThreads % 32 == 0 && kWarps <= 32,
              "block_min reduces one key per lane of warp 0");

__device__ __forceinline__ uint32_t avalanche(uint32_t h) {
  h ^= h >> 15;
  h *= kM2;
  h ^= h >> 13;
  h *= kM3;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ unsigned long long min64(unsigned long long a,
                                                    unsigned long long b) {
  return a < b ? a : b;
}

// The warp's min of a packed key (hash << 32) | low: the least hash, then
// the least low word among the lanes holding it (two redux.sync).
__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
  const uint32_t hi = static_cast<uint32_t>(v >> 32);
  const uint32_t min_hi = __reduce_min_sync(0xffffffffu, hi);
  const uint32_t min_lo = __reduce_min_sync(
      0xffffffffu, hi == min_hi ? static_cast<uint32_t>(v) : kMax);
  return (static_cast<unsigned long long>(min_hi) << 32) | min_lo;
}

// The min of one key a thread over the block, returned to every thread.
__device__ __forceinline__ unsigned long long block_min(unsigned long long v) {
  __shared__ unsigned long long warp_keys[kWarps];
  __shared__ unsigned long long result;
  v = warp_min(v);
  if ((threadIdx.x & 31) == 0) warp_keys[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = warp_min(threadIdx.x < kWarps ? warp_keys[threadIdx.x] : kNone);
    if (threadIdx.x == 0) result = v;
  }
  __syncthreads();
  return result;
}

// A client's (hash, nonce) from its least key (hash << 32) | j.
__device__ __forceinline__ uint32_t nonce_of(unsigned long long key,
                                             uint32_t off) {
  const uint32_t h = static_cast<uint32_t>(key >> 32);
  return h == kMax ? 0u : off + static_cast<uint32_t>(key);
}

struct Seal {
  const int64_t* digest;   // unsalted digest word; null in flat mode
  uint32_t threshold;      // solved = pow_hash <= threshold
  int64_t* out;            // [winner, pow_hash, nonce, new_hash]
  bool* solved;
};

__device__ __forceinline__ void write_seal(const Seal& seal, uint32_t prev,
                                           uint32_t off, uint32_t winner,
                                           unsigned long long key) {
  const uint32_t h = static_cast<uint32_t>(key >> 32);
  const uint32_t nonce = nonce_of(key, off);
  const uint32_t digest = static_cast<uint32_t>(seal.digest[0]);
  seal.out[0] = winner;
  seal.out[1] = h;
  seal.out[2] = nonce;
  seal.out[3] = avalanche(avalanche((prev * kM1) ^ digest) ^ nonce);
  *seal.solved = h <= seal.threshold;
}

// prev_hash, nonce_offset: int64 [1]. payloads: int64 [C], pre-salted, or
// null in seal mode (salt the digest). part: u64 [C * tiles] (unused by a
// flat launch of one tile a client and by a one-block seal). Flat mode
// writes out_hash, out_nonce [C]; seal mode (seal.digest set) the Seal's
// outputs.
__global__ void __launch_bounds__(kThreads)
mine_kernel(const int64_t* __restrict__ prev_hash,
            const int64_t* __restrict__ nonce_offset,
            const int64_t* __restrict__ payloads, uint32_t n_attempts,
            uint32_t tile, unsigned long long* part, unsigned* ticket,
            int64_t* __restrict__ out_hash, int64_t* __restrict__ out_nonce,
            Seal seal) {
  __shared__ bool last;
  const uint32_t c = blockIdx.y;
  const uint32_t tiles = gridDim.x;
  const uint32_t n_clients = gridDim.y;
  const uint32_t prev = static_cast<uint32_t>(prev_hash[0]);
  const uint32_t off = static_cast<uint32_t>(nonce_offset[0]);
  const uint32_t payload =
      payloads != nullptr
          ? static_cast<uint32_t>(payloads[c])
          : static_cast<uint32_t>(seal.digest[0]) ^ avalanche(c * kM2);
  const uint32_t h0 = avalanche((prev * kM1) ^ payload);
  const uint32_t start = blockIdx.x * tile;
  const uint32_t end = min(start + tile, n_attempts);

  uint32_t best_h = kMax, best_j = kMax;
  uint32_t nonce = off + start + threadIdx.x;
#pragma unroll 4
  for (uint32_t j = start + threadIdx.x; j < end;
       j += kThreads, nonce += kThreads) {
    const uint32_t h = avalanche(h0 ^ nonce);
    if (h < best_h) {
      best_h = h;
      best_j = j;
    }
  }
  // a thread with no hash below 0xFFFFFFFF keeps kNone; its client's nonce
  // is then 0 whatever j it would carry
  const unsigned long long key =
      block_min((static_cast<unsigned long long>(best_h) << 32) | best_j);

  const bool sealing = seal.digest != nullptr;
  if (tiles == 1 && (!sealing || n_clients == 1)) {
    if (threadIdx.x == 0) {
      if (sealing) {
        write_seal(seal, prev, off, 0u, key);
      } else {
        out_hash[c] = static_cast<uint32_t>(key >> 32);
        out_nonce[c] = nonce_of(key, off);
      }
    }
    return;
  }

  if (threadIdx.x == 0) {
    part[static_cast<size_t>(c) * tiles + blockIdx.x] = key;
    __threadfence();
    last = atomicAdd(ticket, 1u) == tiles * n_clients - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (tiles > 1) {
    // a warp a client: the min over its tiles, kept in its first slot
    for (uint32_t cc = warp; cc < n_clients; cc += kWarps) {
      unsigned long long* slots = part + static_cast<size_t>(cc) * tiles;
      unsigned long long k = kNone;
      for (uint32_t t = lane; t < tiles; t += 32)
        k = min64(k, __ldcg(slots + t));
      k = warp_min(k);
      if (lane == 0) {
        if (sealing) {
          __stcg(slots, k);
        } else {
          out_hash[cc] = static_cast<uint32_t>(k >> 32);
          out_nonce[cc] = nonce_of(k, off);
        }
      }
    }
    __syncthreads();
  }
  if (sealing) {
    // the first client with the least hash: the min of (hash << 32) | c;
    // the thread that read the winner's key seals
    unsigned long long best = kNone, best_key = kNone;
    for (uint32_t cc = threadIdx.x; cc < n_clients; cc += kThreads) {
      const unsigned long long k =
          __ldcg(part + static_cast<size_t>(cc) * tiles);
      const unsigned long long w = (k & 0xFFFFFFFF00000000ull) | cc;
      if (w < best) {
        best = w;
        best_key = k;
      }
    }
    const unsigned long long winner = block_min(best);
    if (best == winner)
      write_seal(seal, prev, off, static_cast<uint32_t>(winner), best_key);
  }
  if (threadIdx.x == 0) atomicExch(ticket, 0u);
}

int launch(const void* prev_hash, const void* nonce_offset,
           const void* payloads, int n_clients, int n_attempts, int tile,
           void* part, void* ticket, void* out_hash, void* out_nonce,
           Seal seal, void* stream) {
  const dim3 grid(static_cast<unsigned>(
                      (static_cast<long long>(n_attempts) + tile - 1) / tile),
                  n_clients);
  mine_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(prev_hash),
      static_cast<const int64_t*>(nonce_offset),
      static_cast<const int64_t*>(payloads), static_cast<uint32_t>(n_attempts),
      static_cast<uint32_t>(tile), static_cast<unsigned long long*>(part),
      static_cast<unsigned*>(ticket), static_cast<int64_t*>(out_hash),
      static_cast<int64_t*>(out_nonce), seal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Flat mode. prev_hash, nonce_offset: int64 [1]; payloads: int64
// [n_clients] (salted); part: u64 [n_clients * tiles], tiles =
// ceil(n_attempts / tile); ticket: one uint32, 0 before the launch and 0
// again after it; out_hash, out_nonce: int64 [n_clients].
extern "C" int repro_pow_race(const void* prev_hash, const void* nonce_offset,
                              const void* payloads, int n_clients,
                              int n_attempts, int tile, void* part,
                              void* ticket, void* out_hash, void* out_nonce,
                              void* stream) {
  return launch(prev_hash, nonce_offset, payloads, n_clients, n_attempts,
                tile, part, ticket, out_hash, out_nonce,
                Seal{nullptr, 0u, nullptr, nullptr}, stream);
}

// Seal mode. As flat mode, plus digest: int64 [1], the unsalted digest;
// payloads may be null (the kernel salts the digest for clients 0..C-1);
// out: int64 [4] = (winner, pow_hash, nonce, new_hash); solved: bool [1].
extern "C" int repro_mine_seal(const void* prev_hash, const void* nonce_offset,
                               const void* payloads, const void* digest,
                               int n_clients, int n_attempts, int tile,
                               unsigned threshold, void* part, void* ticket,
                               void* out, void* solved, void* stream) {
  return launch(prev_hash, nonce_offset, payloads, n_clients, n_attempts,
                tile, part, ticket, nullptr, nullptr,
                Seal{static_cast<const int64_t*>(digest), threshold,
                     static_cast<int64_t*>(out), static_cast<bool*>(solved)},
                stream);
}
