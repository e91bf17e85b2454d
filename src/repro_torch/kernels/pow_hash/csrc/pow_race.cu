// The Step-3 PoW race of BLADE-FL (paper §3.1) for sm_90a.
//
// Replaces the TPU kernels in src/repro/kernels/pow_hash/kernel.py:
//   pow_race_kernel (body _pow_race_kernel): C clients race at once;
//   pow_search_kernel (body _pow_kernel): one pre-salted payload, which is
//   this kernel at C = 1.
//
// For client c and attempt j < n_attempts the hash is
//   avalanche(avalanche(prev * M1 ^ payload_c) ^ (off + j))   (mod 2^32)
// and the result per client is (min hash, nonce of the FIRST j reaching it),
// the first-local-index rule the TPU kernel gets from a first-index argmin
// inside a chunk plus a strict '<' across chunks.
//
// What bounds it on the H100: integer ALU work (about a dozen 32-bit
// operations per hash) and, at the paper's budget (20 clients x 10240
// attempts, about 2e5 hashes), the launch itself. No input is streamed: the
// nonces are generated in registers.
//
// Design: a grid of (nonce tiles x clients); each thread hashes a strided
// slice of its tile. A candidate is packed as the u64 (hash << 32) | j, so
// the smaller key is the smaller hash and, on a tie, the smaller j: one
// integer min gives the first-index argmin. Each block reduces its tile
// (warp shuffles, then one warp over the warp results) and does one
// atomicMin into the client's slot, which is set to ~0 first. Integer min is
// order-free, so the result is deterministic and does not depend on the tile
// size. prev_hash, the nonce offset and the payloads are read from device
// memory, so a round never waits on the host. A second tiny kernel unpacks
// the keys into (hash, nonce) words held in int64.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM1 = 2654435761u;
constexpr uint32_t kM2 = 2246822519u;
constexpr uint32_t kM3 = 3266489917u;
constexpr int kThreads = 256;
constexpr unsigned long long kNone = ~0ull;

__device__ __forceinline__ uint32_t avalanche(uint32_t h) {
  h ^= h >> 15;
  h *= kM2;
  h ^= h >> 13;
  h *= kM3;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    unsigned long long o = __shfl_xor_sync(0xffffffffu, v, s);
    v = o < v ? o : v;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
race_kernel(const int64_t* __restrict__ prev_hash,
            const int64_t* __restrict__ nonce_offset,
            const int64_t* __restrict__ payloads, uint32_t n_attempts,
            uint32_t tile, unsigned long long* __restrict__ best) {
  __shared__ unsigned long long warp_best[kThreads / 32];
  const int c = blockIdx.y;
  const uint32_t prev = static_cast<uint32_t>(prev_hash[0]);
  const uint32_t off = static_cast<uint32_t>(nonce_offset[0]);
  const uint32_t h0 = avalanche((prev * kM1) ^ static_cast<uint32_t>(payloads[c]));
  const uint32_t start = blockIdx.x * tile;
  const uint32_t end = min(start + tile, n_attempts);

  unsigned long long key = kNone;
  for (uint32_t j = start + threadIdx.x; j < end; j += kThreads) {
    const uint32_t h = avalanche(h0 ^ (off + j));
    const unsigned long long k = (static_cast<unsigned long long>(h) << 32) | j;
    key = k < key ? k : key;
  }
  key = warp_min(key);
  if ((threadIdx.x & 31) == 0) warp_best[threadIdx.x >> 5] = key;
  __syncthreads();
  if (threadIdx.x < 32) {
    key = threadIdx.x < kThreads / 32 ? warp_best[threadIdx.x] : kNone;
    key = warp_min(key);
    if (threadIdx.x == 0 && key != kNone) atomicMin(best + c, key);
  }
}

__global__ void unpack_kernel(const int64_t* __restrict__ nonce_offset,
                              const unsigned long long* __restrict__ best,
                              int n_clients, int64_t* __restrict__ out_hash,
                              int64_t* __restrict__ out_nonce) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_clients) return;
  const unsigned long long k = best[c];
  const uint32_t h = static_cast<uint32_t>(k >> 32);
  const uint32_t j = static_cast<uint32_t>(k);
  const uint32_t off = static_cast<uint32_t>(nonce_offset[0]);
  out_hash[c] = h;
  // The reference's running minimum starts at (0xFFFFFFFF, nonce 0) and
  // only a strictly smaller hash replaces it: a client whose every hash is
  // 0xFFFFFFFF keeps nonce 0.
  out_nonce[c] = h == 0xFFFFFFFFu ? 0 : static_cast<int64_t>(off + j);
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// prev_hash, nonce_offset: int64 [1]; payloads: int64 [n_clients] (salted);
// scratch: u64 [n_clients]; out_hash, out_nonce: int64 [n_clients].
extern "C" int repro_pow_race(const void* prev_hash, const void* nonce_offset,
                              const void* payloads, int n_clients,
                              int n_attempts, int tile, void* scratch,
                              void* out_hash, void* out_nonce, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* best = static_cast<unsigned long long*>(scratch);
  cudaError_t err = cudaMemsetAsync(best, 0xFF, sizeof(unsigned long long) * n_clients, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_attempts + tile - 1) / tile, n_clients);
  race_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const int64_t*>(prev_hash), static_cast<const int64_t*>(nonce_offset),
      static_cast<const int64_t*>(payloads), static_cast<uint32_t>(n_attempts),
      static_cast<uint32_t>(tile), best);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  unpack_kernel<<<(n_clients + 127) / 128, 128, 0, s>>>(
      static_cast<const int64_t*>(nonce_offset), best, n_clients,
      static_cast<int64_t*>(out_hash), static_cast<int64_t*>(out_nonce));
  return static_cast<int>(cudaGetLastError());
}
