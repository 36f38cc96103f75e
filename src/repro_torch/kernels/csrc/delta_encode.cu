// Per-chunk changed bitmap for incremental CMIs (paper §Q3), for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/delta_encode/
// delta_encode.py (`_kernel`, launched by `delta_encode_blocks`): for two
// equal-shaped arrays cut into the serializer's axis-0 chunks of `rows`
// rows, did any bit of chunk i change?
//
// What bounds it on this card: device-memory bandwidth. It reads both
// arrays once and writes one int per chunk, so the least time is
// 2 * bytes / 3.35 TB/s; there is no arithmetic to speak of.
//
// What the design does about it:
//  * The arrays are compared as raw bytes, whatever their dtype, so no
//    widening to u32 lanes and no u64 lane split as on the TPU. That also
//    makes the comparison bitwise: NaN payloads and -0.0/+0.0 count.
//  * Chunk c covers bytes [c * chunk_len, min((c + 1) * chunk_len, total)).
//    The 1-D grid is (chunk, tile) flattened: each block takes one TILE of
//    one chunk, so tiles never straddle chunks and no block needs to know
//    the dtype. The ragged last chunk is masked by `total`; nothing is
//    padded or copied.
//  * Each thread reads 16 bytes per load (uint4) where the two inputs are
//    equally aligned, with byte loops for the unaligned head and the tail,
//    and ORs the XOR of the pair into one register.
//  * The block reduces with __syncthreads_or and one thread atomicOr's the
//    chunk's flag, which the wrapper zeroed. Blocks run in any order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kTile = 16384;  // bytes of one chunk per block

__global__ void __launch_bounds__(kThreads)
changed_blocks_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                      long long total, long long chunk_len, long long tiles_per_chunk,
                      int* __restrict__ flags) {
  const long long t = blockIdx.x;
  const long long chunk = t / tiles_per_chunk;
  const long long c0 = chunk * chunk_len;
  const long long lo = c0 + (t - chunk * tiles_per_chunk) * kTile;
  long long hi = lo + kTile;
  if (hi > c0 + chunk_len) hi = c0 + chunk_len;
  if (hi > total) hi = total;

  unsigned int diff = 0;
  if (lo < hi) {
    const uint8_t* pa = a + lo;
    const uint8_t* pb = b + lo;
    const long long n = hi - lo;
    const unsigned ma = static_cast<unsigned>(reinterpret_cast<uintptr_t>(pa) & 15);
    const unsigned mb = static_cast<unsigned>(reinterpret_cast<uintptr_t>(pb) & 15);
    if (ma == mb) {
      long long head = ma ? 16 - ma : 0;
      if (head > n) head = n;
      const long long nvec = (n - head) >> 4;
      const long long tail = head + (nvec << 4);
      for (long long i = threadIdx.x; i < head; i += kThreads) diff |= pa[i] ^ pb[i];
      const uint4* va = reinterpret_cast<const uint4*>(pa + head);
      const uint4* vb = reinterpret_cast<const uint4*>(pb + head);
#pragma unroll 4
      for (long long i = threadIdx.x; i < nvec; i += kThreads) {
        const uint4 x = __ldg(va + i);
        const uint4 y = __ldg(vb + i);
        diff |= (x.x ^ y.x) | (x.y ^ y.y) | (x.z ^ y.z) | (x.w ^ y.w);
      }
      for (long long i = tail + threadIdx.x; i < n; i += kThreads) diff |= pa[i] ^ pb[i];
    } else {
      for (long long i = threadIdx.x; i < n; i += kThreads) diff |= pa[i] ^ pb[i];
    }
  }
  if (__syncthreads_or(diff != 0) && threadIdx.x == 0) atomicOr(flags + chunk, 1);
}

}  // namespace

// flags: int32[nblocks], zeroed by the caller. Returns cudaGetLastError().
extern "C" int delta_encode_changed_blocks(const void* a, const void* b, long long total,
                                           long long chunk_len, long long nblocks,
                                           void* flags, void* stream) {
  if (total <= 0 || chunk_len <= 0 || nblocks <= 0) return 0;
  const long long tiles_per_chunk = (chunk_len + kTile - 1) / kTile;
  const long long grid = nblocks * tiles_per_chunk;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  changed_blocks_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b), total, chunk_len,
      tiles_per_chunk, static_cast<int*>(flags));
  return static_cast<int>(cudaGetLastError());
}
