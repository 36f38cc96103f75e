// Angular nearest-neighbour match, VIIRS pixels -> CrIS fields of view,
// for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/colocate/colocate.py
// (`_kernel`, launched by `colocate_kernel`): for each unit vector u[i]
// (N of them, 3 floats each) the best fp32 cosine against los[j] (M of
// them) and its index, ties to the lowest index.
//
// What bounds it on this card: instruction issue on the CUDA cores. The
// function needs three fp32 instructions a (pixel, FOV) pair (the dot
// product below) and one maximum, so four issued instructions a pair is the
// floor of an exact kernel; the bytes are only (N + M) * 12 in and N * 8
// out. K = 3 is far too thin for tensor cores, and near the best match
// neighbouring cosines are one or two fp32 ulps apart, so a TF32 or bf16
// product cannot even serve as a filter.
//
// What the design does about it:
//  * Register-blocked rows. A thread owns kRows u rows in registers; a
//    block of kThreads stages tiles of kTileM los rows in shared memory as
//    float4, and each 16-byte broadcast load of one FOV serves kRows pairs.
//  * An fmaxf running maximum, no per-pair index. The FOVs are walked in
//    ascending order in sub-tiles of kSub (fully unrolled); a pair costs
//    FMUL, FFMA, FFMA, FMNMX. After each sub-tile a row whose running
//    maximum rose strictly records that sub-tile's first FOV. Strict `>`
//    across ascending sub-tiles is the Pallas tile merge's rule, so the
//    first sub-tile that reaches the maximum wins.
//  * One deferred rescan. At the end each row recomputes the same products
//    over its one winning sub-tile (from global memory, L2-resident) and
//    takes the first FOV whose cosine equals the maximum: its index, and
//    its recomputed cosine as the bits of the result. The first index that
//    reaches the maximum lies in the first sub-tile whose maximum equals
//    it, so the result is the first-maximum answer of a per-pair compare.
//  * A ragged last sub-tile is padded with NaN FOVs: fmaxf ignores NaN, so
//    the unrolled loop needs no mask. M = 0 leaves every row at (0, -inf).
//  * The dot is the fused chain fma(u2, l2, fma(u1, l1, u0 * l0)) written
//    with explicit intrinsics (__fmul_rn, __fmaf_rn), so nvcc can neither
//    contract nor reorder it. That is the arithmetic of the plain PyTorch
//    version (an exactly rounded fma built from float64 ops) and of XLA's
//    CPU dot in the JAX package, so near-ties among millions of pixels
//    resolve identically in all three.
//  * Blocks are small (kThreads * kRows = 512 rows), so the last blocks of
//    a launch leave little of the card idle: a full granule is 4,800
//    blocks, 36.4 a streaming multiprocessor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 4;     // u rows a thread owns
constexpr int kSub = 32;     // FOVs a sub-tile: one fmaxf run, then one merge
constexpr int kTileM = 512;  // FOVs a shared-memory tile, a multiple of kSub
constexpr int kBlockRows = kThreads * kRows;
static_assert(kTileM % kSub == 0, "a tile holds whole sub-tiles");

__device__ __forceinline__ float dot3(float u0, float u1, float u2, float l0, float l1,
                                      float l2) {
  return __fmaf_rn(u2, l2, __fmaf_rn(u1, l1, __fmul_rn(u0, l0)));
}

__global__ void __launch_bounds__(kThreads)
colocate_kernel(const float* __restrict__ u, const float* __restrict__ los, int n, int m,
                int* __restrict__ idx, float* __restrict__ cos_out) {
  __shared__ float4 tile[kTileM];
  const float neg_inf = __int_as_float(0xff800000);
  const float nan = __int_as_float(0x7fffffff);
  const long long row0 = static_cast<long long>(blockIdx.x) * kBlockRows + threadIdx.x;
  float u0[kRows], u1[kRows], u2[kRows], run[kRows], best[kRows];
  int sub[kRows];  // first FOV of the winning sub-tile, -1 while none
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long row = row0 + r * kThreads;  // a warp's lanes on neighbouring rows
    u0[r] = u1[r] = u2[r] = 0.f;
    if (row < n) {
      u0[r] = u[3 * row];
      u1[r] = u[3 * row + 1];
      u2[r] = u[3 * row + 2];
    }
    run[r] = best[r] = neg_inf;
    sub[r] = -1;
  }
  for (int j0 = 0; j0 < m; j0 += kTileM) {
    const int cnt = min(kTileM, m - j0);
    const int nsub = (cnt + kSub - 1) / kSub;
    __syncthreads();  // the previous tile is no longer read
    for (int k = threadIdx.x; k < nsub * kSub; k += kThreads) {
      if (k < cnt) {
        const float* l = los + 3LL * (j0 + k);
        tile[k] = make_float4(l[0], l[1], l[2], 0.f);
      } else {
        tile[k] = make_float4(nan, nan, nan, nan);
      }
    }
    __syncthreads();
    for (int s = 0; s < nsub; ++s) {
      const float4* t = tile + s * kSub;
#pragma unroll
      for (int k = 0; k < kSub; ++k) {
        const float4 l = t[k];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          run[r] = fmaxf(run[r], dot3(u0[r], u1[r], u2[r], l.x, l.y, l.z));
        }
      }
      const int jb = j0 + s * kSub;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (run[r] > best[r]) {
          best[r] = run[r];
          sub[r] = jb;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long row = row0 + r * kThreads;
    if (row >= n) continue;
    int arg = 0;
    float val = neg_inf;
    if (sub[r] >= 0) {
      const int end = min(sub[r] + kSub, m);
      for (int j = sub[r]; j < end; ++j) {
        const float* l = los + 3LL * j;
        const float d = dot3(u0[r], u1[r], u2[r], __ldg(l), __ldg(l + 1), __ldg(l + 2));
        if (d == best[r]) {
          arg = j;
          val = d;
          break;
        }
      }
    }
    idx[row] = arg;
    cos_out[row] = val;
  }
}

}  // namespace

// u: float32[n, 3], los: float32[m, 3], both contiguous; idx: int32[n],
// cos_out: float32[n]. Returns cudaGetLastError().
extern "C" int colocate_match(const void* u, const void* los, int n, int m, void* idx,
                              void* cos_out, void* stream) {
  if (n <= 0) return 0;
  const unsigned grid =
      static_cast<unsigned>((static_cast<long long>(n) + kBlockRows - 1) / kBlockRows);
  colocate_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(los), n, m,
      static_cast<int*>(idx), static_cast<float*>(cos_out));
  return static_cast<int>(cudaGetLastError());
}
