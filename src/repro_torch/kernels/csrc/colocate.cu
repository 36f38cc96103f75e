// Angular nearest-neighbour match, VIIRS pixels -> CrIS fields of view,
// for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/colocate/colocate.py
// (`_kernel`, launched by `colocate_kernel`): for each unit vector u[i]
// (N of them, 3 floats each) the best fp32 cosine against los[j] (M of
// them) and its index, ties to the lowest index.
//
// What bounds it on this card: arithmetic. The dot products are N * M * 3
// multiply-adds on the fp32 CUDA cores (67 TFLOP/s); the bytes are only
// (N + M) * 12 in and N * 8 out. K = 3 is far too thin for tensor cores,
// and TF32 would flip near-tie argmaxes, so neither is used.
//
// What the design does about it:
//  * One thread owns one u row in registers and keeps its running
//    (best, arg) there; a block of 256 threads stages tiles of 1024 los
//    rows in shared memory as float4 (one 16-byte broadcast load per pair),
//    walking the tiles in ascending order. A strict `>` keeps the first
//    maximum, which is the Pallas tile merge's tie rule.
//  * The loop stops at the true M, so no -inf padding is needed.
//  * The dot is the fused chain fma(u2, l2, fma(u1, l1, u0 * l0)) written
//    with explicit intrinsics (__fmul_rn, __fmaf_rn), so nvcc can neither
//    contract nor reorder it. That is the arithmetic of the plain PyTorch
//    version (an exactly rounded fma built from float64 ops) and of XLA's
//    CPU dot in the JAX package, so near-ties among millions of pixels
//    resolve identically in all three.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileM = 1024;

__global__ void __launch_bounds__(kThreads)
colocate_kernel(const float* __restrict__ u, const float* __restrict__ los, int n, int m,
                int* __restrict__ idx, float* __restrict__ cos_out) {
  __shared__ float4 tile[kTileM];
  const long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  float u0 = 0.f, u1 = 0.f, u2 = 0.f;
  if (row < n) {
    u0 = u[3 * row];
    u1 = u[3 * row + 1];
    u2 = u[3 * row + 2];
  }
  float best = __int_as_float(0xff800000);  // -inf
  int arg = 0;
  for (int j0 = 0; j0 < m; j0 += kTileM) {
    const int cnt = min(kTileM, m - j0);
    __syncthreads();  // the previous tile is no longer read
    for (int k = threadIdx.x; k < cnt; k += kThreads) {
      const float* l = los + 3LL * (j0 + k);
      tile[k] = make_float4(l[0], l[1], l[2], 0.f);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < cnt; ++k) {
      const float4 l = tile[k];
      const float d = __fmaf_rn(u2, l.z, __fmaf_rn(u1, l.y, __fmul_rn(u0, l.x)));
      if (d > best) {
        best = d;
        arg = j0 + k;
      }
    }
  }
  if (row < n) {
    idx[row] = arg;
    cos_out[row] = best;
  }
}

}  // namespace

// u: float32[n, 3], los: float32[m, 3], both contiguous; idx: int32[n],
// cos_out: float32[n]. Returns cudaGetLastError().
extern "C" int colocate_match(const void* u, const void* los, int n, int m, void* idx,
                              void* cos_out, void* stream) {
  if (n <= 0) return 0;
  const unsigned grid = static_cast<unsigned>((static_cast<long long>(n) + kThreads - 1) / kThreads);
  colocate_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(los), n, m,
      static_cast<int*>(idx), static_cast<float*>(cos_out));
  return static_cast<int>(cudaGetLastError());
}
