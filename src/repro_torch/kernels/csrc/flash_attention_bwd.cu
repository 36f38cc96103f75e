// Backward of GQA flash attention (causal and/or sliding window) for Hopper:
// the gradient of K3 (csrc/flash_attention.cu) under autograd.
//
// Replaces no Pallas kernel: the TPU kernel src/repro/kernels/
// flash_attention/flash_attention.py (`flash_attention_padded`) has no
// backward, and the JAX package differentiates its plain
// `blockwise_attention` (src/repro/models/attention.py) with jax.grad. The
// port has this file because its training path needs K3's gradient on the
// card, and the plain backward there (`flash_attention_backward_plain`,
// kernels/flash_attention/ops.py) materialises every score: it computes
// what that function computes, with the same mask. Given q (B, H, Sq, D),
// k (B, Hkv, Sk, D), v (B, Hkv, Sk, Dv), the forward's output o and row
// log-sum-exp lse ((B, H, Sq) float32, +inf for a row with no visible key)
// and dO,
//   P = exp(scale q k^T - lse) on visible pairs, 0 elsewhere,
//   dV = P^T dO,  dP = dO v^T,  dS = P * (dP - D),  D = rowsum(dO * o),
//   dQ = scale dS k,  dK = scale dS^T q,
// a kv head's dK and dV summed over its G = H / Hkv query heads; every
// gradient in the inputs' dtype from float32 sums.
//
// Three kernels a backward, each sum in a fixed order, no atomics: two runs
// on the same inputs give the same bits (the trainer's bitwise resume
// depends on it):
//  1. flash_bwd_delta: D for every row, float32, into a scratch buffer (one
//     warp a row, a fixed butterfly sum).
//  2. flash_bwd_dkdv*: a block per (batch, kv head, key tile). It walks the
//     G query heads and, of each, only the 64-row query tiles that hold a
//     visible pair (causal and window tiles skipped, as the forward skips
//     them), recomputes S^T = k q^T and dP^T = v dO^T for the tile, forms
//     P^T and dS^T, and adds dV += P^T dO and dK += dS^T q into float32
//     accumulators, written once at the end.
//  3. flash_bwd_dq*: a block per (batch, q head, query tile), walking the
//     visible key tiles: S and dP recomputed, dQ += dS k.
// FlashAttention-2 and -3 fold dQ into the dK/dV pass with atomic adds,
// whose order changes from run to run; the pass of its own costs S and dP
// once more.
//
// What bounds it on this card: arithmetic. The least work is 2 (3 D + 2 Dv)
// operations a visible pair, batch row and head (dQ's, dK's and S's over
// D; dV's and dP's over Dv): at qwen3-1.7b's training shape (B 4, H 16,
// Hkv 8, Sq = Sk = 2048, D = 128, causal) 1.72e11 operations against 67 MB
// of q, k, v, o, dO and gradients, 0.174 ms at the bf16 tensor-core rate
// (989 TFLOP/s) against 0.02 ms at 3.35 TB/s. The tensor-core kernels run
// more: the dQ pass repeats S and dP, and P and dS keep their float32
// values as bf16 hi = bf16(x) and lo = bf16(x - hi), two products each
// (rounded once to bf16, dS put a key's dK 1.4e-2 from the float32 answer,
// above the tests' 1e-2, where thousands of queries' terms cancel: G 8 at
// 2,304 positions). Their own floor is 2 (6 D + 5 Dv) operations a pair,
// 2.2x the least work at Dv = D.
//
// Two variants, as the forward has two, chosen by the caller:
//
// *_wgmma (bf16 at (D, Dv) = (64, 64), (128, 128), (192, 128); entry
// flash_attention_bwd_mma): FlashAttention-3's backward without its dQ
// atomics, in the forward's shape (flash_fwd_kernel_wgmma): a producer
// warpgroup, one thread of which issues TMA loads into a ring of stages
// with full and empty mbarriers, and two consumer warpgroups running wgmma,
// setmaxnreg moving registers from the producer (24 a thread) to the
// consumers (240).
//  * dK/dV: a block of 384 threads per (batch, kv head, 128 keys), the
//    heaviest causal key tiles first; each consumer owns 64 of the keys. k
//    and v are loaded once; q and dO tiles of 64 rows stream through a
//    two-stage ring that both consumers read before it is released, with
//    each tile's 64 lse log2(e) and D values (a 512-byte bulk copy from the
//    delta kernel's tiled scratch, whose rows past Sq hold +inf and 0). Per
//    tile each consumer runs S^T = k q^T and dP^T = v dO^T as chains of SS
//    wgmma m64n64k16 (both operands K-major, as the forward's S = q k^T),
//    forms P^T = exp2(S^T scale log2(e) - lse log2(e)) and dS^T = P^T (dP^T
//    - D) in registers on the accumulators' layout, masking elementwise only
//    tiles that cross the diagonal, the window's edge, Sq or Sk, and adds
//    dV += P^T dO and dK += dS^T q as register-sourced wgmma: the
//    accumulator layout is the A-fragment layout, so hi and lo are packed
//    in place, and dO and q are the MN-major B operands (the forward's PV
//    reads V so). P^T and dS^T never touch shared memory. A consumer skips
//    a tile none of its 64 keys sees.
//  * dQ: a block of 384 threads per (batch, q head, 128 query rows), the
//    heaviest first, 64 rows a consumer; q, dO and the rows' lse and D
//    loaded once, k and v tiles of 64 keys streaming through the ring over
//    the visible tiles. S = q k^T and dP = dO v^T as SS wgmma, dS in
//    registers, dQ += dS k register-sourced with k as the MN-major B.
//  * Every tile is TMA boxes of 64 columns with the 128-byte swizzle, as
//    the forward's; the tensor maps cover the true Sq and Sk, so rows past
//    either load as zeros. dK (x scale), dV and dQ (x scale) are rounded to
//    bf16 once and stored through the outputs' strides, never past Sk or Sq.
//  * Registers a consumer thread holds: the dK/dV pass S^T and dP^T (32 +
//    32 float32), their hi and lo fragments (64) as they replace them, dV
//    (Dv / 2) and dK (D / 2): 128 at (64, 64), 192 at (128, 128), 224 at
//    (192, 128); the dQ pass 64 + dQ (D / 2) + dS's fragments (32). ptxas
//    reports 168 a thread for every instance (the block's share at launch),
//    yet holds (128, 128)'s 192 live values with 0 spills: setmaxnreg does
//    give the consumers 240. (192, 128)'s 224 spilled 336 bytes there, so
//    its dK/dV instance walks each 64-query tile in two 32-query steps
//    (QS = 32: S^T and dP^T as m64n32, 16 + 16 values and 32 of
//    fragments), 192 in all, 0 spills; the other instances take 64-query
//    steps, and the dQ instances spill nothing at 64.
//  * The per-element work between the products bounds these kernels as
//    much as the products do, so it is kept short: exp2 is ex2.approx.ftz
//    (without ftz the compiler wraps it in a denormal range fix), the hi/lo
//    split is integer adds, a mask and byte permutes (the float-to-bf16
//    conversions run at a quarter of the rate), lse and D are read in
//    pairs, dS^T is split while dV's products run, and the consumer's index
//    is broadcast with a shuffle so that ptxas sees the branches that hold
//    wgmmas as warp-uniform (else it serializes them, C7518).
//  * Shared memory (k, v; two stages of q, dO and rows): 66.0 KB at (64,
//    64), 130.0 KB at (128, 128), 162.0 KB at (192, 128); the dQ pass the
//    same. One block an SM.
//
// flash_bwd_dkdv / flash_bwd_dq (float32, and bf16 at other head dims up
// to D 192, Dv 128; entry flash_attention_bwd): the same passes on the
// fp32 CUDA cores, 64 x 64 tiles staged as float32 (rows padded to an odd
// pitch where a warp reads down a column), thread (ty, tx) of 256 owning
// rows 4 ty .. 4 ty + 3 and columns tx + 16 j of the score tile and 4 rows
// of the accumulators; instances (64, 64), (128, 128), (192, 128), the
// smallest that holds both head dims (200 KB of shared memory at the
// largest).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kT = 64;         // rows of every tile: 64 queries or 64 keys
constexpr int kThreads = 256;  // 8 warps (the delta and CUDA-core kernels)
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, Sq) dense
  float* delta;      // scratch: (B, H, Sq) dense, or flash_bwd_delta's TILED layout
  void* dq;
  void* dk;
  void* dv;
  int b, h, hkv, sq, sk, d, vd;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  long long do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
  float scale, scale_log2;
  int causal, window;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as .to(torch.bfloat16)
}

// whether query qpos sees key kpos (both from 0), as ops._visible
__device__ __forceinline__ bool visible(int qpos, int kpos, int sq, int sk, int causal,
                                        int window) {
  return qpos < sq && kpos < sk && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// every pair of the 64-row query tile at q0 and 64-key tile at k0 is visible
__device__ __forceinline__ bool tile_full(int q0, int k0, int sq, int sk, int causal, int window) {
  return q0 + kT <= sq && k0 + kT <= sk && (!causal || k0 + kT - 1 <= q0) &&
         (window <= 0 || q0 + kT - 1 - window < k0);
}

// [begin, end): the queries that see some key of the n-key tile at k0
__device__ __forceinline__ void query_range(int k0, int sq, int sk, int causal, int window,
                                            int& begin, int& end, int n = kT) {
  const int k_last = min(k0 + n, sk) - 1;
  begin = causal ? k0 : 0;
  end = sq;
  if (window > 0) end = min(end, k_last + window);
}

// [begin, end): the keys, from a 64-key tile edge, that some query of the
// n-row tile at q0 sees
__device__ __forceinline__ void key_range(int q0, int sq, int sk, int causal, int window,
                                          int& begin, int& end, int n = kT) {
  const int q_last = min(q0 + n, sq) - 1;
  begin = 0;
  end = sk;
  if (causal) end = min(end, q_last + 1);
  if (window > 0) begin = max(0, q0 - window + 1) / kT * kT;
}

// D = rowsum(dO * o), one warp a row, into p.delta: (B, H, Sq) dense; or,
// TILED (the tensor-core kernels), as (B H, ceil(Sq / 64), 2, 64): each
// 64-row tile's lse log2(e), then its D, +inf and 0 past Sq, so a tile's
// 512 bytes are one aligned bulk copy
template <typename T, bool TILED>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta(const Params p) {
  const long long row = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int rows = TILED ? (p.sq + kT - 1) / kT * kT : p.sq;  // a (batch, head)'s
  if (row >= static_cast<long long>(p.b) * p.h * rows) return;
  const int i = static_cast<int>(row % rows);
  const long long bh = row / rows;
  const int bi = static_cast<int>(bh / p.h), hi = static_cast<int>(bh % p.h);
  float acc = 0.f;
  if (i < p.sq) {
    const T* og = static_cast<const T*>(p.o) + bi * p.o_sb + hi * p.o_sh + i * p.o_ss;
    const T* dg = static_cast<const T*>(p.dout) + bi * p.do_sb + hi * p.do_sh + i * p.do_ss;
    for (int e = lane; e < p.vd; e += 32) acc = fmaf(to_f32(dg[e]), to_f32(og[e]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane != 0) return;
  if (!TILED) {
    p.delta[row] = acc;
  } else {
    float* const tile = p.delta + (row / kT) * 2 * kT;
    tile[i % kT] = i < p.sq ? p.lse[bh * p.sq + i] * kLog2e : __int_as_float(0x7f800000);
    tile[kT + i % kT] = acc;
  }
}

template <typename T, bool TILED>
int launch_delta(const Params& p, cudaStream_t stream) {
  const int per_head = TILED ? (p.sq + kT - 1) / kT * kT : p.sq;
  const long long rows = static_cast<long long>(p.b) * p.h * per_head;
  const long long blocks = (rows * 32 + kThreads - 1) / kThreads;
  flash_bwd_delta<T, TILED><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: wgmma, TMA, mbarriers, warp specialisation
// ---------------------------------------------------------------------------

constexpr int kWThreads = 384;         // 2 consumer warpgroups + 1 producer warpgroup
constexpr int kWRows = 128;            // keys (dK/dV) or query rows (dQ) a block, 64 a consumer
constexpr int kBox = 64 * 128;         // bytes of a 64-row, 64-column bf16 box
constexpr int kRowBytes = 2 * kT * 4;  // a 64-row tile's lse log2(e) and D
constexpr int kStages = 2;             // streamed tiles in flight
constexpr int kConsumers = 256;        // threads that release each streamed tile

// `bytes` (a multiple of 16) from global to shared memory, 16-byte aligned
// both, completing on the mbarrier as a TMA load does
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 2^x, flushing a result below 2^-126 to 0 (a probability that small adds
// nothing to a float32 sum of ones)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// returns once at most one committed group of this warpgroup's wgmmas is pending
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// D (64 x 192, float32) += A (64 x 16, registers) * B (16 x 192, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_m64n192k16(float (&d)[96], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x N, float32) += A (64 x 16, registers) * B (16 x N, smem, MN-major,
// N / 64 boxes `kBox` apart)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_m64n64k16(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_m64n128k16(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_m64n192k16(d, a, db);
}

// D (64 x 32, float32) (+)= A (64 x 16, smem) * B (32 x 16, smem)^T, both K-major
__device__ __forceinline__ void wgmma_ss_m64n32k16(float (&d)[16], uint64_t da, uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// x (+)= A B^T over C columns: A's 64 rows at `sa`, B's N rows at `sb`,
// both K-major tiles of C / 64 boxes: a chain of C / 16 SS wgmma m64nNk16
template <int C, int N>
__device__ __forceinline__ void wgmma_abt(float (&x)[N / 2], uint32_t sa, uint32_t sb) {
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk) {
    const uint32_t step = (kk / 4) * kBox + (kk % 4) * 32;  // 16 columns within a 128-byte row
    const uint64_t da = smem_desc(sa + step, 16, 1024), db = smem_desc(sb + step, 16, 1024);
    if constexpr (N == 64)
      wgmma_ss_m64n64k16(x, da, db, kk > 0);
    else
      wgmma_ss_m64n32k16(x, da, db, kk > 0);
  }
}

// a 64 x N float32 accumulator as the bf16 A fragments of its N / 16
// 16-column slices, hi = bf16(x) and lo = bf16(x - hi), each rounded to
// nearest (ties away from zero) on the bits: adding 2^15 to a float32's bit
// pattern and keeping its upper half rounds it to bf16, and x - hi is exact.
// Integer adds, a mask and byte permutes, where the conversion instructions
// run at a quarter of their rate. Slice kk's registers are x[8 kk .. 8 kk +
// 7] in pairs.
template <int N>
__device__ __forceinline__ void split_hi_lo(const float (&x)[N / 2], uint32_t (&hi)[N / 16][4],
                                            uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x0 = x[8 * kk + 2 * e], x1 = x[8 * kk + 2 * e + 1];
      const uint32_t h0 = __float_as_uint(x0) + 0x8000u, h1 = __float_as_uint(x1) + 0x8000u;
      const uint32_t l0 = __float_as_uint(x0 - __uint_as_float(h0 & 0xffff0000u)) + 0x8000u;
      const uint32_t l1 = __float_as_uint(x1 - __uint_as_float(h1 & 0xffff0000u)) + 0x8000u;
      hi[kk][e] = __byte_perm(h0, h1, 0x7632);  // the upper halves: x0's low, x1's high
      lo[kk][e] = __byte_perm(l0, l1, 0x7632);
    }
  }
}

// acc * scale (this thread's rows r0 and r0 + 8 of an m64nN accumulator,
// its columns 8 j + cq and + 1) into rows r_base + row < n of a bf16 matrix
// with row stride ss
template <int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N / 2], __nv_bfloat16* g,
                                           long long ss, int r_base, int n, float scale, int r0,
                                           int cq) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r_base + r0 + 8 * half;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(g + r * ss + 8 * j + cq) = __floats2bfloat162_rn(
          acc[4 * j + 2 * half] * scale, acc[4 * j + 2 * half + 1] * scale);
  }
}

// either pass: 1024 bytes of alignment slack, 2 x 64 rows of D + Dv loaded
// once (k and v, or q and dO), the stages' 64 rows of D + Dv, the stages'
// or both consumers' rows of lse and D, the mbarriers
template <int D, int DV>
constexpr int wgmma_smem_bytes() {
  return 1024 + (2 + kStages) * (D + DV) / 64 * kBox + (kStages > 2 ? kStages : 2) * kRowBytes +
         (1 + 2 * kStages) * 8;
}

// QS: the queries of a step, 64 or 32 (a query tile in two halves, where
// S^T and dP^T at 64 would not leave the consumer's registers for dK)
template <int D, int DV, int QS>
__global__ void __launch_bounds__(kWThreads, 1)
    flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do, const Params p) {
  static_assert((D == 64 && DV == 64) || (D == 128 && DV == 128) || (D == 192 && DV == 128),
                "(D, Dv) is (64, 64), (128, 128) or (192, 128)");
  static_assert(QS == 64 || QS == 32, "a step is 64 or 32 queries");
  constexpr int NB = D / 64, VB = DV / 64;  // 64-column boxes a q or k row, a v or dO row
  constexpr int KW = NB * kBox, VW = VB * kBox;  // a consumer's 64 keys of k, of v
  constexpr int QT = NB * kBox, OT = VB * kBox;  // a 64-row query tile of q, of dO

  // shared memory, 1024-byte aligned for the swizzle: k and v (both
  // consumers' keys), the stages' q, dO and rows, then the mbarriers
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t sK = base, sV = sK + 2 * KW, sQ = sV + 2 * VW, sO = sQ + kStages * QT;
  const uint32_t sR = sO + kStages * OT, bars = sR + kStages * kRowBytes;
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + kStages + s); };

  const int bi = blockIdx.x / p.hkv, kvh = blockIdx.x % p.hkv;
  const int groups = p.h / p.hkv;
  const int k0 = blockIdx.y * kWRows;  // the heaviest causal key tiles first
  int q_begin, q_end;
  query_range(k0, p.sq, p.sk, p.causal, p.window, q_begin, q_end, kWRows);
  const int n_qt = q_end > q_begin ? (q_end - q_begin + kT - 1) / kT : 0;
  const int n_it = groups * n_qt;  // iteration it: head kvh G + it / n_qt, tile it % n_qt
  const int row_tiles = (p.sq + kT - 1) / kT;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  if (warp >= 8) {
    // producer warpgroup: its registers go to the consumers, one thread
    // issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(kv_full, 2 * (KW + VW));
      for (int w = 0; w < 2; ++w) {
        for (int x = 0; x < NB; ++x)
          tma_load(sK + w * KW + x * kBox, &tm_k, kv_full, 64 * x, k0 + 64 * w, kvh, bi);
        for (int x = 0; x < VB; ++x)
          tma_load(sV + w * VW + x * kBox, &tm_v, kv_full, 64 * x, k0 + 64 * w, kvh, bi);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages;
        const int hi = kvh * groups + it / n_qt, q0 = q_begin + (it % n_qt) * kT;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);  // a stage's first use passes at once
        mbar_expect_tx(full(s), QT + OT + kRowBytes);
        for (int x = 0; x < NB; ++x)
          tma_load(sQ + s * QT + x * kBox, &tm_q, full(s), 64 * x, q0, hi, bi);
        for (int x = 0; x < VB; ++x)
          tma_load(sO + s * OT + x * kBox, &tm_do, full(s), 64 * x, q0, hi, bi);
        bulk_load(sR + s * kRowBytes,
                  p.delta + (static_cast<long long>(bi * p.h + hi) * row_tiles + q0 / kT) * 2 * kT,
                  kRowBytes, full(s));
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    // consumer warpgroup: keys 64 wg ..; broadcast, so the compiler sees a
    // warp-uniform value and the branches on it that hold wgmmas as
    // convergent (else it serializes the wgmmas)
    const int wg = __shfl_sync(0xffffffffu, warp / 4, 0);
    const int r0 = 16 * (warp & 3) + lane / 4;  // this thread's keys r0 and r0 + 8
    const int cq = 2 * (lane & 3);              // its first query in each 8-column group
    const int kw0 = k0 + 64 * wg;
    int wq_begin, wq_end;  // the queries that see one of this consumer's keys
    query_range(kw0, p.sq, p.sk, p.causal, p.window, wq_begin, wq_end);
    if (kw0 >= p.sk) wq_end = wq_begin;
    const uint32_t sKw = sK + wg * KW, sVw = sV + wg * VW;

    float dv[DV / 2], dk[D / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) dv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = 0.f;
    mbar_wait(kv_full, 0);

    for (int it = 0; it < n_it; ++it) {
      const int s = it % kStages;
      const int q0 = q_begin + (it % n_qt) * kT;
      mbar_wait(full(s), (it / kStages) & 1);
      const bool full_tile = tile_full(q0, kw0, p.sq, p.sk, p.causal, p.window);
      const float* const lse2 = reinterpret_cast<const float*>(gbase + (sR - base) + s * kRowBytes);
      const float* const dlt = lse2 + kT;
      const bool seen = q0 < wq_end && q0 + kT > wq_begin;  // by one of this consumer's keys
#pragma unroll 1
      for (int c0 = 0; seen && c0 < kT; c0 += QS) {
        // S^T = k q^T and dP^T = v dO^T (keys x queries c0 ..), two groups
        float st[QS / 2], dp[QS / 2];
        wgmma_fence();
        wgmma_abt<D, QS>(st, sKw, sQ + s * QT + c0 * 128);
        wgmma_commit();
        wgmma_abt<DV, QS>(dp, sVw, sO + s * OT + c0 * 128);
        wgmma_commit();
        wgmma_wait_one();
        pin(st);

        // P^T on the accumulator's layout: st[4j + e] is key (e < 2 ? r0 :
        // r0 + 8), query c0 + 8j + cq + (e & 1) of the tile
#pragma unroll
        for (int j = 0; j < QS / 8; ++j) {  // queries c and c + 1 of keys r0, r0 + 8
          const int c = c0 + 8 * j + cq;
          const float2 l = *reinterpret_cast<const float2*>(lse2 + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            const bool vis = full_tile || visible(q0 + c + (e & 1), kw0 + r0 + (e & 2) * 4, p.sq,
                                                  p.sk, p.causal, p.window);
            // a row without a visible key has lse = +inf: exp2(-inf) = 0
            st[i] = vis ? exp2_ftz(st[i] * p.scale_log2 - ((e & 1) ? l.y : l.x)) : 0.f;
          }
        }
        wgmma_wait_all();
        pin(dp);
#pragma unroll
        for (int j = 0; j < QS / 8; ++j) {
          const float2 dl = *reinterpret_cast<const float2*>(dlt + c0 + 8 * j + cq);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * j + e] = st[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? dl.y : dl.x));
        }

        // dV += P^T dO, dK += dS^T q, each with the hi and lo halves
        uint32_t ph[QS / 16][4], pl[QS / 16][4], sh[QS / 16][4], sl[QS / 16][4];
        split_hi_lo<QS>(st, ph, pl);
        pin(dv);
        pin(dk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < QS / 16; ++kk) {  // 16 queries = 16 rows of 128 bytes
          const uint64_t bo = smem_desc(sO + s * OT + (c0 + 16 * kk) * 128, kBox, 1024);
          wgmma_rs<DV>(dv, ph[kk], bo);
          wgmma_rs<DV>(dv, pl[kk], bo);
        }
        wgmma_commit();
        split_hi_lo<QS>(dp, sh, sl);  // while dV's products run
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < QS / 16; ++kk) {
          const uint64_t bq = smem_desc(sQ + s * QT + (c0 + 16 * kk) * 128, kBox, 1024);
          wgmma_rs<D>(dk, sh[kk], bq);
          wgmma_rs<D>(dk, sl[kk], bq);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(dv);
        pin(dk);
        pin(ph);
        pin(pl);
        pin(sh);
        pin(sl);
      }
      mbar_arrive(empty(s));
    }

    __nv_bfloat16* const dkg = static_cast<__nv_bfloat16*>(p.dk) + bi * p.dk_sb + kvh * p.dk_sh;
    __nv_bfloat16* const dvg = static_cast<__nv_bfloat16*>(p.dv) + bi * p.dv_sb + kvh * p.dv_sh;
    store_rows<D>(dk, dkg, p.dk_ss, kw0, p.sk, p.scale, r0, cq);
    store_rows<DV>(dv, dvg, p.dv_ss, kw0, p.sk, 1.f, r0, cq);
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(kWThreads, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do, const Params p) {
  static_assert((D == 64 && DV == 64) || (D == 128 && DV == 128) || (D == 192 && DV == 128),
                "(D, Dv) is (64, 64), (128, 128) or (192, 128)");
  constexpr int NB = D / 64, VB = DV / 64;
  constexpr int QW = NB * kBox, OW = VB * kBox;  // a consumer's 64 rows of q, of dO
  constexpr int KT = NB * kBox, VT = VB * kBox;  // a 64-key tile of k, of v

  // q and dO (both consumers' rows), the stages' k and v, both consumers'
  // rows of lse and D, then the mbarriers
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t sQ = base, sO = sQ + 2 * QW, sK = sO + 2 * OW, sV = sK + kStages * KT;
  const uint32_t sR = sV + kStages * VT, bars = sR + 2 * kRowBytes;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + kStages + s); };

  const int bi = blockIdx.x / p.h, hi = blockIdx.x % p.h;
  const int kvh = hi / (p.h / p.hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWRows;  // the heaviest causal query tiles first
  int k_begin, k_end;
  key_range(q0, p.sq, p.sk, p.causal, p.window, k_begin, k_end, kWRows);
  const int n_kt = k_end > k_begin ? (k_end - k_begin + kT - 1) / kT : 0;
  const int row_tiles = (p.sq + kT - 1) / kT;
  const int n_rt = min(2, row_tiles - q0 / kT);  // the block's row tiles below Sq

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(q_full, 2 * (QW + OW) + n_rt * kRowBytes);
      for (int w = 0; w < 2; ++w) {
        for (int x = 0; x < NB; ++x)
          tma_load(sQ + w * QW + x * kBox, &tm_q, q_full, 64 * x, q0 + 64 * w, hi, bi);
        for (int x = 0; x < VB; ++x)
          tma_load(sO + w * OW + x * kBox, &tm_do, q_full, 64 * x, q0 + 64 * w, hi, bi);
      }
      bulk_load(sR, p.delta + (static_cast<long long>(bi * p.h + hi) * row_tiles + q0 / kT) * 2 * kT,
                n_rt * kRowBytes, q_full);
      for (int it = 0; it < n_kt; ++it) {
        const int s = it % kStages;
        const int k0 = k_begin + it * kT;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), KT + VT);
        for (int x = 0; x < NB; ++x)
          tma_load(sK + s * KT + x * kBox, &tm_k, full(s), 64 * x, k0, kvh, bi);
        for (int x = 0; x < VB; ++x)
          tma_load(sV + s * VT + x * kBox, &tm_v, full(s), 64 * x, k0, kvh, bi);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = __shfl_sync(0xffffffffu, warp / 4, 0);  // rows 64 wg .., warp-uniform
    const int r0 = 16 * (warp & 3) + lane / 4;  // this thread's rows r0 and r0 + 8
    const int cq = 2 * (lane & 3);              // its first key in each 8-column group
    const int qw0 = q0 + 64 * wg;
    int wk_begin, wk_end;  // the keys one of this consumer's rows sees
    key_range(qw0, p.sq, p.sk, p.causal, p.window, wk_begin, wk_end);
    if (qw0 >= p.sq) wk_end = wk_begin;
    const uint32_t sQw = sQ + wg * QW, sOw = sO + wg * OW;

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    mbar_wait(q_full, 0);
    float lse0 = 0.f, lse1 = 0.f, d0 = 0.f, d1 = 0.f;
    if (qw0 < p.sq) {
      const float* const rows = reinterpret_cast<const float*>(gbase + (sR - base) + wg * kRowBytes);
      lse0 = rows[r0];
      lse1 = rows[r0 + 8];
      d0 = rows[kT + r0];
      d1 = rows[kT + r0 + 8];
    }

    for (int it = 0; it < n_kt; ++it) {
      const int s = it % kStages;
      const int k0 = k_begin + it * kT;
      mbar_wait(full(s), (it / kStages) & 1);
      if (k0 < wk_end && k0 + kT > wk_begin) {
        // S = q k^T and dP = dO v^T (queries x keys), two groups
        float sc[32], dp[32];
        wgmma_fence();
        wgmma_abt<D, 64>(sc, sQw, sK + s * KT);
        wgmma_commit();
        wgmma_abt<DV, 64>(dp, sOw, sV + s * VT);
        wgmma_commit();
        wgmma_wait_one();
        pin(sc);

        // P on the accumulator's layout: sc[4j + e] is row (e < 2 ? r0 :
        // r0 + 8), key 8j + cq + (e & 1) of the tile
        const bool full_tile = tile_full(qw0, k0, p.sq, p.sk, p.causal, p.window);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int c = 8 * (i / 4) + cq + (i & 1);
          const bool vis = full_tile || visible(qw0 + r0 + (i & 2) * 4, k0 + c, p.sq, p.sk,
                                                p.causal, p.window);
          sc[i] = vis ? exp2_ftz(sc[i] * p.scale_log2 - ((i & 2) ? lse1 : lse0)) : 0.f;
        }
        wgmma_wait_all();
        pin(dp);
#pragma unroll
        for (int i = 0; i < 32; ++i) dp[i] = sc[i] * (dp[i] - ((i & 2) ? d1 : d0));

        // dQ += dS k, with the hi and lo halves
        uint32_t sh[4][4], sl[4][4];
        split_hi_lo<64>(dp, sh, sl);
        pin(dq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // 16 keys = 16 rows of 128 bytes
          const uint64_t bk = smem_desc(sK + s * KT + kk * 16 * 128, kBox, 1024);
          wgmma_rs<D>(dq, sh[kk], bk);
          wgmma_rs<D>(dq, sl[kk], bk);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(dq);
        pin(sh);
        pin(sl);
      }
      mbar_arrive(empty(s));
    }

    __nv_bfloat16* const dqg = static_cast<__nv_bfloat16*>(p.dq) + bi * p.dq_sb + hi * p.dq_sh;
    store_rows<D>(dq, dqg, p.dq_ss, qw0, p.sq, p.scale, r0, cq);
  }
}

template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// the tiled delta kernel, then the dK/dV kernel (a block per batch, kv head
// and 128 keys) and the dQ kernel (a block per batch, q head and 128 rows)
template <int D, int DV>
int launch_wgmma(const Params& p, const CUtensorMap (&m)[4], cudaStream_t stream) {
  constexpr int bytes = wgmma_smem_bytes<D, DV>();
  constexpr int QS = D == 192 ? 32 : 64;  // dK's 96 registers leave room for 32-query steps only
  int err = allow_smem(flash_bwd_dkdv_wgmma<D, DV, QS>, bytes);
  if (!err) err = allow_smem(flash_bwd_dq_wgmma<D, DV>, bytes);
  if (!err) err = launch_delta<__nv_bfloat16, true>(p, stream);
  if (err) return err;
  const dim3 kv_grid(static_cast<unsigned>(p.b * p.hkv),
                     static_cast<unsigned>((p.sk + kWRows - 1) / kWRows));
  flash_bwd_dkdv_wgmma<D, DV, QS><<<kv_grid, kWThreads, bytes, stream>>>(m[0], m[1], m[2], m[3], p);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const dim3 q_grid(static_cast<unsigned>(p.b * p.h),
                    static_cast<unsigned>((p.sq + kWRows - 1) / kWRows));
  flash_bwd_dq_wgmma<D, DV><<<q_grid, kWThreads, bytes, stream>>>(m[0], m[1], m[2], m[3], p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the fp32 CUDA cores: float32, and bf16 at other head dims
// ---------------------------------------------------------------------------

// rows r0 .. r0 + kT - 1, columns < cols of a matrix with row stride ss into
// a float32 tile of pitch PITCH and COLS columns; zeros past n rows or cols
template <int COLS, int PITCH, typename T>
__device__ __forceinline__ void load_tile_f32(float* dst, const T* g, long long ss, int r0, int n,
                                              int cols) {
  for (int i = threadIdx.x; i < kT * COLS; i += kThreads) {
    const int r = i / COLS, c = i % COLS;
    float x = 0.f;
    if (r0 + r < n && c < cols) x = to_f32(g[(r0 + r) * ss + c]);
    dst[r * PITCH + c] = x;
  }
}

__device__ __forceinline__ void load_row_f32(float* dst, const float* g, int r0, int n) {
  const int r = threadIdx.x;
  if (r < kT) dst[r] = r0 + r < n ? g[r0 + r] : 0.f;
}

template <int DQK, int DV>
constexpr int dkdv_f32_floats() {  // k, v, q, dO, P^T, dS^T, lse, D
  return kT * (DQK + 4) + kT * (DV + 4) + kT * (DQK + 1) + kT * (DV + 1) + 2 * kT * (kT + 1) +
         2 * kT;
}

template <int DQK, int DV>
constexpr int dq_f32_floats() {  // q, dO, k, v, dS, lse, D
  return kT * (DQK + 4) + kT * (DV + 4) + kT * (DQK + 1) + kT * (DV + 1) + kT * (kT + 1) + 2 * kT;
}

// The minimum of blocks an SM runs is what shared memory allows: two at
// (64, 64), one above, where ptxas may then use up to 255 registers (held
// to 128, the dQ kernel at (192, 128) spilled).
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads, DQK > 64 ? 1 : 2) flash_bwd_dkdv(const Params p) {
  // tiles read one row at a time by a thread's 4 rows (k, v) are padded to
  // DQK + 4; tiles read down a column by the 16 lanes of a row group (q,
  // dO) to an odd pitch; P^T and dS^T to kT + 1
  constexpr int KP = DQK + 4, VP = DV + 4, QP = DQK + 1, OP = DV + 1, PP = kT + 1;
  constexpr int NK = DQK / 16, NV = DV / 16;  // accumulator columns a thread
  extern __shared__ float fsm[];
  float* const sK = fsm;
  float* const sV = sK + kT * KP;
  float* const sQ = sV + kT * VP;
  float* const sO = sQ + kT * QP;
  float* const sP = sO + kT * OP;
  float* const sS = sP + kT * PP;
  float* const sL = sS + kT * PP;
  float* const sD = sL + kT;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bi = blockIdx.x / p.hkv, kvh = blockIdx.x % p.hkv;
  const int groups = p.h / p.hkv;
  const int k0 = blockIdx.y * kT;
  const int sq = p.sq, sk = p.sk, causal = p.causal, window = p.window;
  const float scale = p.scale;

  load_tile_f32<DQK, KP>(sK, static_cast<const T*>(p.k) + bi * p.k_sb + kvh * p.k_sh, p.k_ss, k0,
                         sk, p.d);
  load_tile_f32<DV, VP>(sV, static_cast<const T*>(p.v) + bi * p.v_sb + kvh * p.v_sh, p.v_ss, k0, sk,
                        p.vd);
  int q_begin, q_end;
  query_range(k0, sq, sk, causal, window, q_begin, q_end);
  const int n_qt = q_end > q_begin ? (q_end - q_begin + kT - 1) / kT : 0;

  float dk[4][NK], dv[4][NV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < NK; ++c) dk[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c) dv[i][c] = 0.f;
  }

  for (int it = 0; it < groups * n_qt; ++it) {
    const int hi = kvh * groups + it / n_qt, q0 = q_begin + (it % n_qt) * kT;
    const long long row = (static_cast<long long>(bi) * p.h + hi) * sq;
    __syncthreads();  // the previous tile's q, dO, P^T and dS^T are no longer read
    load_tile_f32<DQK, QP>(sQ, static_cast<const T*>(p.q) + bi * p.q_sb + hi * p.q_sh, p.q_ss, q0,
                           sq, p.d);
    load_tile_f32<DV, OP>(sO, static_cast<const T*>(p.dout) + bi * p.do_sb + hi * p.do_sh,
                          p.do_ss, q0, sq, p.vd);
    load_row_f32(sL, p.lse + row, q0, sq);
    load_row_f32(sD, p.delta + row, q0, sq);
    __syncthreads();

    // S^T and dP^T: keys 4 ty + i, queries tx + 16 j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DQK; ++c) {
      float kv[4], qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) kv[i] = sK[(4 * ty + i) * KP + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) qv[j] = sQ[(tx + 16 * j) * QP + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
    }
#pragma unroll 4
    for (int c = 0; c < DV; ++c) {
      float vv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) vv[i] = sV[(4 * ty + i) * VP + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) ov[j] = sO[(tx + 16 * j) * OP + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        // P = exp(s scale - lse), as the plain version forms it
        const float pv =
            visible(q0 + c, k0 + r, sq, sk, causal, window) ? expf(s[i][j] * scale - sL[c]) : 0.f;
        sP[r * PP + c] = pv;
        sS[r * PP + c] = pv * (dp[i][j] - sD[c]);
      }
    }
    __syncthreads();  // P^T and dS^T complete

    // dV += P^T dO, dK += dS^T q: keys 4 ty + i, columns tx + 16 c
#pragma unroll 4
    for (int qq = 0; qq < kT; ++qq) {
      float pk[4], sk4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pk[i] = sP[(4 * ty + i) * PP + qq];
        sk4[i] = sS[(4 * ty + i) * PP + qq];
      }
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const float ov = sO[qq * OP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) dv[i][c] = fmaf(pk[i], ov, dv[i][c]);
      }
#pragma unroll
      for (int c = 0; c < NK; ++c) {
        const float qv = sQ[qq * QP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) dk[i][c] = fmaf(sk4[i], qv, dk[i][c]);
      }
    }
  }

  T* const dkg = static_cast<T*>(p.dk) + bi * p.dk_sb + kvh * p.dk_sh;
  T* const dvg = static_cast<T*>(p.dv) + bi * p.dv_sb + kvh * p.dv_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + 4 * ty + i;
    if (r >= sk) continue;
#pragma unroll
    for (int c = 0; c < NK; ++c)
      if (tx + 16 * c < p.d) dkg[r * p.dk_ss + tx + 16 * c] = from_f32<T>(dk[i][c] * scale);
#pragma unroll
    for (int c = 0; c < NV; ++c)
      if (tx + 16 * c < p.vd) dvg[r * p.dv_ss + tx + 16 * c] = from_f32<T>(dv[i][c]);
  }
}

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads, DQK > 64 ? 1 : 2) flash_bwd_dq(const Params p) {
  constexpr int QP = DQK + 4, OP = DV + 4, KP = DQK + 1, VP = DV + 1, PP = kT + 1;
  constexpr int NK = DQK / 16;
  extern __shared__ float fsm[];
  float* const sQ = fsm;
  float* const sO = sQ + kT * QP;
  float* const sK = sO + kT * OP;
  float* const sV = sK + kT * KP;
  float* const sS = sV + kT * VP;
  float* const sL = sS + kT * PP;
  float* const sD = sL + kT;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bi = blockIdx.x / p.h, hi = blockIdx.x % p.h;
  const int kvh = hi / (p.h / p.hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kT;  // the heaviest causal query tiles first
  const int sq = p.sq, sk = p.sk, causal = p.causal, window = p.window;
  const float scale = p.scale;
  const T* const kg = static_cast<const T*>(p.k) + bi * p.k_sb + kvh * p.k_sh;
  const T* const vg = static_cast<const T*>(p.v) + bi * p.v_sb + kvh * p.v_sh;

  const long long row = (static_cast<long long>(bi) * p.h + hi) * sq;
  load_tile_f32<DQK, QP>(sQ, static_cast<const T*>(p.q) + bi * p.q_sb + hi * p.q_sh, p.q_ss, q0, sq,
                         p.d);
  load_tile_f32<DV, OP>(sO, static_cast<const T*>(p.dout) + bi * p.do_sb + hi * p.do_sh, p.do_ss,
                        q0, sq, p.vd);
  load_row_f32(sL, p.lse + row, q0, sq);
  load_row_f32(sD, p.delta + row, q0, sq);
  int k_begin, k_end;
  key_range(q0, sq, sk, causal, window, k_begin, k_end);

  float dq[4][NK];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NK; ++c) dq[i][c] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kT) {
    __syncthreads();  // the previous tile's k, v and dS are no longer read
    load_tile_f32<DQK, KP>(sK, kg, p.k_ss, k0, sk, p.d);
    load_tile_f32<DV, VP>(sV, vg, p.v_ss, k0, sk, p.vd);
    __syncthreads();

    // S and dP: queries 4 ty + i, keys tx + 16 j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DQK; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(4 * ty + i) * QP + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * KP + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll 4
    for (int c = 0; c < DV; ++c) {
      float ov[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ov[i] = sO[(4 * ty + i) * OP + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = sV[(tx + 16 * j) * VP + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float pv =
            visible(q0 + r, k0 + c, sq, sk, causal, window) ? expf(s[i][j] * scale - sL[r]) : 0.f;
        sS[r * PP + c] = pv * (dp[i][j] - sD[r]);
      }
    }
    __syncthreads();  // dS complete

    // dQ += dS k: queries 4 ty + i, columns tx + 16 c
#pragma unroll 4
    for (int kk = 0; kk < kT; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sS[(4 * ty + i) * PP + kk];
#pragma unroll
      for (int c = 0; c < NK; ++c) {
        const float kv = sK[kk * KP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[i][c] = fmaf(dsv[i], kv, dq[i][c]);
      }
    }
  }

  T* const dqg = static_cast<T*>(p.dq) + bi * p.dq_sb + hi * p.dq_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= sq) continue;
#pragma unroll
    for (int c = 0; c < NK; ++c)
      if (tx + 16 * c < p.d) dqg[r * p.dq_ss + tx + 16 * c] = from_f32<T>(dq[i][c] * scale);
  }
}

// the delta kernel, then the dK/dV kernel (a block per batch, kv head and
// 64 keys) and the dQ kernel (a block per batch, q head and 64 rows)
template <typename T, typename DkdvKernel, typename DqKernel>
int launch_all(const Params& p, cudaStream_t stream, DkdvKernel dkdv, int dkdv_bytes, DqKernel dq,
               int dq_bytes) {
  int err = allow_smem(dkdv, dkdv_bytes);
  if (!err) err = allow_smem(dq, dq_bytes);
  if (!err) err = launch_delta<T, false>(p, stream);
  if (err) return err;
  const dim3 kv_grid(static_cast<unsigned>(p.b * p.hkv),
                     static_cast<unsigned>((p.sk + kT - 1) / kT));
  dkdv<<<kv_grid, kThreads, dkdv_bytes, stream>>>(p);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const dim3 q_grid(static_cast<unsigned>(p.b * p.h), static_cast<unsigned>((p.sq + kT - 1) / kT));
  dq<<<q_grid, kThreads, dq_bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DQK, int DV>
int launch_f32(const Params& p, cudaStream_t stream) {
  constexpr int bytes = static_cast<int>(sizeof(float));
  return launch_all<T>(p, stream, flash_bwd_dkdv<T, DQK, DV>, dkdv_f32_floats<DQK, DV>() * bytes,
                       flash_bwd_dq<T, DQK, DV>, dq_f32_floats<DQK, DV>() * bytes);
}

bool shape_ok(int b, int h, int hkv, int sq, int sk, int d, int dv) {
  return b > 0 && h > 0 && hkv > 0 && h % hkv == 0 && sq > 0 && sk > 0 && d > 0 && d <= 192 &&
         dv > 0 && dv <= 128 && (sq + kT - 1) / kT <= 65535 && (sk + kT - 1) / kT <= 65535 &&
         static_cast<long long>(b) * h < (1ll << 31);
}

Params make_params(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* delta, void* dq, void* dk, void* dv, int b, int h,
                   int hkv, int sq, int sk, int d, int vd, const long long* st, float scale,
                   int causal, int window) {
  return Params{q, k, v, o, dout, lse, delta, dq, dk, dv, b, h, hkv, sq, sk, d, vd,
                st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
                st[11], st[12], st[13], st[14], st[15], st[16], st[17], st[18], st[19], st[20],
                st[21], st[22], st[23], scale,
                static_cast<float>(static_cast<double>(scale) * 1.4426950408889634), causal,
                window};
}

}  // namespace

// K3's backward: dq, dk, dv (the inputs' dtype, written through their
// strides) from q, k, v, the forward's output o, its lse ((B, H, Sq)
// float32, dense) and dout; delta is a (B, H, Sq) float32 scratch buffer.
// Strides are element strides (batch, head, seq) of q, k, v, o, dout, dq,
// dk, dv in that order, the last dimension dense; d the q and k head dim
// (<= 192), dv the v head dim (<= 128). dtype 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the last launch, or
// cudaErrorInvalidValue for arguments the kernels do not take (Sq or Sk of
// 0 among them: the caller launches nothing there).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, int b, int h, int hkv, int sq, int sk, int d,
                                   int vd, long long q_sb, long long q_sh, long long q_ss,
                                   long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                                   long long v_sh, long long v_ss, long long o_sb, long long o_sh,
                                   long long o_ss, long long do_sb, long long do_sh,
                                   long long do_ss, long long dq_sb, long long dq_sh,
                                   long long dq_ss, long long dk_sb, long long dk_sh,
                                   long long dk_ss, long long dv_sb, long long dv_sh,
                                   long long dv_ss, float scale, int causal, int window, int dtype,
                                   void* stream) {
  if (!shape_ok(b, h, hkv, sq, sk, d, vd)) return static_cast<int>(cudaErrorInvalidValue);
  const long long st[24] = {q_sb,  q_sh,  q_ss,  k_sb,  k_sh,  k_ss,  v_sb,  v_sh,
                            v_ss,  o_sb,  o_sh,  o_ss,  do_sb, do_sh, do_ss, dq_sb,
                            dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss};
  const Params p = make_params(q, k, v, o, dout, lse, delta, dq, dk, dv, b, h, hkv, sq, sk, d, vd,
                               st, scale, causal, window);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the smallest instance that holds both head dims
  const int inst = d <= 64 && vd <= 64 ? 64 : d <= 128 ? 128 : 192;
  if (dtype == 0)
    return inst == 64    ? launch_f32<float, 64, 64>(p, s)
           : inst == 128 ? launch_f32<float, 128, 128>(p, s)
                         : launch_f32<float, 192, 128>(p, s);
  if (dtype == 1)
    return inst == 64    ? launch_f32<__nv_bfloat16, 64, 64>(p, s)
           : inst == 128 ? launch_f32<__nv_bfloat16, 128, 128>(p, s)
                         : launch_f32<__nv_bfloat16, 192, 128>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 tensor-core kernels for (d, dv) = (64, 64), (128, 128) or (192,
// 128); arguments as flash_attention_bwd's, without the dtype, but delta
// holds b h ceil(sq / 64) 128 floats (flash_bwd_delta's tiled scratch,
// 16-byte aligned). q, k, v and dout need a 16-byte aligned base and
// strides in whole 16-byte units (the TMA's rule), and dq, dk, dv 4-byte
// aligned rows; the caller makes a dense copy where a tensor breaks it.
extern "C" int flash_attention_bwd_mma(const void* q, const void* k, const void* v, const void* o,
                                       const void* dout, const float* lse, float* delta, void* dq,
                                       void* dk, void* dv, int b, int h, int hkv, int sq, int sk,
                                       int d, int vd, long long q_sb, long long q_sh,
                                       long long q_ss, long long k_sb, long long k_sh,
                                       long long k_ss, long long v_sb, long long v_sh,
                                       long long v_ss, long long o_sb, long long o_sh,
                                       long long o_ss, long long do_sb, long long do_sh,
                                       long long do_ss, long long dq_sb, long long dq_sh,
                                       long long dq_ss, long long dk_sb, long long dk_sh,
                                       long long dk_ss, long long dv_sb, long long dv_sh,
                                       long long dv_ss, float scale, int causal, int window,
                                       void* stream) {
  const bool taken = (d == 64 && vd == 64) || (d == 128 && vd == 128) || (d == 192 && vd == 128);
  if (!taken || !shape_ok(b, h, hkv, sq, sk, d, vd) || reinterpret_cast<uintptr_t>(delta) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m[4];
  if (!make_map(&m[0], q, d, sq, h, b, q_ss, q_sh, q_sb, 64) ||
      !make_map(&m[1], k, d, sk, hkv, b, k_ss, k_sh, k_sb, 64) ||
      !make_map(&m[2], v, vd, sk, hkv, b, v_ss, v_sh, v_sb, 64) ||
      !make_map(&m[3], dout, vd, sq, h, b, do_ss, do_sh, do_sb, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[24] = {q_sb,  q_sh,  q_ss,  k_sb,  k_sh,  k_ss,  v_sb,  v_sh,
                            v_ss,  o_sb,  o_sh,  o_ss,  do_sb, do_sh, do_ss, dq_sb,
                            dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss};
  const Params p = make_params(q, k, v, o, dout, lse, delta, dq, dk, dv, b, h, hkv, sq, sk, d, vd,
                               st, scale, causal, window);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d == 64    ? launch_wgmma<64, 64>(p, m, s)
         : d == 128 ? launch_wgmma<128, 128>(p, m, s)
                    : launch_wgmma<192, 128>(p, m, s);
}
