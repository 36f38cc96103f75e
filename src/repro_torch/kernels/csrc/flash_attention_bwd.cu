// Backward of GQA flash attention (causal and/or sliding window) for Hopper:
// the gradient of K3 (csrc/flash_attention.cu) under autograd.
//
// Replaces no Pallas kernel: the TPU kernel src/repro/kernels/
// flash_attention/flash_attention.py (`flash_attention_padded`) has no
// backward, and the JAX package differentiates its plain
// `blockwise_attention` (src/repro/models/attention.py) with jax.grad. This
// file is K3's gradient as the port's training path runs it, and computes
// what `flash_attention_backward_plain` (kernels/flash_attention/ops.py)
// computes, with the same mask: given q (B, H, Sq, D), k (B, Hkv, Sk, D),
// v (B, Hkv, Sk, Dv), the forward's output o and row log-sum-exp lse
// ((B, H, Sq) float32, +inf for a row with no visible key) and dO,
//   P = exp(scale q k^T - lse) on visible pairs, 0 elsewhere,
//   dV = P^T dO,  dP = dO v^T,  dS = P * (dP - D),  D = rowsum(dO * o),
//   dQ = scale dS k,  dK = scale dS^T q,
// a kv head's dK and dV summed over its G = H / Hkv query heads; every
// gradient in the inputs' dtype from float32 sums.
//
// Three kernels a backward, each sum in a fixed order, no atomics: two runs
// on the same inputs give the same bits (the trainer's bitwise resume
// depends on it):
//  1. flash_bwd_delta: D for every row, float32, into a (B, H, Sq) scratch
//     buffer (one warp a row, a fixed butterfly sum).
//  2. flash_bwd_dkdv*: one block per (batch, kv head, 64-key tile). It walks
//     the G query heads and, of each, only the 64-row query tiles that hold
//     a visible pair (causal and window tiles skipped, as the forward skips
//     them), recomputes S^T = k q^T and dP^T = v dO^T for the tile, forms
//     P^T and dS^T, and adds dV += P^T dO and dK += dS^T q into float32
//     accumulators, written once at the end.
//  3. flash_bwd_dq*: one block per (batch, q head, 64-row query tile),
//     walking the visible key tiles: S and dP recomputed, dQ += dS k.
// FlashAttention-2 folds dQ into the dK/dV pass with atomicAdd, whose order
// changes from run to run; the pass of its own costs S and dP once more:
// 2 (4 D + 3 Dv) operations a visible pair, batch row and head, in place
// of the least work 2 (3 D + 2 Dv) (dQ's, dK's, S's over D; dV's, dP's
// over Dv).
//
// What bounds it on this card: arithmetic. At qwen3-1.7b's training shape
// (B 4, H 16, Hkv 8, Sq = Sk = 2048, D = 128, causal) the least work is
// 1.72e11 operations against 67 MB of q, k, v, o, dO and gradients: 0.174
// ms at the bf16 tensor-core rate (989 TFLOP/s), 0.02 ms at 3.35 TB/s.
//
// Two variants, as the forward has two, chosen by the caller:
//
// *_mma (bf16 at (D, Dv) = (64, 64), (128, 128), (192, 128); entry
// flash_attention_bwd_mma): every product on the tensor cores with
// mma.sync.m16n8k16 (bf16 in, float32 accumulators), operands loaded with
// ldmatrix from shared memory whose 16-byte chunks are XOR-swizzled by
// the row (a warp's eight row addresses of one ldmatrix fall in eight
// distinct bank groups). D, lse and every sum stay float32, and P and dS
// keep their float32 values as bf16 hi = bf16(x) and lo = bf16(x - hi),
// two products each, as the forward keeps P: rounded once to bf16, dS put
// a key's dK 1.4e-2 from the float32 answer (above the tests' 1e-2) where
// thousands of queries' terms cancel (G 8 at 2,304 positions). The
// products run are then 2 (6 D + 5 Dv) a visible pair.
//  * 8 warps. Phase A: warp w computes the 16 x 32 block (rows 16 (w % 4),
//    columns 32 (w / 4)) of S and dP; P and dS go to shared memory as bf16.
//    Phase B: warp w accumulates rows 16 (w % 4) and half (w / 4) of the
//    output columns: at (192, 128) 48 float32 of dK and 32 of dV a thread,
//    16 + 16 of S and dP, so the registers hold without spills. P^T and
//    dS^T (hi and lo) take 32 KB.
//  * The streamed tiles (q and dO in the dK/dV kernel, k and v in the dQ
//    kernel) are double-buffered with cp.async (zero-filled past Sq or
//    Sk), so the next tile's loads run under this tile's products. Shared
//    memory at (192, 128): 153 KB (dK/dV), 137 KB (dQ).
//  * q, k, v and dO are read through their strides (the (B, S, H, D)
//    activations, a view of a projection's kv head, a rank's head slice):
//    each row must start on 16 bytes (the caller copies a tensor that
//    breaks it).
//
// flash_bwd_dkdv / flash_bwd_dq (float32, and bf16 at other head dims up
// to D 192, Dv 128; entry flash_attention_bwd): the same passes on the
// fp32 CUDA cores, tiles staged as float32 (rows padded to an odd pitch
// where a warp reads down a column), thread (ty, tx) of 256 owning rows
// 4 ty .. 4 ty + 3 and columns tx + 16 j of the 64 x 64 score tile and 4
// rows of the accumulators; instances (64, 64), (128, 128), (192, 128),
// the smallest that holds both head dims (200 KB of shared memory at the
// largest).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;         // rows of every tile: 64 queries or 64 keys
constexpr int kThreads = 256;  // 8 warps
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, Sq) dense
  float* delta;      // (B, H, Sq) dense scratch
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

// every pair of the query tile at q0 and the key tile at k0 is visible
__device__ __forceinline__ bool tile_full(int q0, int k0, int sq, int sk, int causal, int window) {
  return q0 + kT <= sq && k0 + kT <= sk && (!causal || k0 + kT - 1 <= q0) &&
         (window <= 0 || q0 + kT - 1 - window < k0);
}

// [begin, end): the queries that see some key of the tile at k0
__device__ __forceinline__ void query_range(int k0, int sq, int sk, int causal, int window,
                                            int& begin, int& end) {
  const int k_last = min(k0 + kT, sk) - 1;
  begin = causal ? k0 : 0;
  end = sq;
  if (window > 0) end = min(end, k_last + window);
}

// [begin, end): the keys, from a tile edge, that some query of the tile at q0 sees
__device__ __forceinline__ void key_range(int q0, int sq, int sk, int causal, int window,
                                          int& begin, int& end) {
  const int q_last = min(q0 + kT, sq) - 1;
  begin = 0;
  end = sk;
  if (causal) end = min(end, q_last + 1);
  if (window > 0) begin = max(0, q0 - window + 1) / kT * kT;
}

// D = rowsum(dO * o), one warp a row
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta(const Params p) {
  const long long row = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(p.b) * p.h * p.sq) return;
  const int i = static_cast<int>(row % p.sq);
  const long long bh = row / p.sq;
  const int bi = static_cast<int>(bh / p.h), hi = static_cast<int>(bh % p.h);
  const T* og = static_cast<const T*>(p.o) + bi * p.o_sb + hi * p.o_sh + i * p.o_ss;
  const T* dg = static_cast<const T*>(p.dout) + bi * p.do_sb + hi * p.do_sh + i * p.do_ss;
  float acc = 0.f;
  for (int e = lane; e < p.vd; e += 32) acc = fmaf(to_f32(dg[e]), to_f32(og[e]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[row] = acc;
}

template <typename T>
int launch_delta(const Params& p, cudaStream_t stream) {
  const long long rows = static_cast<long long>(p.b) * p.h * p.sq;
  const long long blocks = (rows * 32 + kThreads - 1) / kThreads;
  flash_bwd_delta<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync, ldmatrix, cp.async
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// byte offset of element (r, c) in a bf16 tile of COLS columns (a multiple
// of 64): rows of COLS * 2 bytes, 16-byte chunks XOR-swizzled by r % 8
template <int COLS>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * COLS * 2 + (((c >> 3) ^ (r & 7)) << 4) + ((c & 7) << 1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows r0 .. r0 + kT - 1 of a bf16 matrix of COLS dense columns and row
// stride ss (elements) into a swizzled tile; rows at or past n are zeros
template <int COLS>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* g, long long ss,
                                          int r0, int n) {
  constexpr int CH = COLS / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < kT * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = r0 + r < n;
    cp_async16(dst + swz<COLS>(r, c), ok ? g + (r0 + r) * ss + c : g, ok ? 16 : 0);
  }
}

// kT float32 values g[r0 ..] into shared memory; past n zeros
__device__ __forceinline__ void load_row(uint32_t dst, const float* g, int r0, int n) {
  const int r = threadIdx.x;
  if (r < kT) {
    const bool ok = r0 + r < n;
    cp_async4(dst + 4 * r, ok ? g + r0 + r : g, ok ? 4 : 0);
  }
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c (16 x 8, float32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Phase A: x = A B^T for this warp's 16 x 32 block (rows 16 wr, columns
// 32 wc), A and B both (kT x KD) tiles, row-major in shared memory. x[j]
// is the m16n8 block of columns 32 wc + 8 j: x[j][e] is row
// 16 wr + lane / 4 + 8 (e / 2), column 32 wc + 8 j + 2 (lane % 4) + e % 2.
template <int KD>
__device__ __forceinline__ void mma_abt(float (&x)[4][4], uint32_t sa, uint32_t sb, int wr, int wc,
                                        int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
  const int ar = 16 * wr + (lane & 7) + 8 * ((lane >> 3) & 1), ac = 8 * (lane >> 4);
  const int br = 32 * wc + (lane & 7) + 8 * (lane >> 4), bc = 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < KD; kk += 16) {
    uint32_t a[4];
    ldsm4(a, sa + swz<KD>(ar, kk + ac));
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      uint32_t b[4];  // columns 16 jp .. 16 jp + 15 of the block, k kk .. kk + 15
      ldsm4(b, sb + swz<KD>(br + 16 * jp, kk + bc));
      mma16816(x[2 * jp], a, b[0], b[1]);
      mma16816(x[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// Phase B: acc += (A_hi + A_lo) B for this warp's rows 16 wr and columns
// wc * N / 2 .. (wc + 1) * N / 2 - 1, A_hi and A_lo the two bf16 halves of
// the (kT x kT) P or dS tile, B a (kT x N) tile stored row by row of its k
// index (read transposed): two products, hi then lo, on each B fragment.
// acc[jb] is the m16n8 block of columns wc * N / 2 + 8 jb.
template <int N>
__device__ __forceinline__ void mma_ab(float (&acc)[N / 16][4], uint32_t sa_hi, uint32_t sa_lo,
                                       uint32_t sb, int wr, int wc, int lane) {
  const int ar = 16 * wr + (lane & 7) + 8 * ((lane >> 3) & 1), ac = 8 * (lane >> 4);
  const int br = (lane & 7) + 8 * ((lane >> 3) & 1), bc = wc * (N / 2) + 8 * (lane >> 4);
#pragma unroll
  for (int kk = 0; kk < kT; kk += 16) {
    uint32_t hi[4], lo[4];
    ldsm4(hi, sa_hi + swz<kT>(ar, kk + ac));
    ldsm4(lo, sa_lo + swz<kT>(ar, kk + ac));
#pragma unroll
    for (int jp = 0; jp < N / 32; ++jp) {
      uint32_t b[4];  // k kk .. kk + 15, columns 16 jp .. 16 jp + 15 of the half
      ldsm4_t(b, sb + swz<N>(kk + br, bc + 16 * jp));
      mma16816(acc[2 * jp], hi, b[0], b[1]);
      mma16816(acc[2 * jp], lo, b[0], b[1]);
      mma16816(acc[2 * jp + 1], hi, b[2], b[3]);
      mma16816(acc[2 * jp + 1], lo, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ void st_bf162(void* ptr, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(ptr) = __floats2bfloat162_rn(a, b);
}

// a float32 pair as bf16 hi = bf16(x) and lo = bf16(x - hi), so that hi + lo
// carries x to about 16 bits
__device__ __forceinline__ void st_hi_lo(uint8_t* hi, uint8_t* lo, float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  *reinterpret_cast<__nv_bfloat162*>(hi) = h;
  *reinterpret_cast<__nv_bfloat162*>(lo) = __floats2bfloat162_rn(a - hf.x, b - hf.y);
}

// acc * scale (this warp's rows 16 wr and half wc of N columns) into the
// gradient rows r0 + row < n of a bf16 matrix with row stride ss
template <int N>
__device__ __forceinline__ void store_acc(const float (&acc)[N / 16][4], __nv_bfloat16* g,
                                          long long ss, int r0, int n, float scale, int wr, int wc,
                                          int lane) {
#pragma unroll
  for (int jb = 0; jb < N / 16; ++jb) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * wr + (lane >> 2) + 8 * half;
      const int c = wc * (N / 2) + 8 * jb + 2 * (lane & 3);
      if (r0 + r < n)
        st_bf162(g + (r0 + r) * ss + c, acc[jb][2 * half] * scale, acc[jb][2 * half + 1] * scale);
    }
  }
}

template <int D, int DV>
constexpr int dkdv_mma_bytes() {  // k, v; q and dO twice; P^T, dS^T hi and lo; lse and D twice
  return 6 * kT * (D + DV) + 8 * kT * kT + 16 * kT;
}

template <int D, int DV>
constexpr int dq_mma_bytes() {  // q, dO; k and v twice; dS hi and lo; lse, D
  return 6 * kT * (D + DV) + 4 * kT * kT + 8 * kT;
}

// the dK/dV kernel's loads of one query tile (rows q0 .., head hi) into a stage
template <int D, int DV>
__device__ __forceinline__ void load_query_tile(uint32_t sq_dst, uint32_t so_dst, uint32_t sl_dst,
                                                uint32_t sd_dst, const Params& p, int bi, int hi,
                                                int q0) {
  const long long row = (static_cast<long long>(bi) * p.h + hi) * p.sq;
  load_tile<D>(sq_dst, static_cast<const __nv_bfloat16*>(p.q) + bi * p.q_sb + hi * p.q_sh, p.q_ss,
               q0, p.sq);
  load_tile<DV>(so_dst, static_cast<const __nv_bfloat16*>(p.dout) + bi * p.do_sb + hi * p.do_sh,
                p.do_ss, q0, p.sq);
  load_row(sl_dst, p.lse + row, q0, p.sq);
  load_row(sd_dst, p.delta + row, q0, p.sq);
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_mma(const Params p) {
  constexpr uint32_t KB = kT * D * 2, VB = kT * DV * 2, PB = kT * kT * 2, RB = kT * 4;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t base = smem_u32(smem);
  // k, v; q and dO, two stages each; P^T and dS^T, hi and lo halves; lse
  // and D, two stages each
  const uint32_t sK = base, sV = sK + KB, sQ = sV + VB, sO = sQ + 2 * KB;
  const uint32_t sP = sO + 2 * VB, sS = sP + 2 * PB, sL = sS + 2 * PB, sD = sL + 2 * RB;
  uint8_t* const gP = smem + (sP - base);
  uint8_t* const gS = smem + (sS - base);
  const float* const fL = reinterpret_cast<const float*>(smem + (sL - base));
  const float* const fD = reinterpret_cast<const float*>(smem + (sD - base));

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp & 3, wc = warp >> 2;
  const int bi = blockIdx.x / p.hkv, kvh = blockIdx.x % p.hkv;
  const int groups = p.h / p.hkv;
  const int k0 = blockIdx.y * kT;  // the heaviest causal key tiles first
  const int sq = p.sq, sk = p.sk, causal = p.causal, window = p.window;
  const float scale_log2 = p.scale_log2;

  int q_begin, q_end;
  query_range(k0, sq, sk, causal, window, q_begin, q_end);
  const int n_qt = q_end > q_begin ? (q_end - q_begin + kT - 1) / kT : 0;
  const int n_it = groups * n_qt;  // iteration it: head kvh G + it / n_qt, tile it % n_qt

  load_tile<D>(sK, static_cast<const __nv_bfloat16*>(p.k) + bi * p.k_sb + kvh * p.k_sh, p.k_ss, k0,
               sk);
  load_tile<DV>(sV, static_cast<const __nv_bfloat16*>(p.v) + bi * p.v_sb + kvh * p.v_sh, p.v_ss, k0,
                sk);
  if (n_it > 0) load_query_tile<D, DV>(sQ, sO, sL, sD, p, bi, kvh * groups, q_begin);
  cp_async_commit();

  float dv[DV / 16][4], dk[D / 16][4];
#pragma unroll
  for (int jb = 0; jb < DV / 16; ++jb)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[jb][e] = 0.f;
#pragma unroll
  for (int jb = 0; jb < D / 16; ++jb)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[jb][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) {  // the next tile's loads run under this tile's products
      const int nx = (it + 1) & 1;
      load_query_tile<D, DV>(sQ + nx * KB, sO + nx * VB, sL + nx * RB, sD + nx * RB, p, bi,
                             kvh * groups + (it + 1) / n_qt, q_begin + ((it + 1) % n_qt) * kT);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile's loads are visible to every warp
    const int q0 = q_begin + (it % n_qt) * kT;

    // S^T = k q^T and dP^T = v dO^T: rows keys, columns queries
    float x[4][4], y[4][4];
    mma_abt<D>(x, sK, sQ + st * KB, wr, wc, lane);
    mma_abt<DV>(y, sV, sO + st * VB, wr, wc, lane);
    const bool full = tile_full(q0, k0, sq, sk, causal, window);
    const float* const lt = fL + st * kT;
    const float* const dt = fD + st * kT;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 32 * wc + 8 * j + 2 * (lane & 3);  // query
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * wr + (lane >> 2) + 8 * half;  // key
        float pv[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool vis = full || visible(q0 + c + e, k0 + r, sq, sk, causal, window);
          // a row without a visible key has lse = +inf: exp2(-inf) = 0
          pv[e] = vis ? exp2f(x[j][2 * half + e] * scale_log2 - lt[c + e] * kLog2e) : 0.f;
          ds[e] = pv[e] * (y[j][2 * half + e] - dt[c + e]);
        }
        st_hi_lo(gP + swz<kT>(r, c), gP + PB + swz<kT>(r, c), pv[0], pv[1]);
        st_hi_lo(gS + swz<kT>(r, c), gS + PB + swz<kT>(r, c), ds[0], ds[1]);
      }
    }
    __syncthreads();  // P^T and dS^T complete

    mma_ab<DV>(dv, sP, sP + PB, sO + st * VB, wr, wc, lane);  // dV += P^T dO
    mma_ab<D>(dk, sS, sS + PB, sQ + st * KB, wr, wc, lane);   // dK += dS^T q
    __syncthreads();  // this stage, P^T and dS^T are free again
  }
  cp_async_wait<0>();

  store_acc<D>(dk, static_cast<__nv_bfloat16*>(p.dk) + bi * p.dk_sb + kvh * p.dk_sh, p.dk_ss, k0,
               sk, p.scale, wr, wc, lane);
  store_acc<DV>(dv, static_cast<__nv_bfloat16*>(p.dv) + bi * p.dv_sb + kvh * p.dv_sh, p.dv_ss, k0,
                sk, 1.f, wr, wc, lane);
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_mma(const Params p) {
  constexpr uint32_t KB = kT * D * 2, VB = kT * DV * 2, PB = kT * kT * 2;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t base = smem_u32(smem);
  // q, dO; k and v, two stages each; dS, hi and lo halves; lse, D
  const uint32_t sQ = base, sO = sQ + KB, sK = sO + VB, sV = sK + 2 * KB;
  const uint32_t sS = sV + 2 * VB, sL = sS + 2 * PB, sD = sL + kT * 4;
  uint8_t* const gS = smem + (sS - base);
  const float* const fL = reinterpret_cast<const float*>(smem + (sL - base));
  const float* const fD = reinterpret_cast<const float*>(smem + (sD - base));

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp & 3, wc = warp >> 2;
  const int bi = blockIdx.x / p.h, hi = blockIdx.x % p.h;
  const int kvh = hi / (p.h / p.hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kT;  // the heaviest causal query tiles first
  const int sq = p.sq, sk = p.sk, causal = p.causal, window = p.window;
  const float scale_log2 = p.scale_log2;
  const __nv_bfloat16* const kg =
      static_cast<const __nv_bfloat16*>(p.k) + bi * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* const vg =
      static_cast<const __nv_bfloat16*>(p.v) + bi * p.v_sb + kvh * p.v_sh;

  int k_begin, k_end;
  key_range(q0, sq, sk, causal, window, k_begin, k_end);
  const int n_kt = k_end > k_begin ? (k_end - k_begin + kT - 1) / kT : 0;

  const long long row = (static_cast<long long>(bi) * p.h + hi) * sq;
  load_tile<D>(sQ, static_cast<const __nv_bfloat16*>(p.q) + bi * p.q_sb + hi * p.q_sh, p.q_ss, q0,
               sq);
  load_tile<DV>(sO, static_cast<const __nv_bfloat16*>(p.dout) + bi * p.do_sb + hi * p.do_sh,
                p.do_ss, q0, sq);
  load_row(sL, p.lse + row, q0, sq);
  load_row(sD, p.delta + row, q0, sq);
  if (n_kt > 0) {
    load_tile<D>(sK, kg, p.k_ss, k_begin, sk);
    load_tile<DV>(sV, vg, p.v_ss, k_begin, sk);
  }
  cp_async_commit();

  float dq[D / 16][4];
#pragma unroll
  for (int jb = 0; jb < D / 16; ++jb)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[jb][e] = 0.f;

  for (int it = 0; it < n_kt; ++it) {
    const int st = it & 1;
    if (it + 1 < n_kt) {  // the next tile's loads run under this tile's products
      const int nx = (it + 1) & 1, kn = k_begin + (it + 1) * kT;
      load_tile<D>(sK + nx * KB, kg, p.k_ss, kn, sk);
      load_tile<DV>(sV + nx * VB, vg, p.v_ss, kn, sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile's loads are visible to every warp
    const int k0 = k_begin + it * kT;

    // S = q k^T and dP = dO v^T: rows queries, columns keys
    float x[4][4], y[4][4];
    mma_abt<D>(x, sQ, sK + st * KB, wr, wc, lane);
    mma_abt<DV>(y, sO, sV + st * VB, wr, wc, lane);
    const bool full = tile_full(q0, k0, sq, sk, causal, window);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * wr + (lane >> 2) + 8 * half;  // query
      const float lse2 = fL[r] * kLog2e, dr = fD[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 32 * wc + 8 * j + 2 * (lane & 3);  // key
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool vis = full || visible(q0 + r, k0 + c + e, sq, sk, causal, window);
          const float pv = vis ? exp2f(x[j][2 * half + e] * scale_log2 - lse2) : 0.f;
          ds[e] = pv * (y[j][2 * half + e] - dr);
        }
        st_hi_lo(gS + swz<kT>(r, c), gS + PB + swz<kT>(r, c), ds[0], ds[1]);
      }
    }
    __syncthreads();  // dS complete

    mma_ab<D>(dq, sS, sS + PB, sK + st * KB, wr, wc, lane);  // dQ += dS k
    __syncthreads();  // this stage and dS are free again
  }
  cp_async_wait<0>();

  store_acc<D>(dq, static_cast<__nv_bfloat16*>(p.dq) + bi * p.dq_sb + hi * p.dq_sh, p.dq_ss, q0, sq,
               p.scale, wr, wc, lane);
}

template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// the delta kernel, then the dK/dV kernel (a block per batch, kv head and
// key tile) and the dQ kernel (a block per batch, q head and query tile)
template <typename T, typename DkdvKernel, typename DqKernel>
int launch_all(const Params& p, cudaStream_t stream, DkdvKernel dkdv, int dkdv_bytes, DqKernel dq,
               int dq_bytes) {
  int err = allow_smem(dkdv, dkdv_bytes);
  if (!err) err = allow_smem(dq, dq_bytes);
  if (!err) err = launch_delta<T>(p, stream);
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

template <int D, int DV>
int launch_mma(const Params& p, cudaStream_t stream) {
  return launch_all<__nv_bfloat16>(p, stream, flash_bwd_dkdv_mma<D, DV>, dkdv_mma_bytes<D, DV>(),
                                   flash_bwd_dq_mma<D, DV>, dq_mma_bytes<D, DV>());
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

// a bf16 (B, heads, S, D) operand the mma kernels read 16 bytes at a time:
// a 16-byte aligned base and strides in whole 16-byte units (a dimension
// of extent 1 may have any stride)
bool rows_aligned(const void* ptr, long long sb, long long sh, long long ss, int b, int heads,
                  int s) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && (b == 1 || sb % 8 == 0) &&
         (heads == 1 || sh % 8 == 0) && (s == 1 || ss % 8 == 0);
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
// 128); arguments as flash_attention_bwd's, without the dtype. q, k, v and
// dout need 16-byte aligned rows (base and strides); the caller makes a
// dense copy where a tensor breaks it.
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
  if (!taken || !shape_ok(b, h, hkv, sq, sk, d, vd) ||
      !rows_aligned(q, q_sb, q_sh, q_ss, b, h, sq) ||
      !rows_aligned(k, k_sb, k_sh, k_ss, b, hkv, sk) ||
      !rows_aligned(v, v_sb, v_sh, v_ss, b, hkv, sk) ||
      !rows_aligned(dout, do_sb, do_sh, do_ss, b, h, sq))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[24] = {q_sb,  q_sh,  q_ss,  k_sb,  k_sh,  k_ss,  v_sb,  v_sh,
                            v_ss,  o_sb,  o_sh,  o_ss,  do_sb, do_sh, do_ss, dq_sb,
                            dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss};
  const Params p = make_params(q, k, v, o, dout, lse, delta, dq, dk, dv, b, h, hkv, sq, sk, d, vd,
                               st, scale, causal, window);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d == 64    ? launch_mma<64, 64>(p, s)
         : d == 128 ? launch_mma<128, 128>(p, s)
                    : launch_mma<192, 128>(p, s);
}
