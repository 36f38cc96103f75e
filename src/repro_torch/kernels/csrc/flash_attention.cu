// Forward GQA flash attention (causal and/or sliding window) for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/
// flash_attention.py (`_kernel`, launched by `flash_attention_padded`):
// q (B, H, Sq, D), k (B, Hkv, Sk, D) and v (B, Hkv, Sk, Dv) (Dv = D but for
// MLA, whose qk head dim 192 is not its v head dim 128), float32 or
// bfloat16; query head
// h reads kv head h / (H / Hkv); scores, the online softmax (m, l, acc) and
// the PV product in float32; keys at positions >= Sk masked, causal
// kpos <= qpos and window kpos > qpos - window on absolute positions from 0
// (top-left aligned when Sq != Sk); a row with no visible key is exactly 0;
// the output (B, H, Sq, Dv) in q's dtype. Where the caller asks (the training forward),
// each kernel also writes the float32 log-sum-exp of each row's scaled
// scores, lse = m + log l (+inf for a row with no visible key), (B, H, Sq)
// dense: the statistics the Pallas kernel keeps as its m and l outputs, and
// what the backward pass needs to rebuild P = exp(s - lse). A null lse
// pointer skips the store, so the serve path's work is unchanged.
//
// What bounds it on this card: arithmetic. Over the visible (q, k) pairs the
// function does 4 * D operations each (QK^T and PV); at the serve path's
// prefill (H = 16, Hkv = 8, Sq = Sk = 2048, D = 128, causal) that is 17.2
// GFLOP against 25.2 MB of q, k, v and output, far above the ~295
// operations per byte where the bf16 tensor cores (989 TFLOP/s) stop
// waiting on memory: 0.0174 ms at the tensor-core rate. At deepseek-v3's MLA
// prefill (H = Hkv = 128, S = 2048, D 192, Dv 128, causal) it is 2 (D + Dv)
// operations a visible pair, 171.9 GFLOP against 335.5 MB: 0.174 ms.
//
// Two kernels, chosen by the caller from dtype and D before the launch:
//
// flash_fwd_kernel_wgmma (bf16 at (D, Dv) = (64, 64), (128, 128) or (192,
// 128); entry flash_attention_fwd_wgmma)
//   runs both products on the tensor cores and keeps K3's float32
//   probabilities. One bf16 rounding of P for the PV product would move the
//   output by ~45 bf16 roundings of its float32 answer, so P is split into
//   hi = bf16(P) and lo = bf16(P - hi), and P V = hi V + lo V: two PV
//   products, 2 D + 4 Dv operations per visible pair (0.026 ms at the serve
//   shape, 0.243 ms at MLA's).
//  * One block of 384 threads per (b, h, 128-row q tile), heaviest causal
//    tiles first: two consumer warpgroups of 64 q rows each and a producer
//    warpgroup, one thread of which issues TMA loads: q once, then k and v
//    tiles of 64 keys into a two-stage ring, each with its own full and
//    empty mbarrier, so a k tile is replaced once both consumers read it.
//    (96 KB of shared memory at D = 128; at MLA's (192, 128) q takes 48 KB,
//    the k ring 2 x 24 KB and the v ring 2 x 16 KB, 129 KB in all.)
//  * Tiles are TMA boxes of 64 columns (128 bytes, the 128-byte swizzle
//    span): a D = 128 tile is two boxes, a D = 192 one three, and the wgmma
//    descriptors step across them. The tensor maps cover the true Sq and Sk, so rows past
//    either load as zeros and output rows past Sq are never stored.
//  * S = Q K^T: wgmma m64n64k16, both operands K-major in shared memory, a
//    chain of D / 16 of them (12 at D = 192).
//    Softmax on the accumulator's layout: each thread holds 2 rows, a row
//    spans the 4 threads of a quad (two shfl_xor). Only tiles that cross
//    the causal diagonal, the window's edge or Sk are masked elementwise.
//  * P V: the S accumulator's layout is the A-fragment layout of the next
//    wgmma, so hi and lo are packed in registers; two wgmma m64n{D}k16 per
//    16 keys, V from shared memory as an MN-major operand (transposed B).
//    The output accumulator is Dv wide, so at (192, 128) the registers are
//    D = 128's.
//  * Epilogue: O / max(l, 1e-30) in float32, rounded to bf16 once, staged
//    in the warpgroup's own q buffer and written by a TMA store.
//  * setmaxnreg moves registers from the producer warpgroup to the
//    consumers (24 and 240 a thread). ptxas still compiles the consumers
//    within the block's 168 a thread: with 128-key tiles (64 registers of
//    S, 64 of O, 64 of hi/lo fragments) it spilled and serialized the
//    wgmmas, with and without the register moves; 64-key tiles (32 + 64 +
//    32) spill nothing.
//
// flash_fwd_kernel (float32, and bf16 at other head dims; entry
// flash_attention_fwd)
//   is the first, CUDA-core design: the arithmetic runs on the fp32 CUDA
//   cores (67 TFLOP/s), bf16 widened with __bfloat162float on load.
//  * One block of 256 threads per (b, h, 64-row q tile); the TPU grid's
//    sequential k axis becomes a loop over 64-key tiles inside the block,
//    bounded to the tiles with a visible pair (causal and window skip).
//    The heaviest causal q tiles are launched first.
//  * q, k and v tiles are staged in shared memory as float32 (q padded to
//    DQK + 4 and k to DQK + 1 floats a row, so the column reads of the
//    score loop hit distinct banks); P reuses k's buffer. Instances (DQK,
//    DV) = (64, 64), (128, 128) and (192, 128); the last takes 64 x 196 +
//    64 x 193 + 64 x 128 floats, 132 KB, so one block runs on an SM.
//  * Thread (ty, tx) owns rows 4ty..4ty+3: 4 x 4 scores and 4 x DV/16
//    output columns in registers. Row max and row sum reduce across the 16
//    lanes of a row group with warp shuffles; m and l stay in registers.
//  * Ragged edges (Sq, Sk, D below the tile sizes) are masked in the
//    kernel, so nothing is padded in device memory; strides are arguments,
//    so (B, S, H, D) activations need no transposing copy.
//
// The tensor maps are encoded here, on the host, with cuTensorMapEncodeTiled
// fetched through the runtime's driver entry point, so the library links no
// libcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kPP = kBK + 1;  // row pitch of the P tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int b, h, hkv, sq, sk, d, dv;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  float scale;
  int causal, window;
  float* lse;  // (B, H, Sq) float32, or null
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype(bfloat16)
}

template <int DQK, int DV>
constexpr int smem_floats() {
  return kBQ * (DQK + 4) + kBK * (DQK + 1) + kBK * DV;
}

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  static_assert(DQK % 16 == 0 && DV % 16 == 0, "head dims must be multiples of 16");
  static_assert(kBK * (DQK + 1) >= kBQ * kPP, "P must fit in the k buffer");
  constexpr int QP = DQK + 4;
  constexpr int KP = DQK + 1;
  constexpr int NC = DV / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;              // [kBQ][QP]
  float* sK = sQ + kBQ * QP;     // [kBK][KP], then P [kBQ][kPP]
  float* sV = sK + kBK * KP;     // [kBK][DV]
  float* sP = sK;
  const float NEG_INF = __int_as_float(0xff800000);

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;
  const int bi = bh / p.h, hi = bh % p.h;
  const int kvh = hi / (p.h / p.hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest causal tiles first
  const int d = p.d, dv = p.dv;

  const T* qg = static_cast<const T*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + bi * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + bi * p.v_sb + kvh * p.v_sh;
  T* og = static_cast<T*>(p.o) + bi * p.o_sb + hi * p.o_sh;

  for (int i = tid; i < kBQ * DQK; i += kThreads) {
    const int r = i / DQK, c = i % DQK;
    float x = 0.f;
    if (q0 + r < p.sq && c < d) x = to_f32(qg[static_cast<long long>(q0 + r) * p.q_ss + c]);
    sQ[r * QP + c] = x;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // the k tiles holding a visible pair for some row of this q tile
  const int q_last = min(q0 + kBQ, p.sq) - 1;
  int k_begin = 0, k_end = p.sk;
  if (p.causal) k_end = min(k_end, q_last + 1);
  if (p.window > 0) k_begin = max(0, q0 - p.window + 1) / kBK * kBK;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's P and V are no longer read
    for (int i = tid; i < kBK * DQK; i += kThreads) {
      const int r = i / DQK, c = i % DQK;
      float kx = 0.f;
      if (k0 + r < p.sk && c < d) kx = to_f32(kg[static_cast<long long>(k0 + r) * p.k_ss + c]);
      sK[r * KP + c] = kx;
    }
    for (int i = tid; i < kBK * DV; i += kThreads) {
      const int r = i / DV, c = i % DV;
      float vx = 0.f;
      if (k0 + r < p.sk && c < dv) vx = to_f32(vg[static_cast<long long>(k0 + r) * p.v_ss + c]);
      sV[r * DV + c] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DQK; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * QP + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * KP + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
    __syncthreads();  // every thread is done with K: P overwrites it

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      bool vis[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        vis[j] = kpos < p.sk && (!p.causal || kpos <= qpos) &&
                 (p.window <= 0 || kpos > qpos - p.window);
        s[i][j] = vis[j] ? s[i][j] * p.scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // rows with no visible key yet keep m = -inf: never exp(-inf + inf)
      const float m_safe = m_new == NEG_INF ? 0.f : m_new;
      const float corr = m[i] == NEG_INF ? 0.f : expf(m[i] - m_safe);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = vis[j] ? expf(s[i][j] - m_safe) : 0.f;
        sP[(ty * 4 + i) * kPP + tx + 16 * j] = pv;
        rs += pv;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // P complete

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * kPP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = sV[kk * DV + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.sq) continue;
    // m and l are the whole row's in each of its 16 lanes
    if (p.lse != nullptr && tx == 0)
      p.lse[static_cast<long long>(bh) * p.sq + row] =
          l[i] > 0.f ? m[i] + logf(l[i]) : __int_as_float(0x7f800000);
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < dv) og[static_cast<long long>(row) * p.o_ss + col] = from_f32<T>(acc[i][c] / den);
    }
  }
}

template <typename T, int DQK, int DV>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int bytes = smem_floats<DQK, DV>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DQK, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(p.b * p.h), static_cast<unsigned>((p.sq + kBQ - 1) / kBQ));
  flash_fwd_kernel<T, DQK, DV><<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: wgmma, TMA, mbarriers
// ---------------------------------------------------------------------------

constexpr int kWBQ = 128;           // q rows a block: two consumer warpgroups of 64
constexpr int kWBK = 64;            // keys a tile: S = Q K^T is one wgmma m64n64 chain
constexpr int kStages = 2;          // k and v tiles in flight
constexpr int kWThreads = 384;      // 2 consumer warpgroups + 1 producer warpgroup
constexpr int kQBox = 64 * 128;     // bytes of a 64-row, 64-column q (or output) box
constexpr int kKVBox = kWBK * 128;  // bytes of a kWBK-row, 64-column k or v box
constexpr int kConsumers = 256;     // threads that release each k and v tile

struct WgmmaArgs {
  int h, hkv, sq, sk, causal, window;
  float scale_log2;  // softmax scale * log2(e): exp(x * scale) = exp2(x * scale_log2)
  float* lse;        // (B, H, Sq) float32, or null
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box of a 4-d tensor map (D, S, H, B) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// a wgmma operand in shared memory: 128-byte swizzle, `lbo` and `sbo` in bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// ties registers a wgmma reads or writes to this point of the program, so
// the compiler moves no use of them across a wgmma's fence or wait
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D (64 x 64, float32) (+)= A (64 x 16, smem) * B (64 x 16, smem)^T, both K-major
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 128, float32) += A (64 x 16, registers) * B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, float32) += A (64 x 16, registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DV>
__device__ __forceinline__ void wgmma_pv(float (&o)[DV / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_m64n128k16(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_m64n64k16(o, a, db);
}

template <int D, int DV>
__global__ void __launch_bounds__(kWThreads, 1)
    flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_o, const WgmmaArgs a) {
  static_assert((D == 64 && DV == 64) || (D == 128 && DV == 128) || (D == 192 && DV == 128),
                "(D, Dv) is (64, 64), (128, 128) or (192, 128)");
  constexpr int NBOX = D / 64;              // 64-column boxes a q or k row
  constexpr int VBOX = DV / 64;             // 64-column boxes a v or output row
  constexpr int QW_BYTES = NBOX * kQBox;    // one warpgroup's 64 q rows
  constexpr int K_BYTES = NBOX * kKVBox;    // one k tile
  constexpr int V_BYTES = VBOX * kKVBox;    // one v tile
  const float NEG_INF = __int_as_float(0xff800000);

  // shared memory, 1024-byte aligned for the swizzle: q (two warpgroups'
  // boxes), k ring, v ring, then the mbarriers
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);  // the same bytes, generic address
  const uint32_t sQ = base;
  const uint32_t sK = sQ + 2 * QW_BYTES;
  const uint32_t sV = sK + kStages * K_BYTES;
  const uint32_t bars = sV + kStages * V_BYTES;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + kStages + s); };
  auto k_empty = [&](int s) { return bars + 8u * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bars + 8u * (1 + 3 * kStages + s); };

  const int bh = blockIdx.x;
  const int bi = bh / a.h, hi = bh % a.h;
  const int kvh = hi / (a.h / a.hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kWBQ;  // heaviest causal tiles first

  // the k tiles holding a visible pair for some row of this q tile
  const int q_last = min(q0 + kWBQ, a.sq) - 1;
  int k_begin = 0, k_end = a.sk;
  if (a.causal) k_end = min(k_end, q_last + 1);
  if (a.window > 0) k_begin = max(0, q0 - a.window + 1) / kWBK * kWBK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kWBK - 1) / kWBK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), kConsumers);
      mbar_init(v_empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (warp >= 8) {
    // producer warpgroup: it gives up its registers to the consumers (ptxas
    // sizes the block as 3 x 128 threads at 168 registers: 144 x 128 freed
    // here are the 72 x 256 the consumers take), and one thread issues
    // every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      mbar_expect_tx(q_full, 2 * QW_BYTES);
      for (int w = 0; w < 2; ++w)
        for (int x = 0; x < NBOX; ++x)
          tma_load(sQ + w * QW_BYTES + x * kQBox, &tm_q, q_full, 64 * x, q0 + 64 * w, hi, bi);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const uint32_t parity = ((it / kStages) & 1) ^ 1;  // a stage's first use passes at once
        const int k0 = k_begin + it * kWBK;
        mbar_wait(k_empty(s), parity);
        mbar_expect_tx(k_full(s), K_BYTES);
        for (int x = 0; x < NBOX; ++x)
          tma_load(sK + s * K_BYTES + x * kKVBox, &tm_k, k_full(s), 64 * x, k0, kvh, bi);
        mbar_wait(v_empty(s), parity);
        mbar_expect_tx(v_full(s), V_BYTES);
        for (int x = 0; x < VBOX; ++x)
          tma_load(sV + s * V_BYTES + x * kKVBox, &tm_v, v_full(s), 64 * x, k0, kvh, bi);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = warp / 4;                         // consumer warpgroup: q rows 64 wg ..
    const int r0 = 16 * (warp & 3) + lane / 4;       // this thread's rows r0 and r0 + 8
    const int cq = 2 * (lane & 3);                   // its first column in each 8-column group
    const int wq_first = q0 + 64 * wg, wq_last = wq_first + 63;
    const int qpos0 = wq_first + r0, qpos1 = qpos0 + 8;
    const uint32_t sQw = sQ + wg * QW_BYTES;

    float o[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // l: this thread's share of the row sum
    mbar_wait(q_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const uint32_t parity = (it / kStages) & 1;
      const int k0 = k_begin + it * kWBK;

      // S = Q K^T (64 x kWBK for this warpgroup), float32
      float sc[kWBK / 2];
      mbar_wait(k_full(s), parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t step = (kk % 4) * 32;  // 16 columns within a 128-byte row
        wgmma_ss_m64n64k16(sc, smem_desc(sQw + (kk / 4) * kQBox + step, 16, 1024),
                           smem_desc(sK + s * K_BYTES + (kk / 4) * kKVBox + step, 16, 1024),
                           kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(sc);
      mbar_arrive(k_empty(s));

      // online softmax on the accumulator's layout: sc[4j + e] is row
      // (e < 2 ? r0 : r0 + 8), column 8j + cq + (e & 1) of the tile
#pragma unroll
      for (int i = 0; i < kWBK / 2; ++i) sc[i] *= a.scale_log2;
      const bool edge = k0 + kWBK > a.sk || (a.causal && k0 + kWBK - 1 > wq_first) ||
                        (a.window > 0 && k0 <= wq_last - a.window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < kWBK / 2; ++i) {
          const int kpos = k0 + 8 * (i / 4) + cq + (i & 1);
          const int qpos = (i & 2) ? qpos1 : qpos0;
          const bool vis = kpos < a.sk && (!a.causal || kpos <= qpos) &&
                           (a.window <= 0 || kpos > qpos - a.window);
          if (!vis) sc[i] = NEG_INF;
        }
      }
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int i = 0; i < kWBK / 2; ++i) {
        if (i & 2)
          mx1 = fmaxf(mx1, sc[i]);
        else
          mx0 = fmaxf(mx0, sc[i]);
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      // rows with no visible key yet keep m = -inf: never exp(-inf + inf)
      const float ms0 = mn0 == NEG_INF ? 0.f : mn0, ms1 = mn1 == NEG_INF ? 0.f : mn1;
      const float c0 = m0 == NEG_INF ? 0.f : exp2f(m0 - ms0);
      const float c1 = m1 == NEG_INF ? 0.f : exp2f(m1 - ms1);
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int i = 0; i < kWBK / 2; ++i) {
        sc[i] = exp2f(sc[i] - ((i & 2) ? ms1 : ms0));  // a masked score gives exactly 0
        if (i & 2)
          rs1 += sc[i];
        else
          rs0 += sc[i];
      }
      l0 = l0 * c0 + rs0;
      l1 = l1 * c1 + rs1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] *= (i & 2) ? c1 : c0;

      // P = hi + lo in bf16, packed as the A fragments of 16-key slices:
      // slice kk's registers are sc[8kk .. 8kk + 7] in pairs
      uint32_t ph[kWBK / 16][4], pl[kWBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kWBK / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x0 = sc[8 * kk + 2 * e], x1 = sc[8 * kk + 2 * e + 1];
          const __nv_bfloat162 hb = __floats2bfloat162_rn(x0, x1);
          const float2 hf = __bfloat1622float2(hb);
          const __nv_bfloat162 lb = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
          ph[kk][e] = *reinterpret_cast<const uint32_t*>(&hb);
          pl[kk][e] = *reinterpret_cast<const uint32_t*>(&lb);
        }
      }

      // O += hi V + lo V
      mbar_wait(v_full(s), parity);
      pin(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWBK / 16; ++kk) {
        // 16 keys = 16 rows of 128 bytes; the next 64 columns are the next box
        const uint64_t dv = smem_desc(sV + s * V_BYTES + kk * 16 * 128, kKVBox, 1024);
        wgmma_pv<DV>(o, ph[kk], dv);
        wgmma_pv<DV>(o, pl[kk], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(o);
      pin(ph);
      pin(pl);
      mbar_arrive(v_empty(s));
    }

    // epilogue: the row sums across the quad, O / max(l, 1e-30), bf16
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    if (a.lse != nullptr && (lane & 3) == 0) {
      // m is in log2 units of the scaled score: lse = ln 2 * (m + log2 l)
      float* const lse_bh = a.lse + static_cast<long long>(bh) * a.sq;
      const float inf = __int_as_float(0x7f800000);
      if (qpos0 < a.sq) lse_bh[qpos0] = l0 > 0.f ? (m0 + log2f(l0)) * 0.6931471805599453f : inf;
      if (qpos1 < a.sq) lse_bh[qpos1] = l1 > 0.f ? (m1 + log2f(l1)) * 0.6931471805599453f : inf;
    }
    // staged in this warpgroup's own q boxes (its QK^T reads are done), in
    // the swizzled layout the output map's boxes have
    uint8_t* const stage = gbase + wg * QW_BYTES;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + 8 * half;
        const float den = half ? d1 : d0;
        const int col = 8 * j + cq;
        const int cc = col % 64;
        const int off = (col / 64) * kQBox + r * 128 + (((cc / 8) ^ (r % 8)) * 16) + (cc % 8) * 2;
        *reinterpret_cast<__nv_bfloat162*>(stage + off) =
            __floats2bfloat162_rn(o[4 * j + 2 * half] / den, o[4 * j + 2 * half + 1] / den);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if ((threadIdx.x & 127) == 0 && wq_first < a.sq) {
      for (int x = 0; x < VBOX; ++x) tma_store(&tm_o, sQw + x * kQBox, 64 * x, wq_first, hi, bi);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// a bf16 (B, S, heads, D) tensor with element strides (sb, sh, ss), the last
// dimension dense, as the 4-d map (D, S, heads, B) of 64 x `box_rows` boxes
// with the 128-byte swizzle. A dimension of extent 1 gets a dense stride:
// its coordinate is always 0.
bool make_map(CUtensorMap* map, const void* ptr, int d, int s, int heads, int b, long long ss,
              long long sh, long long sb, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  if (s == 1) ss = d;
  if (heads == 1) sh = ss * s;
  if (b == 1) sb = sh * heads;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2, static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  for (const cuuint64_t st : strides)
    if (st % 16 || st >= (1ull << 40)) return false;
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int DV>
int launch_wgmma(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                 const CUtensorMap& mo, const WgmmaArgs& args, int b, int sq, cudaStream_t stream) {
  constexpr int nbox = D / 64, vbox = DV / 64;
  constexpr int bytes =
      1024 + 2 * nbox * kQBox + kStages * (nbox + vbox) * kKVBox + (1 + 4 * kStages) * 8;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel_wgmma<D, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(b * args.h), static_cast<unsigned>((sq + kWBQ - 1) / kWBQ));
  flash_fwd_kernel_wgmma<D, DV><<<grid, kWThreads, bytes, stream>>>(mq, mk, mv, mo, args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: element strides (batch, head, seq) each, the last dimension
// dense; d the q and k head dim, dv the v and output head dim (d <= 192,
// dv <= 128). dtype 0 = float32, 1 = bfloat16. lse: a dense float32 (B, H, Sq)
// output for each row's log-sum-exp, or null. Returns cudaGetLastError()
// (or cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int b,
                                   int h, int hkv, int sq, int sk, int d, int dv, long long q_sb,
                                   long long q_sh, long long q_ss, long long k_sb, long long k_sh,
                                   long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                                   long long o_sb, long long o_sh, long long o_ss, float scale,
                                   int causal, int window, int dtype, float* lse,
                                   void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0) return 0;
  if (hkv <= 0 || h % hkv || d <= 0 || d > 192 || dv <= 0 || dv > 128 || sk < 0 ||
      (sq + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, o, b, h, hkv, sq, sk, d, dv, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                 v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, scale, causal, window, lse};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the smallest instance that holds both head dims
  const int inst = d <= 64 && dv <= 64 ? 64 : d <= 128 ? 128 : 192;
  if (dtype == 0)
    return inst == 64    ? launch<float, 64, 64>(p, s)
           : inst == 128 ? launch<float, 128, 128>(p, s)
                         : launch<float, 192, 128>(p, s);
  if (dtype == 1)
    return inst == 64    ? launch<__nv_bfloat16, 64, 64>(p, s)
           : inst == 128 ? launch<__nv_bfloat16, 128, 128>(p, s)
                         : launch<__nv_bfloat16, 192, 128>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 kernel for (d, dv) = (64, 64), (128, 128) or (192, 128)
// (flash_fwd_kernel_wgmma); arguments as flash_attention_fwd's, without the
// dtype. Each of q, k, v, o needs a
// 16-byte aligned base and strides in whole 16-byte units (the TMA's rule);
// the caller makes a dense copy where a tensor breaks it.
extern "C" int flash_attention_fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                                         int b, int h, int hkv, int sq, int sk, int d,
                                         int dv, long long q_sb, long long q_sh, long long q_ss,
                                         long long k_sb, long long k_sh, long long k_ss,
                                         long long v_sb, long long v_sh, long long v_ss,
                                         long long o_sb, long long o_sh, long long o_ss, float scale,
                                         int causal, int window, float* lse, void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0) return 0;
  const bool taken = (d == 64 && dv == 64) || (d == 128 && dv == 128) || (d == 192 && dv == 128);
  if (hkv <= 0 || h % hkv || !taken || sk < 0 || (sq + kWBQ - 1) / kWBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv, mo;
  bool ok = make_map(&mq, q, d, sq, h, b, q_ss, q_sh, q_sb, 64) &&
            make_map(&mo, o, dv, sq, h, b, o_ss, o_sh, o_sb, 64);
  if (sk > 0) {
    ok = ok && make_map(&mk, k, d, sk, hkv, b, k_ss, k_sh, k_sb, kWBK) &&
         make_map(&mv, v, dv, sk, hkv, b, v_ss, v_sh, v_sb, kWBK);
  } else {  // no key tile is loaded: the k and v maps only need to be valid (dv <= d)
    ok = ok && make_map(&mk, q, d, sq, h, b, q_ss, q_sh, q_sb, kWBK) &&
         make_map(&mv, q, dv, sq, h, b, q_ss, q_sh, q_sb, kWBK);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const WgmmaArgs args{h, hkv, sq, sk, causal, window,
                       static_cast<float>(static_cast<double>(scale) * 1.4426950408889634), lse};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d == 64    ? launch_wgmma<64, 64>(mq, mk, mv, mo, args, b, sq, s)
         : d == 128 ? launch_wgmma<128, 128>(mq, mk, mv, mo, args, b, sq, s)
                    : launch_wgmma<192, 128>(mq, mk, mv, mo, args, b, sq, s);
}
