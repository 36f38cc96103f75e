// Forward GQA flash attention (causal and/or sliding window) for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/
// flash_attention.py (`_kernel`, launched by `flash_attention_padded`):
// q (B, H, Sq, D), k and v (B, Hkv, Sk, D), float32 or bfloat16; query head
// h reads kv head h / (H / Hkv); scores, the online softmax (m, l, acc) and
// the PV product in float32; keys at positions >= Sk masked, causal
// kpos <= qpos and window kpos > qpos - window on absolute positions from 0
// (top-left aligned when Sq != Sk); a row with no visible key is exactly 0;
// the output in q's dtype.
//
// What bounds it on this card: arithmetic. Over the visible (q, k) pairs it
// does 4 * D operations each (QK^T and PV); at the serve path's prefill
// (H = 16, Hkv = 8, Sq = Sk = 2048, D = 128, causal) that is 17.2 GFLOP
// against 25.2 MB of q, k, v and output, far above the ~295 operations per
// byte where the bf16 tensor cores (989 TFLOP/s) stop waiting on memory:
// 0.0174 ms at the tensor-core rate.
//
// What this first design does about it: the simple, exact form. The
// arithmetic runs on the fp32 CUDA cores (67 TFLOP/s), bf16 widened with
// __bfloat162float on load, so the kernel computes what K3 computes (the
// probabilities stay float32 for PV, as in the Pallas kernel); it cannot
// pass 67/989 of the bf16 bound. wgmma, TMA and a bf16 tensor-core PV
// product are later work.
//  * One block of 256 threads per (b, h, 64-row q tile); the TPU grid's
//    sequential k axis becomes a loop over 64-key tiles inside the block,
//    bounded to the tiles with a visible pair (causal and window skip).
//    The heaviest causal q tiles are launched first.
//  * q, k and v tiles are staged in shared memory as float32 (q padded to
//    DMAX + 4 and k to DMAX + 1 floats a row, so the column reads of the
//    score loop hit distinct banks); P reuses k's buffer.
//  * Thread (ty, tx) owns rows 4ty..4ty+3: 4 x 4 scores and 4 x DMAX/16
//    output columns in registers. Row max and row sum reduce across the 16
//    lanes of a row group with warp shuffles; m and l stay in registers.
//  * Ragged edges (Sq, Sk, D below the tile sizes) are masked in the
//    kernel, so nothing is padded in device memory; strides are arguments,
//    so (B, S, H, D) activations need no transposing copy.

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
  int b, h, hkv, sq, sk, d;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  float scale;
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
  return __float2bfloat16(x);  // round to nearest even, as astype(bfloat16)
}

template <int DMAX>
constexpr int smem_floats() {
  return kBQ * (DMAX + 4) + kBK * (DMAX + 1) + kBK * DMAX;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  static_assert(DMAX % 16 == 0, "DMAX must be a multiple of 16");
  static_assert(kBK * (DMAX + 1) >= kBQ * kPP, "P must fit in the k buffer");
  constexpr int QP = DMAX + 4;
  constexpr int KP = DMAX + 1;
  constexpr int NC = DMAX / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;              // [kBQ][QP]
  float* sK = sQ + kBQ * QP;     // [kBK][KP], then P [kBQ][kPP]
  float* sV = sK + kBK * KP;     // [kBK][DMAX]
  float* sP = sK;
  const float NEG_INF = __int_as_float(0xff800000);

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;
  const int bi = bh / p.h, hi = bh % p.h;
  const int kvh = hi / (p.h / p.hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest causal tiles first
  const int d = p.d;

  const T* qg = static_cast<const T*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + bi * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + bi * p.v_sb + kvh * p.v_sh;
  T* og = static_cast<T*>(p.o) + bi * p.o_sb + hi * p.o_sh;

  for (int i = tid; i < kBQ * DMAX; i += kThreads) {
    const int r = i / DMAX, c = i % DMAX;
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
    for (int i = tid; i < kBK * DMAX; i += kThreads) {
      const int r = i / DMAX, c = i % DMAX;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < p.sk && c < d) {
        kx = to_f32(kg[static_cast<long long>(k0 + r) * p.k_ss + c]);
        vx = to_f32(vg[static_cast<long long>(k0 + r) * p.v_ss + c]);
      }
      sK[r * KP + c] = kx;
      sV[r * DMAX + c] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DMAX; ++c) {
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
        const float vv = sV[kk * DMAX + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) og[static_cast<long long>(row) * p.o_ss + col] = from_f32<T>(acc[i][c] / den);
    }
  }
}

template <typename T, int DMAX>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int bytes = smem_floats<DMAX>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(p.b * p.h), static_cast<unsigned>((p.sq + kBQ - 1) / kBQ));
  flash_fwd_kernel<T, DMAX><<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: element strides (batch, head, seq) each, the last dimension
// dense. dtype 0 = float32, 1 = bfloat16. Returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int b,
                                   int h, int hkv, int sq, int sk, int d, long long q_sb,
                                   long long q_sh, long long q_ss, long long k_sb, long long k_sh,
                                   long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                                   long long o_sb, long long o_sh, long long o_ss, float scale,
                                   int causal, int window, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0) return 0;
  if (hkv <= 0 || h % hkv || d <= 0 || d > 128 || sk < 0 || (sq + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, o, b, h, hkv, sq, sk, d, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                 v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, scale, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return d <= 64 ? launch<float, 64>(p, s) : launch<float, 128>(p, s);
  if (dtype == 1) return d <= 64 ? launch<__nv_bfloat16, 64>(p, s) : launch<__nv_bfloat16, 128>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
