// The chunked linear recurrence (SSD, mLSTM), forward and backward, for Hopper.
//
// Replaces no Pallas kernel: the JAX package's chunked_linear_recurrence
// (src/repro/models/ssm.py) is plain jnp, a scan over chunks. On the card
// the port's plain PyTorch version (models/ssm.py `_recurrence`) wrote every
// chunk's Q x Q decay and score tiles to device memory in float32 and
// carried the state chunk by chunk in a Python loop, two launches a chunk;
// at hymba's 32k prefill that was about 20 times this layer's bound. These
// kernels compute the same function, in float32 arithmetic throughout, in
// a fixed number of launches a call, with no Q x Q tile in device memory.
//
// The function, per (batch b, head h), state S in R^{N x P}, over chunks of
// Q positions with cum the inclusive cumsum of log a inside a chunk and
// tot = cum[Q - 1] (log a = 0 past the sequence's end):
//   y_i   = sum_{j <= i} (q_i . k_j) exp(cum_i - cum_j) v_j + exp(cum_i) S_c^T q_i
//   S_c+1 = exp(tot) S_c + sum_j exp(tot - cum_j) k_j v_j^T
// Above the diagonal the exponent cum_i - cum_j is never exponentiated:
// its weight, and so its gradient, is exactly 0 (the models/ssm.py
// docstring says why the reference's order overflows there).
//
// What bounds it on this card: at hymba's shapes (N 16, P 64, Q 128) a
// chunk of one head is about 1.8 MFLOP forward over the causal triangle
// (3.1 as whole tiles) against 26 KB of bf16 q, k, v and 32 KB of float32
// y: about 11.8 GFLOP and 0.37 GB a layer of a 32k prefill, 0.18 ms at the
// float32 CUDA-core rate (67 TFLOP/s), 0.11 ms of memory at 3.35 TB/s; the
// backward twice the forward's operations. So it is arithmetic in float32
// on the CUDA cores; no tensor core takes float32 operands without rounding
// them (TF32).
//
// Forward, three launches:
//  1. chunk_state_kernel: each chunk's contribution to the carry,
//     sum_j exp(tot - cum_j) k_j v_j^T (N x P), and tot, every chunk at once.
//  2. state_scan_kernel: the carry over the chunks, in order, each thread
//     a few (b, h, n, p) elements; writes each chunk's entering state over
//     its contribution, and the final state.
//  3. chunk_out_kernel: a block per (chunk, b, h) builds the chunk's
//     masked, decayed Q x Q scores in shared memory (K-slices of q and k
//     streamed through shared memory), then y for each 64-wide slice of P:
//     the inter-chunk term from the entering state, then the intra-chunk
//     product, each warp stopping at its own rows' diagonal.
// Backward, the mirror image, three launches:
//  1. chunk_state_kernel again: sum_i exp(cum_i) q_i dy_i^T a chunk.
//  2. state_scan_bwd_kernel: the state's gradient over the chunks in
//     reverse, G_c = exp(tot_c) G_c+1 + that sum; writes each chunk's
//     outgoing gradient G_c+1 over the sum, d initial_state, and each warp's
//     share of dtot_c = <G_c+1, S_c+1>, the whole gradient of tot_c.
//  3. chunk_grad_kernel: a block per (chunk, b, h): the scores, dv, the
//     masked dP = (dy_i . v_j) exp(cum_i - cum_j), dq and dk, and
//     d log a_t = dtot + sum_{t' >= t} (q_t' . dq_t' - k_t' . dk_t').
//
// Shapes adapt to what the call brings: N and P are looped over in slices
// (K-slices of 32, output slices of 64 over P and of 16, 32 or 64 over N),
// so hymba's N 16, P 64 and the mLSTM's N 512, P 513 run the same code; Q
// is any chunk up to 128. Products sum in a fixed order and nothing is
// added by atomics, so a call is bitwise repeatable. Inputs are
// (B, S, H, X) dense, q, k and v float32 or bfloat16 (widened on load),
// log a float32; every output float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 128;       // the largest chunk
constexpr int kSS = kQ + 4;   // row stride of the Q x Q tile and of transposed slices
constexpr int kKT = 32;       // K-slice: rows of a streamed operand
constexpr int kKS = kKT + 4;  // row stride of a row-major K-slice
constexpr int kPT = 64;       // output columns over P
constexpr int kPS = kPT + 4;  // row stride of a 64-wide slice
constexpr int kScanE = 4;     // state elements a thread carries in the scans
constexpr int kScanTile = kThreads * kScanE;
constexpr int kScanWarps = kThreads / 32;
constexpr int kUnroll = 8;    // chunks whose loads a scan issues together

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// an element's bits, and the value of the half-th element packed in a
// 32-bit word (a float, or one of two bfloat16: the first in the low half)
__device__ __forceinline__ unsigned int bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ unsigned int bits(__nv_bfloat16 x) { return __bfloat16_as_ushort(x); }
template <typename T>
__device__ __forceinline__ float unpack(unsigned int w, int half) {
  if constexpr (sizeof(T) == 4) return __uint_as_float(w);
  else return __uint_as_float(half ? (w & 0xffff0000u) : (w << 16));
}

template <int W>
__device__ __forceinline__ void load_vec(float (&d)[W], const float* s) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(s + i);
      d[i] = x.x; d[i + 1] = x.y; d[i + 2] = x.z; d[i + 3] = x.w;
    }
  } else if constexpr (W == 2) {
    const float2 x = *reinterpret_cast<const float2*>(s);
    d[0] = x.x; d[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) d[i] = s[i];
  }
}

// acc[r][c] += sum_{k0 <= k < k1} A(row0 + r, k) B(k, col0 + c), in k order.
// B is [k][col] with row stride ldb. A is k-major (kAK: A[k * lda + row],
// any k range) or row-major (A[row * lda + k], k0 and k1 multiples of 4).
template <int RM, int CN, bool kAK>
__device__ __forceinline__ void mm(float (&acc)[RM][CN], const float* A, int lda,
                                   const float* B, int ldb, int row0, int col0, int k0, int k1) {
  if constexpr (kAK) {
#pragma unroll 2
    for (int k = k0; k < k1; ++k) {
      float a[RM], b[CN];
      load_vec<RM>(a, A + k * lda + row0);
      load_vec<CN>(b, B + k * ldb + col0);
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < CN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  } else {
    for (int k = k0; k < k1; k += 4) {
      float4 a[RM];
#pragma unroll
      for (int r = 0; r < RM; ++r) a[r] = *reinterpret_cast<const float4*>(A + (row0 + r) * lda + k);
      float b[4][CN];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) load_vec<CN>(b[kk], B + (k + kk) * ldb + col0);
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int c = 0; c < CN; ++c) {
          acc[r][c] = fmaf(a[r].x, b[0][c], acc[r][c]);
          acc[r][c] = fmaf(a[r].y, b[1][c], acc[r][c]);
          acc[r][c] = fmaf(a[r].z, b[2][c], acc[r][c]);
          acc[r][c] = fmaf(a[r].w, b[3][c], acc[r][c]);
        }
    }
  }
}

// An R x C slice of an operand into shared memory as float32: slice row r
// is src[r * rs + c0 + c], zero where r >= rv or c0 + c >= cv, times
// scale[r] where given; stored at dst[r * ld + c], or at dst[c * ld + r]
// (kT, transposed). Each thread issues its loads two at a time before it
// stores them, 16 bytes a load where the rows allow (aligned, a whole
// number of 16-byte pieces apart), so a slice costs a trip or two to memory.
template <typename T, int R, int C, bool kT>
__device__ __forceinline__ void load_slice(float* __restrict__ dst, int ld,
                                           const T* __restrict__ src, long long rs, int rv,
                                           int c0, int cv, const float* scale = nullptr) {
  constexpr int V = 16 / sizeof(T);  // elements in 16 bytes
  static_assert(C % V == 0, "a slice row is whole 16-byte pieces");
  constexpr int kPieces = R * C / V;
  constexpr int kIt = (kPieces + kThreads - 1) / kThreads;
  const bool vec = (reinterpret_cast<uintptr_t>(src + c0) & 15) == 0 && rs % V == 0;
  constexpr int kBatch = kIt < 2 ? kIt : 2;  // pieces in registers at once
#pragma unroll
  for (int it0 = 0; it0 < kIt; it0 += kBatch) {
    uint4 got[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = (it0 + u) * kThreads + threadIdx.x;
      const int r = idx / (C / V), cs = idx % (C / V) * V;
      got[u] = make_uint4(0, 0, 0, 0);
      if (it0 + u < kIt && idx < kPieces && r < rv && c0 + cs < cv) {
        const T* at = src + r * rs + c0 + cs;
        if (vec && c0 + cs + V <= cv) {
          got[u] = *reinterpret_cast<const uint4*>(at);
        } else {
          unsigned int w[4] = {0, 0, 0, 0};
#pragma unroll
          for (int e = 0; e < V; ++e)
            if (c0 + cs + e < cv) w[e * 4 / V] |= bits(at[e]) << (e % (V / 4) * 16);
          got[u] = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = (it0 + u) * kThreads + threadIdx.x;
      if (it0 + u >= kIt || idx >= kPieces) break;
      const int r = idx / (C / V), cs = idx % (C / V) * V;
      const float f = (scale != nullptr && r < rv) ? scale[r] : 1.f;
      const unsigned int w[4] = {got[u].x, got[u].y, got[u].z, got[u].w};
      float x[V];
#pragma unroll
      for (int e = 0; e < V; ++e) x[e] = unpack<T>(w[e * 4 / V], e % (V / 4)) * f;
      if (kT) {
#pragma unroll
        for (int e = 0; e < V; ++e) dst[(cs + e) * ld + r] = x[e];
      } else {
#pragma unroll
        for (int e = 0; e < V; e += 4)
          *reinterpret_cast<float4*>(dst + r * ld + cs + e) =
              make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
      }
    }
  }
}

// cum[t], t < kQ, the inclusive cumsum of the chunk's log a (la[t * stride],
// 0 from position `valid` on), by warp 0: every kernel computes it alike,
// so each reads the same values.
__device__ __forceinline__ void chunk_cumsum(const float* la, long long stride, int valid,
                                             float* cum) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  float part[4];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int t = lane * 4 + e;
    run += t < valid ? la[t * stride] : 0.f;
    part[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  float before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) cum[lane * 4 + e] = before + part[e];
}

struct Dims {
  int s, h, n, p, q, nc;
};

// Where a block's chunk lies: its first position's row (b * S + t0), the
// positions it holds, b and h.
struct Chunk {
  long long row0;
  int valid, bh, h;
  __device__ Chunk(const Dims& d) {
    const int c = blockIdx.x;
    bh = blockIdx.y;
    h = bh % d.h;
    row0 = static_cast<long long>(bh / d.h) * d.s + static_cast<long long>(c) * d.q;
    valid = min(d.q, d.s - c * d.q);
  }
  // element (t, x) of a (B, S, H, X) tensor
  __device__ long long at(const Dims& d, int t, int x, int width) const {
    return ((row0 + t) * d.h + h) * width + x;
  }
};

// Forward: each chunk's carry contribution sum_j exp(tot - cum_j) a_j b_j^T
// (a = k, b = v), and tot. Backward (kFwd false): sum_i exp(cum_i) a_i b_i^T
// (a = q, b = dy). A block per (chunk, b, h, 16 RM rows of N, 64 of P).
template <typename TA, typename TB, int RM, bool kFwd>
__global__ void __launch_bounds__(kThreads) chunk_state_kernel(
    const TA* __restrict__ a, const TB* __restrict__ b, const float* __restrict__ la,
    float* __restrict__ out, float* __restrict__ tot_out, Dims d) {
  constexpr int NR = 16 * RM;
  __shared__ float cum[kQ], w[kQ];
  __shared__ __align__(16) float as[kKT * (NR + 4)];  // [j][n], weighted
  __shared__ __align__(16) float bs[kKT * kPS];       // [j][p]
  const Chunk ch(d);
  const int np = (d.p + kPT - 1) / kPT;
  const int n0 = static_cast<int>(blockIdx.z) / np * NR, p0 = static_cast<int>(blockIdx.z) % np * kPT;
  chunk_cumsum(la + ch.row0 * d.h + ch.h, d.h, ch.valid, cum);
  __syncthreads();
  const float tot = cum[kQ - 1];
  if (threadIdx.x < kQ) w[threadIdx.x] = kFwd ? expf(tot - cum[threadIdx.x]) : expf(cum[threadIdx.x]);
  if (kFwd && blockIdx.z == 0 && threadIdx.x == 0)
    tot_out[static_cast<long long>(ch.bh) * d.nc + blockIdx.x] = tot;
  __syncthreads();
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  float acc[RM][4] = {};
  for (int j0 = 0; j0 < ch.valid; j0 += kKT) {
    load_slice<TA, kKT, NR, false>(as, NR + 4, a + ch.at(d, j0, 0, d.n),
                                   static_cast<long long>(d.h) * d.n, ch.valid - j0, n0, d.n, w + j0);
    load_slice<TB, kKT, kPT, false>(bs, kPS, b + ch.at(d, j0, 0, d.p),
                                    static_cast<long long>(d.h) * d.p, ch.valid - j0, p0, d.p);
    __syncthreads();
    mm<RM, 4, true>(acc, as, NR + 4, bs, kPS, rg * RM, cg * 4, 0, min(kKT, ch.valid - j0));
    __syncthreads();
  }
  float* o = out + (static_cast<long long>(ch.bh) * d.nc + blockIdx.x) * d.n * d.p;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int n = n0 + rg * RM + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int p = p0 + cg * 4 + c;
      if (n < d.n && p < d.p) o[static_cast<long long>(n) * d.p + p] = acc[r][c];
    }
  }
}

// The carry in chunk order: st holds each chunk's contribution on entry and
// its entering state on return. Each thread carries kScanE elements of one
// (b, h)'s N x P state.
__global__ void __launch_bounds__(kThreads) state_scan_kernel(
    float* __restrict__ st, const float* __restrict__ tot, const float* __restrict__ init,
    float* __restrict__ final_state, long long np_, int nc) {
  const long long bh = blockIdx.y;
  const long long base = static_cast<long long>(blockIdx.x) * kScanTile + threadIdx.x;
  float s[kScanE];
#pragma unroll
  for (int e = 0; e < kScanE; ++e) {
    const long long i = base + e * kThreads;
    s[e] = (init != nullptr && i < np_) ? init[bh * np_ + i] : 0.f;
  }
  float* sb = st + bh * nc * np_;
  const float* tb = tot + bh * nc;
  for (int c0 = 0; c0 < nc; c0 += kUnroll) {
    float x[kUnroll][kScanE], dec[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u;
      dec[u] = c < nc ? expf(tb[c]) : 0.f;
#pragma unroll
      for (int e = 0; e < kScanE; ++e) {
        const long long i = base + e * kThreads;
        x[u][e] = (c < nc && i < np_) ? sb[c * np_ + i] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u;
      if (c >= nc) break;
#pragma unroll
      for (int e = 0; e < kScanE; ++e) {
        const long long i = base + e * kThreads;
        if (i < np_) sb[c * np_ + i] = s[e];
        s[e] = s[e] * dec[u] + x[u][e];
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kScanE; ++e) {
    const long long i = base + e * kThreads;
    if (i < np_) final_state[bh * np_ + i] = s[e];
  }
}

// The state's gradient in reverse chunk order: g holds sum_i exp(cum_i)
// q_i dy_i^T a chunk on entry and G_c+1, the gradient of the state leaving
// chunk c, on return; dinit gets G_0. Each warp writes its share of
// <G_c+1, S_c+1> to partial[(bh, c), blockIdx.x * kScanWarps + warp].
__global__ void __launch_bounds__(kThreads) state_scan_bwd_kernel(
    float* __restrict__ g, const float* __restrict__ states, const float* __restrict__ final_state,
    const float* __restrict__ tot, const float* __restrict__ dfinal, float* __restrict__ dinit,
    float* __restrict__ partial, long long np_, int nc) {
  const long long bh = blockIdx.y;
  const long long base = static_cast<long long>(blockIdx.x) * kScanTile + threadIdx.x;
  const int nparts = gridDim.x * kScanWarps;
  const int part_at = blockIdx.x * kScanWarps + (threadIdx.x >> 5);
  float gr[kScanE];
#pragma unroll
  for (int e = 0; e < kScanE; ++e) {
    const long long i = base + e * kThreads;
    gr[e] = i < np_ ? dfinal[bh * np_ + i] : 0.f;
  }
  float* gb = g + bh * nc * np_;
  const float* sb = states + bh * nc * np_;
  const float* fb = final_state + bh * np_;
  const float* tb = tot + bh * nc;
  for (int c1 = nc - 1; c1 >= 0; c1 -= kUnroll) {
    float x[kUnroll][kScanE], nxt[kUnroll][kScanE], dec[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c1 - u;
      dec[u] = c >= 0 ? expf(tb[c]) : 0.f;
#pragma unroll
      for (int e = 0; e < kScanE; ++e) {
        const long long i = base + e * kThreads;
        const bool ok = c >= 0 && i < np_;
        x[u][e] = ok ? gb[c * np_ + i] : 0.f;
        nxt[u][e] = !ok ? 0.f : (c == nc - 1 ? fb[i] : sb[(c + 1) * np_ + i]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c1 - u;
      if (c < 0) break;
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < kScanE; ++e) dot = fmaf(gr[e], nxt[u][e], dot);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if ((threadIdx.x & 31) == 0) partial[(bh * nc + c) * nparts + part_at] = dot;
#pragma unroll
      for (int e = 0; e < kScanE; ++e) {
        const long long i = base + e * kThreads;
        if (i < np_) gb[c * np_ + i] = gr[e];
        gr[e] = gr[e] * dec[u] + x[u][e];
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kScanE; ++e) {
    const long long i = base + e * kThreads;
    if (i < np_) dinit[bh * np_ + i] = gr[e];
  }
}

// Shared memory of the two chunk-wide kernels, in floats: cum and a second
// row of kQ, the Q x Q tile, a row-major K-slice of kQ rows, and a region
// that holds either a transposed K-slice (kKT x kSS) or two 64-wide slices.
constexpr int kRegion = 2 * kKT * kPS;
constexpr int kChunkSmemFloats = 2 * kQ + kQ * kSS + kQ * kKS + kRegion;
static_assert(kKT * kSS <= kRegion, "the transposed slice fits the region");
static_assert(kQ * kPS <= kQ * kKS + kRegion, "a kQ-row, 64-wide slice fits the K-slice and region");

// The chunk's Q x Q tile, masked and decayed: sc[i][j] = exp(cum_i - cum_j)
// sum_x a_i[x] b_j[x] for j <= i, else 0, over x < X in K-slices (a and b
// rows of X values at row stride rs). Two halves of 64 columns; a warp
// whose rows lie left of a half skips it.
template <typename TA, typename TB>
__device__ __forceinline__ void masked_scores(float* sc, float* aslice, float* region,
                                              const TA* a, const TB* b, long long rs, int x_dim,
                                              int valid, const float* cum) {
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  const int row0 = rg * 8, col0 = cg * 4;
  const int rowmax = (threadIdx.x >> 5) * 16 + 16;
  const bool resident = x_dim <= kKT;
  for (int half = 0; half < 2; ++half) {
    const int j0 = half * 64;
    float acc[8][4] = {};
    for (int x0 = 0; x0 < x_dim; x0 += kKT) {
      if (!resident || half == 0) {
        __syncthreads();
        load_slice<TA, kQ, kKT, false>(aslice, kKS, a, rs, valid, x0, x_dim);
        load_slice<TB, kQ, kKT, true>(region, kSS, b, rs, valid, x0, x_dim);
        __syncthreads();
      }
      if (j0 < rowmax) {
        const int kn = (min(kKT, x_dim - x0) + 3) & ~3;
        mm<8, 4, false>(acc, aslice, kKS, region + j0, kSS, row0, col0, 0, kn);
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = row0 + r;
      float4 o;
      float* ov = &o.x;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + col0 + c;
        ov[c] = j <= i ? acc[r][c] * expf(cum[i] - cum[j]) : 0.f;
      }
      *reinterpret_cast<float4*>(sc + i * kSS + j0 + col0) = o;
    }
  }
  __syncthreads();
}

// y for a block's chunk (see the header): the scores, then y a 64-wide
// slice of P at a time.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) chunk_out_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ la, const float* __restrict__ states, float* __restrict__ y, Dims d) {
  extern __shared__ float4 smem4[];
  float* cum = reinterpret_cast<float*>(smem4);
  float* sc = cum + 2 * kQ;
  float* qs = sc + kQ * kSS;
  float* region = qs + kQ * kKS;
  const Chunk ch(d);
  chunk_cumsum(la + ch.row0 * d.h + ch.h, d.h, ch.valid, cum);
  __syncthreads();
  const long long rs_n = static_cast<long long>(d.h) * d.n, rs_p = static_cast<long long>(d.h) * d.p;
  masked_scores(sc, qs, region, q + ch.at(d, 0, 0, d.n), k + ch.at(d, 0, 0, d.n), rs_n, d.n,
                ch.valid, cum);
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  const int row0 = rg * 8, col0 = cg * 4;
  const int rowmax = (threadIdx.x >> 5) * 16 + 16;
  const bool resident = d.n <= kKT;  // qs holds q's only K-slice until v overwrites it
  const float* sprev = states + (static_cast<long long>(ch.bh) * d.nc + blockIdx.x) * d.n * d.p;
  float* vs = qs;  // v's 64-wide slice, all kQ rows, over qs and the region
  for (int p0 = 0; p0 < d.p; p0 += kPT) {
    float acc[8][4] = {};
    for (int n0 = 0; n0 < d.n; n0 += kKT) {  // exp(cum_i) S^T q_i
      __syncthreads();
      if (!resident || p0 > 0)
        load_slice<T, kQ, kKT, false>(qs, kKS, q + ch.at(d, 0, 0, d.n), rs_n, ch.valid, n0, d.n);
      load_slice<float, kKT, kPT, false>(region, kPS, sprev + static_cast<long long>(n0) * d.p, d.p,
                                         d.n - n0, p0, d.p);
      __syncthreads();
      mm<8, 4, false>(acc, qs, kKS, region, kPS, row0, col0, 0, (min(kKT, d.n - n0) + 3) & ~3);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float e = expf(cum[row0 + r]);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] *= e;
    }
    __syncthreads();  // the scores times v, up to the diagonal
    load_slice<T, kQ, kPT, false>(vs, kPS, v + ch.at(d, 0, 0, d.p), rs_p, ch.valid, p0, d.p);
    __syncthreads();
    mm<8, 4, false>(acc, sc, kSS, vs, kPS, row0, col0, 0, rowmax);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = row0 + r;
      if (i >= ch.valid) break;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int p = p0 + col0 + c;
        if (p < d.p) y[ch.at(d, i, p, d.p)] = acc[r][c];
      }
    }
  }
}

// Adds each row's sum_c x(row, col0 + c) acc[r][c] over the 16 threads that
// share the row (x's rows at row stride rs, columns below x_dim) to
// dcum[row] times sign: one writer a row, in a fixed order.
template <typename T, int CN>
__device__ __forceinline__ void row_dots(float* dcum, const float (&acc)[8][CN], const T* x,
                                         long long rs, int x_dim, int valid, int row0, int col0,
                                         float sign) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = row0 + r;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < CN; ++c)
      if (i < valid && col0 + c < x_dim) s = fmaf(widen(x[i * rs + col0 + c]), acc[r][c], s);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if ((threadIdx.x & 15) == 0) dcum[i] += sign * s;
  }
}

// The gradients of a block's chunk (see the header). NT: the columns of
// each dq and dk slice (16, 32 or 64, from N).
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 2) chunk_grad_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ la, const float* __restrict__ dy, const float* __restrict__ states,
    const float* __restrict__ gout, const float* __restrict__ partial, int nparts,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ dla, Dims d) {
  constexpr int CN = NT / 16, NS = NT + 4;
  extern __shared__ float4 smem4[];
  float* cum = reinterpret_cast<float*>(smem4);
  float* dcum = cum + kQ;
  float* sc = dcum + kQ;
  float* ks = sc + kQ * kSS;  // a row-major K-slice (kQ x kKT)
  float* region = ks + kQ * kKS;
  float* wide = ks;  // an intra product's kQ-row operand, over ks and the region
  const Chunk ch(d);
  chunk_cumsum(la + ch.row0 * d.h + ch.h, d.h, ch.valid, cum);
  if (threadIdx.x < kQ) dcum[threadIdx.x] = 0.f;
  __syncthreads();
  const float tot = cum[kQ - 1];
  const long long rs_n = static_cast<long long>(d.h) * d.n, rs_p = static_cast<long long>(d.h) * d.p;
  const T* qc = q + ch.at(d, 0, 0, d.n);
  const T* kc = k + ch.at(d, 0, 0, d.n);
  const T* vc = v + ch.at(d, 0, 0, d.p);
  const float* dyc = dy + ch.at(d, 0, 0, d.p);
  const long long sbase = (static_cast<long long>(ch.bh) * d.nc + blockIdx.x) * d.n * d.p;
  const float* sprev = states + sbase;
  const float* gc = gout + sbase;
  const int warp = threadIdx.x >> 5;
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  const int row0 = rg * 8;
  const int rowmin = warp * 16, rowmax = rowmin + 16;

  // the scores, for dv
  masked_scores(sc, ks, region, qc, kc, rs_n, d.n, ch.valid, cum);

  // dv_j = sum_{i >= j} sc[i][j] dy_i + exp(tot - cum_j) G^T k_j
  for (int p0 = 0; p0 < d.p; p0 += kPT) {
    float acc[8][4] = {};
    for (int n0 = 0; n0 < d.n; n0 += kKT) {
      __syncthreads();
      load_slice<T, kQ, kKT, false>(ks, kKS, kc, rs_n, ch.valid, n0, d.n);
      load_slice<float, kKT, kPT, false>(region, kPS, gc + static_cast<long long>(n0) * d.p, d.p,
                                         d.n - n0, p0, d.p);
      __syncthreads();
      mm<8, 4, false>(acc, ks, kKS, region, kPS, row0, cg * 4, 0, (min(kKT, d.n - n0) + 3) & ~3);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float e = expf(tot - cum[row0 + r]);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] *= e;
    }
    __syncthreads();
    load_slice<float, kQ, kPT, false>(wide, kPS, dyc, rs_p, ch.valid, p0, d.p);
    __syncthreads();
    mm<8, 4, true>(acc, sc, kSS, wide, kPS, row0, cg * 4, rowmin, d.q);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int j = row0 + r;
      if (j >= ch.valid) break;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int p = p0 + cg * 4 + c;
        if (p < d.p) dv[ch.at(d, j, p, d.p)] = acc[r][c];
      }
    }
  }

  // the masked dP over the scores: dp[i][j] = exp(cum_i - cum_j) dy_i . v_j, j <= i
  masked_scores(sc, ks, region, dyc, vc, rs_p, d.p, ch.valid, cum);

  // dq_i = sum_{j <= i} dp[i][j] k_j + exp(cum_i) S dy_i, and dcum_i += q_i . dq_i
  for (int n0 = 0; n0 < d.n; n0 += NT) {
    float acc[8][CN] = {};
    for (int p0 = 0; p0 < d.p; p0 += kKT) {
      __syncthreads();
      load_slice<float, kQ, kKT, false>(ks, kKS, dyc, rs_p, ch.valid, p0, d.p);
      load_slice<float, NT, kKT, true>(region, NS, sprev + static_cast<long long>(n0) * d.p, d.p,
                                       d.n - n0, p0, d.p);  // [p][n]
      __syncthreads();
      mm<8, CN, false>(acc, ks, kKS, region, NS, row0, cg * CN, 0, (min(kKT, d.p - p0) + 3) & ~3);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float e = expf(cum[row0 + r]);
#pragma unroll
      for (int c = 0; c < CN; ++c) acc[r][c] *= e;
    }
    __syncthreads();
    load_slice<T, kQ, NT, false>(wide, NS, kc, rs_n, ch.valid, n0, d.n);
    __syncthreads();
    mm<8, CN, false>(acc, sc, kSS, wide, NS, row0, cg * CN, 0, rowmax);
    row_dots<T, CN>(dcum, acc, qc + n0, rs_n, d.n - n0, ch.valid, row0, cg * CN, 1.f);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = row0 + r;
      if (i >= ch.valid) break;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const int n = n0 + cg * CN + c;
        if (n < d.n) dq[ch.at(d, i, n, d.n)] = acc[r][c];
      }
    }
  }

  // dk_j = sum_{i >= j} dp[i][j] q_i + exp(tot - cum_j) G v_j, and dcum_j -= k_j . dk_j
  for (int n0 = 0; n0 < d.n; n0 += NT) {
    float acc[8][CN] = {};
    for (int p0 = 0; p0 < d.p; p0 += kKT) {
      __syncthreads();
      load_slice<T, kQ, kKT, false>(ks, kKS, vc, rs_p, ch.valid, p0, d.p);
      load_slice<float, NT, kKT, true>(region, NS, gc + static_cast<long long>(n0) * d.p, d.p,
                                       d.n - n0, p0, d.p);  // [p][n]
      __syncthreads();
      mm<8, CN, false>(acc, ks, kKS, region, NS, row0, cg * CN, 0, (min(kKT, d.p - p0) + 3) & ~3);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float e = expf(tot - cum[row0 + r]);
#pragma unroll
      for (int c = 0; c < CN; ++c) acc[r][c] *= e;
    }
    __syncthreads();
    load_slice<T, kQ, NT, false>(wide, NS, qc, rs_n, ch.valid, n0, d.n);
    __syncthreads();
    mm<8, CN, true>(acc, sc, kSS, wide, NS, row0, cg * CN, rowmin, d.q);
    row_dots<T, CN>(dcum, acc, kc + n0, rs_n, d.n - n0, ch.valid, row0, cg * CN, -1.f);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int j = row0 + r;
      if (j >= ch.valid) break;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const int n = n0 + cg * CN + c;
        if (n < d.n) dk[ch.at(d, j, n, d.n)] = acc[r][c];
      }
    }
  }
  __syncthreads();

  // d log a_t = dtot + sum_{t' >= t} dcum_t', by warp 0: dtot from the
  // scan's shares in order, then a reverse inclusive scan over the chunk
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const float* parts = partial + (static_cast<long long>(ch.bh) * d.nc + blockIdx.x) * nparts;
  float dtot = 0.f;
  for (int i = lane; i < nparts; i += 32) dtot += parts[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) dtot += __shfl_xor_sync(0xffffffffu, dtot, off);
  // lane l holds positions 4 (31 - l) .. 4 (31 - l) + 3, so the scan runs up the lanes
  const int t0 = (31 - lane) * 4;
  float part[4];
  float run = 0.f;
#pragma unroll
  for (int e = 3; e >= 0; --e) {
    run += dcum[t0 + e];
    part[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  float after = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) after = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int t = t0 + e;
    if (t < ch.valid) dla[(ch.row0 + t) * d.h + ch.h] = dtot + (after + part[e]);
  }
}

template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

constexpr int kChunkSmemBytes = kChunkSmemFloats * static_cast<int>(sizeof(float));

template <typename TA, typename TB, bool kFwd>
int launch_state(const TA* a, const TB* b, const float* la, float* out, float* tot, const Dims& d,
                 int bh, cudaStream_t stream) {
  const int np = (d.p + kPT - 1) / kPT;
  if (d.n <= 64) {
    const dim3 grid(d.nc, bh, ((d.n + 15) / 16) * np);
    chunk_state_kernel<TA, TB, 1, kFwd><<<grid, kThreads, 0, stream>>>(a, b, la, out, tot, d);
  } else {
    const dim3 grid(d.nc, bh, ((d.n + 127) / 128) * np);
    chunk_state_kernel<TA, TB, 8, kFwd><<<grid, kThreads, 0, stream>>>(a, b, la, out, tot, d);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int forward(const void* q, const void* k, const void* v, const float* la, const float* init,
            float* y, float* states, float* final_state, float* tot, const Dims& d, int bh,
            cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  int err = launch_state<T, T, true>(kt, vt, la, states, tot, d, bh, stream);
  if (err) return err;
  const long long np_ = static_cast<long long>(d.n) * d.p;
  state_scan_kernel<<<dim3((np_ + kScanTile - 1) / kScanTile, bh), kThreads, 0, stream>>>(
      states, tot, init, final_state, np_, d.nc);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  if ((err = allow_smem(chunk_out_kernel<T>, kChunkSmemBytes))) return err;
  chunk_out_kernel<T><<<dim3(d.nc, bh), kThreads, kChunkSmemBytes, stream>>>(qt, kt, vt, la,
                                                                             states, y, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NT>
int launch_grad(const T* q, const T* k, const T* v, const float* la, const float* dy,
                const float* states, const float* g, const float* partial, int nparts, float* dq,
                float* dk, float* dv, float* dla, const Dims& d, int bh, cudaStream_t stream) {
  int err = allow_smem(chunk_grad_kernel<T, NT>, kChunkSmemBytes);
  if (err) return err;
  chunk_grad_kernel<T, NT><<<dim3(d.nc, bh), kThreads, kChunkSmemBytes, stream>>>(
      q, k, v, la, dy, states, g, partial, nparts, dq, dk, dv, dla, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int backward(const void* q, const void* k, const void* v, const float* la, const float* states,
             const float* final_state, const float* tot, const float* dy, const float* dfinal,
             float* g, float* partial, float* dq, float* dk, float* dv, float* dla, float* dinit,
             const Dims& d, int bh, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  int err = launch_state<T, float, false>(qt, dy, la, g, nullptr, d, bh, stream);
  if (err) return err;
  const long long np_ = static_cast<long long>(d.n) * d.p;
  const int tiles = static_cast<int>((np_ + kScanTile - 1) / kScanTile);
  state_scan_bwd_kernel<<<dim3(tiles, bh), kThreads, 0, stream>>>(
      g, states, final_state, tot, dfinal, dinit, partial, np_, d.nc);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  const int nparts = tiles * kScanWarps;
  if (d.n <= 16)
    return launch_grad<T, 16>(qt, kt, vt, la, dy, states, g, partial, nparts, dq, dk, dv, dla, d, bh, stream);
  if (d.n <= 32)
    return launch_grad<T, 32>(qt, kt, vt, la, dy, states, g, partial, nparts, dq, dk, dv, dla, d, bh, stream);
  return launch_grad<T, 64>(qt, kt, vt, la, dy, states, g, partial, nparts, dq, dk, dv, dla, d, bh, stream);
}

bool bad_dims(int b, int s, int h, int n, int p, int q) {
  if (b < 1 || s < 1 || h < 1 || n < 1 || p < 1 || q < 1 || q > kQ) return true;
  const long long nc = (static_cast<long long>(s) + q - 1) / q;
  return nc > 0x7fffffffLL || static_cast<long long>(b) * h > 65535;
}

}  // namespace

// Scratch the wrapper allocates: tot float32[B * H * nc]; the backward's g
// float32[B * H * nc * N * P] and partial float32[B * H * nc * nparts],
// nparts = 8 ceil(N P / 1024). states: float32 (B, H, nc, N, P), each
// chunk's entering state; init (or null) and final_state (B, H, N, P).
// dtype 0: q, k, v float32; 1: bfloat16. Returns cudaGetLastError().
extern "C" int linear_recurrence_fwd(const void* q, const void* k, const void* v, const void* la,
                                     const void* init, void* y, void* states, void* final_state,
                                     void* tot, int b, int s, int h, int n, int p, int q_len,
                                     int dtype, void* stream) {
  if (bad_dims(b, s, h, n, p, q_len)) return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{s, h, n, p, q_len, (s + q_len - 1) / q_len};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* laf = static_cast<const float*>(la);
  const float* initf = static_cast<const float*>(init);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(states);
  float* ff = static_cast<float*>(final_state);
  float* tf = static_cast<float*>(tot);
  if (dtype == 1) return forward<__nv_bfloat16>(q, k, v, laf, initf, yf, sf, ff, tf, d, b * h, st);
  if (dtype == 0) return forward<float>(q, k, v, laf, initf, yf, sf, ff, tf, d, b * h, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int linear_recurrence_bwd(const void* q, const void* k, const void* v, const void* la,
                                     const void* states, const void* final_state, const void* tot,
                                     const void* dy, const void* dfinal, void* g, void* partial,
                                     void* dq, void* dk, void* dv, void* dla, void* dinit, int b,
                                     int s, int h, int n, int p, int q_len, int dtype,
                                     void* stream) {
  if (bad_dims(b, s, h, n, p, q_len)) return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{s, h, n, p, q_len, (s + q_len - 1) / q_len};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* x) { return static_cast<const float*>(x); };
  auto w = [](void* x) { return static_cast<float*>(x); };
  if (dtype == 1)
    return backward<__nv_bfloat16>(q, k, v, f(la), f(states), f(final_state), f(tot), f(dy),
                                   f(dfinal), w(g), w(partial), w(dq), w(dk), w(dv), w(dla),
                                   w(dinit), d, b * h, st);
  if (dtype == 0)
    return backward<float>(q, k, v, f(la), f(states), f(final_state), f(tot), f(dy), f(dfinal),
                           w(g), w(partial), w(dq), w(dk), w(dv), w(dla), w(dinit), d, b * h, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
