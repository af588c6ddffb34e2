// Causal GQA flash attention for training in fp32, with its backward, for
// Hopper (sm_90a): fp32 in and out, every product a full-fp32 FFMA (no
// TF32, no bf16), fp32 softmax state.
//
// Replaces no TPU kernel.  The JAX package trains attention on "auto"
// (dense or chunked XLA code): its Pallas flash kernel has no custom_vjp,
// so there is no backward kernel to port.  This kernel set takes the place
// of models/attention.py::chunked_attention and dense_attention on the
// port's training path, where the configurations ask for fp32 compute
// without TF32: there the blocked attention in plain PyTorch writes every
// (q block, kv block) logits block to device memory six times over, and
// autograd keeps those blocks for the backward.  Here nothing but O and
// the per-row log-sum-exp leaves the chip in the forward.
//
// Three entries, each one launch:
//   flash_train_fwd   O (B,S,H,D) and LSE (B,H,S) from q, k, v;
//   flash_train_dq    Delta = rowsum(dO * O) (B,H,S), then dQ;
//   flash_train_dkdv  dK and dV (B,S,KV,D), summed over the G = H / KV
//                     query heads of each kv head inside the block.
// The backward recomputes P from Q, K and the LSE.  No float atomics: each
// output element is written by one thread, so two calls give the same
// bits.
//
// Masking is models/attention.py::_mask's: key j is seen by query i when
// k_pos[j] >= 0, k_pos[j] <= q_pos[i] and, with a window, q_pos[i] -
// k_pos[j] < window; masked scores are NEG_INF = -2e38 in the forward (so a
// row that sees no key averages the keys it visited, as chunked_attention
// does) and P = 0 in the backward.  Which tiles are visited rests on the
// assumption chunked_attention states: q_pos = k_pos = offset + arange(S),
// so tiles wholly after the diagonal, or wholly before the window, are
// never loaded.  The mask inside the visited tiles reads the positions.
//
// Bound on the H100: the operations.  The forward does 4 * D FLOPs per
// kept (query, key) pair and head, about S^2 / 2 pairs: at B 2, S 4096,
// H 32, D 64 that is 137 GFLOP, 2.05 ms at the 67 TFLOP/s fp32 peak.  The
// backward does 3.5 times that (dQ: three products; dK/dV: four; 7 / 2 of
// the forward's two), 7.2 ms.  Every byte is read a few times at most:
// bandwidth is not the limit.
//
// Design.  Without tensor cores the rate comes from register micro-tiles,
// as in a SIMT SGEMM.  A block owns 64 rows (queries in the forward and
// dQ, keys in dK/dV) and streams tiles of 64 rows of the other side
// through shared memory (cp.async, a two-stage ring in the forward, one
// stage in the backward passes, whose other operands take the room).  It
// has 2 * D threads: 16 thread rows of 4 rows each, by D / 8 thread
// columns.  Every product is one of two shapes:
//   gemm_nt  acc (4 rows x 64 / TX streamed rows) += A^T B^T over D, A
//            stored transposed ([D][TP], loaded once with plain loads),
//            B the streamed tile as it is in memory ([64][D + 4]), one
//            float4 of 4 d's per streamed row at a time (thread column tx
//            takes streamed rows tx, tx + TX, ...; the pitch D + 4 puts 8
//            consecutive rows in 8 different bank groups);
//   gemm_tn  acc (4 rows x 8 of D) += A B over the 64 streamed rows, A the
//            transposed scores P or dS that the block wrote ([64][TP]), B
//            the streamed tile (columns tx * 4 .. + 3 and D / 2 + tx * 4
//            .. + 3: a quarter warp reads 128 contiguous bytes).
// The 4 rows of a thread are contiguous, so every A read is one float4
// that a quarter warp shares.  Per d: one or two float4 loads of A and B
// for 32 FFMAs.  The online softmax keeps each row's max and sum in
// registers, in log2 units with the scale folded in (ex2.approx: one FFMA
// and one MUFU.EX2 per score); a row's keys lie in the D / 8 lanes of a
// thread row, so its max takes three or four shuffles.  One block per
// (64 queries, head, batch) in the forward and dQ, heads fastest in the
// grid, so the G blocks that read one kv head run side by side and each
// K/V tile comes from device memory once and from L2 for the other heads;
// one block per (64 keys, kv head, batch) in dK/dV, which loops over the
// G heads and the query tiles from the diagonal down.  Blocks are issued
// longest first.
#include "attention_tile.cuh"

namespace {

constexpr int BM = 64;  // rows a block owns
constexpr int BN = 64;  // rows of a streamed tile
constexpr int TY = 16;  // thread rows, 4 rows each
constexpr int TP = 68;  // pitch of a transposed tile, floats
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
__host__ __device__ constexpr int nthreads() { return 2 * D; }
template <int D>
__host__ __device__ constexpr int tcols() {  // TX, thread columns
  return D / 8;
}
template <int D>
__host__ __device__ constexpr int rpitch() {  // pitch of a streamed tile
  return D + 4;
}

// Shared memory, in floats, of each entry (one block):
// Q^T, P^T, two stages of K, V, k_pos
template <int D>
__host__ __device__ constexpr int fwd_floats() {
  return D * TP + BN * TP + 2 * (2 * BN * rpitch<D>() + BN);
}
// Q^T, dO^T, dS^T, K, V, k_pos, Delta
template <int D>
__host__ __device__ constexpr int dq_floats() {
  return 2 * D * TP + BN * TP + 2 * BN * rpitch<D>() + BN + BM;
}
// K^T, V^T, P, dS, Q, dO, q_pos, LSE, Delta
template <int D>
__host__ __device__ constexpr int dkdv_floats() {
  return 2 * D * TP + 2 * BN * TP + 2 * BN * rpitch<D>() + 3 * BN;
}
template <int D>
__host__ __device__ constexpr int fwd_bytes() {
  return fwd_floats<D>() * 4;
}
template <int D>
__host__ __device__ constexpr int dq_bytes() {
  return dq_floats<D>() * 4;
}
template <int D>
__host__ __device__ constexpr int dkdv_bytes() {
  return dkdv_floats<D>() * 4;
}

struct PosArgs {
  const long long* q;
  const long long* k;
  long long q_sb, q_ss, k_sb, k_ss;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ float comp(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// BN rows of D floats (row r at src + r * stride) into dst[r][rpitch]
// with cp.async; rows >= n_valid are zero-filled (n_valid >= 1).
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int n_valid) {
  constexpr int C4 = D / 4;
  static_assert(BN * C4 % nthreads<D>() == 0, "whole copies per thread");
#pragma unroll
  for (int j = 0; j < BN * C4 / nthreads<D>(); ++j) {
    const int i = threadIdx.x + j * nthreads<D>();
    const int r = i / C4, c = i % C4;
    const bool ok = r < n_valid;
    rt::cp_async16(rt::smem_u32(dst + r * rpitch<D>() + c * 4),
                   ok ? src + r * stride + c * 4 : src, ok ? 16 : 0);
  }
}

// BM rows of D floats into dst[d][TP] (transposed), with plain loads: a
// lane pair reads one 32-byte sector of a row, a warp 16 rows.
template <int D>
__device__ __forceinline__ void load_transposed(float* dst, const float* src,
                                                long long stride,
                                                int n_valid) {
  constexpr int C4 = D / 4;
  static_assert(BM * C4 % nthreads<D>() == 0, "whole loads per thread");
#pragma unroll
  for (int j = 0; j < BM * C4 / nthreads<D>(); ++j) {
    const int i = threadIdx.x + j * nthreads<D>();
    const int c = 2 * (i / (2 * BM)) + (i & 1);
    const int r = (i >> 1) % BM;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_valid) x = ld4(src + r * stride + c * 4);
    dst[(c * 4 + 0) * TP + r] = x.x;
    dst[(c * 4 + 1) * TP + r] = x.y;
    dst[(c * 4 + 2) * TP + r] = x.z;
    dst[(c * 4 + 3) * TP + r] = x.w;
  }
}

// acc[i][j] = sum_d At[d][r0 + i] * Bs[tx + TX * j][d]
template <int D>
__device__ __forceinline__ void gemm_nt(float (&acc)[4][BN / tcols<D>()],
                                        const float* At, const float* Bs,
                                        int r0, int tx) {
  constexpr int TX = tcols<D>(), NJ = BN / TX;
  static_assert(TY * 4 == BM && TY * TX == nthreads<D>(), "thread grid");
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int d4 = 0; d4 < D / 4; ++d4) {
    float4 b[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      b[j] = ld4(Bs + (tx + TX * j) * rpitch<D>() + d4 * 4);
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      const float4 a = ld4(At + (d4 * 4 + dd) * TP + r0);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float bj = comp(b[j], dd);
        acc[0][j] = fmaf(a.x, bj, acc[0][j]);
        acc[1][j] = fmaf(a.y, bj, acc[1][j]);
        acc[2][j] = fmaf(a.z, bj, acc[2][j]);
        acc[3][j] = fmaf(a.w, bj, acc[3][j]);
      }
    }
  }
}

// acc[i][c] += sum_n As[n][r0 + i] * Bs[n][col(c)], col(c) = tx * 4 + c
// for c < 4 and D / 2 + tx * 4 + c - 4 after
template <int D>
__device__ __forceinline__ void gemm_tn(float (&acc)[4][8], const float* As,
                                        const float* Bs, int r0, int tx) {
#pragma unroll 4
  for (int n = 0; n < BN; ++n) {
    const float4 a = ld4(As + n * TP + r0);
    const float4 b0 = ld4(Bs + n * rpitch<D>() + tx * 4);
    const float4 b1 = ld4(Bs + n * rpitch<D>() + D / 2 + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i][0] = fmaf(av[i], b0.x, acc[i][0]);
      acc[i][1] = fmaf(av[i], b0.y, acc[i][1]);
      acc[i][2] = fmaf(av[i], b0.z, acc[i][2]);
      acc[i][3] = fmaf(av[i], b0.w, acc[i][3]);
      acc[i][4] = fmaf(av[i], b1.x, acc[i][4]);
      acc[i][5] = fmaf(av[i], b1.y, acc[i][5]);
      acc[i][6] = fmaf(av[i], b1.z, acc[i][6]);
      acc[i][7] = fmaf(av[i], b1.w, acc[i][7]);
    }
  }
}

// The thread's 4 x NJ scores into dst[tx + TX * j][r0 .. r0 + 3]
template <int D>
__device__ __forceinline__ void store_t(float* dst,
                                        const float (&s)[4][BN / tcols<D>()],
                                        int r0, int tx) {
  constexpr int TX = tcols<D>();
#pragma unroll
  for (int j = 0; j < BN / TX; ++j)
    st4(dst + (tx + TX * j) * TP + r0, s[0][j], s[1][j], s[2][j], s[3][j]);
}

// rows [r0, r0 + 3] of acc (4 x 8) into a (rows, D) matrix at base
// (row stride rs): columns tx * 4 .. + 3 and D / 2 + tx * 4 .. + 3
template <int D>
__device__ __forceinline__ void store_rows(float* base, long long rs,
                                           const float (&acc)[4][8], int row0,
                                           int n_rows, int tx, float mul) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (row0 + i >= n_rows) continue;
    float* p = base + (long long)(row0 + i) * rs;
    st4(p + tx * 4, acc[i][0] * mul, acc[i][1] * mul, acc[i][2] * mul,
        acc[i][3] * mul);
    st4(p + D / 2 + tx * 4, acc[i][4] * mul, acc[i][5] * mul,
        acc[i][6] * mul, acc[i][7] * mul);
  }
}

__device__ __forceinline__ bool visible(int qp, int kp, int window) {
  return kp >= 0 && kp <= qp && (window == 0 || qp - kp < window);
}

// ---------------------------------------------------------------------------
// Forward: one block per (64 queries, head, batch)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(2 * D, D == 64 ? 2 : 1)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o,
           float* __restrict__ lse, PosArgs pos, int H, int KV, int S,
           rt::Strides qst, rt::Strides kst, rt::Strides vst, rt::Strides ost,
           float scale, int window) {
  constexpr int TX = tcols<D>(), NJ = BN / TX, RP = rpitch<D>();
  extern __shared__ float4 smem4[];
  float* const qt = reinterpret_cast<float*>(smem4);  // [D][TP]
  float* const pt = qt + D * TP;                      // [BN][TP]
  float* const kv0 = pt + BN * TP;  // stage s: K, V, k_pos at
                                    // kv0 + s * (2 * BN * RP + BN)

  const int h = blockIdx.x, b = blockIdx.z;
  const int n_qt = (S + BM - 1) / BM;
  const int q0 = (n_qt - 1 - blockIdx.y) * BM;  // longest rows first
  const int kvh = h / (H / KV);
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX, r0 = ty * 4;

  const int k_end = min(q0 + BM, S);
  const int t_begin = window ? max(0, q0 - window + 1) / BN : 0;
  const int t_end = (k_end + BN - 1) / BN;

  const float* kb = k + b * kst.b + kvh * kst.h;
  const float* vb = v + b * vst.b + kvh * vst.h;
  const long long* kpb = pos.k + b * pos.k_sb;
  auto load_kv = [&](int tile, int stage) {
    const int key0 = tile * BN;
    const int n = min(BN, S - key0);
    float* ks = kv0 + stage * (2 * BN * RP + BN);
    load_rows<D>(ks, kb + (long long)key0 * kst.s, kst.s, n);
    load_rows<D>(ks + BN * RP, vb + (long long)key0 * vst.s, vst.s, n);
    int* kp = reinterpret_cast<int*>(ks + 2 * BN * RP);
    for (int i = threadIdx.x; i < BN; i += nthreads<D>())
      kp[i] = i < n ? (int)kpb[(long long)(key0 + i) * pos.k_ss] : -1;
  };
  load_kv(t_begin, 0);
  rt::cp_async_commit();
  load_transposed<D>(qt, q + b * qst.b + h * qst.h + (long long)q0 * qst.s,
                     qst.s, min(BM, S - q0));

  int qp[4];
  const long long* qpb = pos.q + b * pos.q_sb;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    qp[i] = q0 + r0 + i < S ? (int)qpb[(long long)(q0 + r0 + i) * pos.q_ss]
                            : 0;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = rt::NEG_INF, l[i] = 0.f;
  const float scale2 = scale * LOG2E;

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    if (t + 1 < t_end) load_kv(t + 1, stage ^ 1);
    rt::cp_async_commit();
    rt::cp_async_wait<1>();
    __syncthreads();
    const float* ks = kv0 + stage * (2 * BN * RP + BN);
    const float* vs = ks + BN * RP;
    const int* kp = reinterpret_cast<const int*>(ks + 2 * BN * RP);
    const int key0 = t * BN;

    float s[4][NJ];
    gemm_nt<D>(s, qt, ks, r0, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = rt::NEG_INF;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = tx + TX * j;
        const bool ok = key0 + n < S && visible(qp[i], kp[n], window);
        s[i][j] = ok ? s[i][j] * scale2 : rt::NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < TX; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(rt::FULL, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = ex2(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[i][j] = ex2(s[i][j] - m_new);
        l[i] += s[i][j];
      }
    }
    store_t<D>(pt, s, r0, tx);
    __syncthreads();
    gemm_tn<D>(acc, pt, vs, r0, tx);
    __syncthreads();  // this stage and P^T are consumed before reuse
  }

  float* lb = lse + ((long long)b * H + h) * S;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < TX; off <<= 1)
      l[i] += __shfl_xor_sync(rt::FULL, l[i], off);
    if (tx == 0 && q0 + r0 + i < S)
      lb[q0 + r0 + i] = (m[i] + __log2f(fmaxf(l[i], 1e-30f))) * LN2;
    l[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] *= l[i];
  store_rows<D>(o + b * ost.b + h * ost.h + (long long)q0 * ost.s, ost.s, acc,
                r0, S - q0, tx, 1.f);
}

// ---------------------------------------------------------------------------
// dQ (and Delta): one block per (64 queries, head, batch)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(2 * D, D == 64 ? 2 : 1)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ o,
          const float* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ delta, float* __restrict__ dq, PosArgs pos,
          int H, int KV, int S, rt::Strides qst, rt::Strides kst,
          rt::Strides vst, rt::Strides ost, rt::Strides dost,
          rt::Strides dqst, float scale, int window) {
  constexpr int TX = tcols<D>(), NJ = BN / TX, RP = rpitch<D>();
  extern __shared__ float4 smem4[];
  float* const qt = reinterpret_cast<float*>(smem4);  // [D][TP]
  float* const dot = qt + D * TP;                     // [D][TP]
  float* const dst = dot + D * TP;                    // dS^T [BN][TP]
  float* const ks = dst + BN * TP;                    // [BN][RP]
  float* const vs = ks + BN * RP;                     // [BN][RP]
  int* const kp = reinterpret_cast<int*>(vs + BN * RP);
  float* const dl = vs + BN * RP + BN;  // Delta of the block's rows

  const int h = blockIdx.x, b = blockIdx.z;
  const int n_qt = (S + BM - 1) / BM;
  const int q0 = (n_qt - 1 - blockIdx.y) * BM;
  const int kvh = h / (H / KV);
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX, r0 = ty * 4;
  const int nq = min(BM, S - q0);

  const float* qb = q + b * qst.b + h * qst.h + (long long)q0 * qst.s;
  const float* dob = dout + b * dost.b + h * dost.h + (long long)q0 * dost.s;
  load_transposed<D>(qt, qb, qst.s, nq);
  load_transposed<D>(dot, dob, dost.s, nq);

  // Delta = rowsum(dO * O): D / 32 lanes a row, 8 float4 each
  {
    constexpr int TPR = D / 32;
    const int r = threadIdx.x / TPR, part = threadIdx.x % TPR;
    float sum = 0.f;
    if (r < nq) {
      const float* orow =
          o + b * ost.b + h * ost.h + (long long)(q0 + r) * ost.s;
      const float* drow = dob + (long long)r * dost.s;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = (part * 8 + c) * 4;
        const float4 x = ld4(orow + col), y = ld4(drow + col);
        sum += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
      }
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      sum += __shfl_xor_sync(rt::FULL, sum, off);
    if (part == 0) {
      dl[r] = sum;
      if (r < nq) delta[((long long)b * H + h) * S + q0 + r] = sum;
    }
  }

  int qp[4];
  float lse2[4];
  const long long* qpb = pos.q + b * pos.q_sb;
  const float* lb = lse + ((long long)b * H + h) * S;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool ok = q0 + r0 + i < S;
    qp[i] = ok ? (int)qpb[(long long)(q0 + r0 + i) * pos.q_ss] : 0;
    lse2[i] = ok ? lb[q0 + r0 + i] * LOG2E : 0.f;
  }

  const int k_end = min(q0 + BM, S);
  const int t_begin = window ? max(0, q0 - window + 1) / BN : 0;
  const int t_end = (k_end + BN - 1) / BN;
  const float* kb = k + b * kst.b + kvh * kst.h;
  const float* vb = v + b * vst.b + kvh * vst.h;
  const long long* kpb = pos.k + b * pos.k_sb;
  const float scale2 = scale * LOG2E;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

  __syncthreads();  // Delta
  float dlt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) dlt[i] = dl[r0 + i];

  for (int t = t_begin; t < t_end; ++t) {
    const int key0 = t * BN;
    const int n = min(BN, S - key0);
    load_rows<D>(ks, kb + (long long)key0 * kst.s, kst.s, n);
    load_rows<D>(vs, vb + (long long)key0 * vst.s, vst.s, n);
    rt::cp_async_commit();
    for (int i = threadIdx.x; i < BN; i += nthreads<D>())
      kp[i] = i < n ? (int)kpb[(long long)(key0 + i) * pos.k_ss] : -1;
    rt::cp_async_wait<0>();
    __syncthreads();

    float s[4][NJ], dp[4][NJ];
    gemm_nt<D>(s, qt, ks, r0, tx);
    gemm_nt<D>(dp, dot, vs, r0, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + TX * j;
        const bool ok = key0 + c < S && visible(qp[i], kp[c], window);
        const float p = ok ? ex2(fmaf(s[i][j], scale2, -lse2[i])) : 0.f;
        s[i][j] = p * (dp[i][j] - dlt[i]);
      }
    store_t<D>(dst, s, r0, tx);
    __syncthreads();
    gemm_tn<D>(acc, dst, ks, r0, tx);
    __syncthreads();
  }
  store_rows<D>(dq + b * dqst.b + h * dqst.h + (long long)q0 * dqst.s, dqst.s,
                acc, r0, nq, tx, scale);
}

// ---------------------------------------------------------------------------
// dK and dV: one block per (64 keys, kv head, batch)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(2 * D, D == 64 ? 2 : 1)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, PosArgs pos,
            int H, int KV, int S, rt::Strides qst, rt::Strides kst,
            rt::Strides vst, rt::Strides dost, rt::Strides dkst,
            rt::Strides dvst, float scale, int window) {
  constexpr int TX = tcols<D>(), NJ = BN / TX, RP = rpitch<D>();
  extern __shared__ float4 smem4[];
  float* const kt = reinterpret_cast<float*>(smem4);  // [D][TP]
  float* const vt = kt + D * TP;                      // [D][TP]
  float* const ps = vt + D * TP;                      // P [BN][TP]
  float* const dss = ps + BN * TP;                    // dS [BN][TP]
  float* const qs = dss + BN * TP;                    // [BN][RP]
  float* const dos = qs + BN * RP;                    // [BN][RP]
  int* const qps = reinterpret_cast<int*>(dos + BN * RP);
  float* const lse2s = dos + BN * RP + BN;
  float* const dls = lse2s + BN;

  const int kvh = blockIdx.x, b = blockIdx.z;
  const int k0 = blockIdx.y * BM;  // the earliest keys see the most rows
  const int G = H / KV;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX, r0 = ty * 4;
  const int nk = min(BM, S - k0);

  load_transposed<D>(kt, k + b * kst.b + kvh * kst.h + (long long)k0 * kst.s,
                     kst.s, nk);
  load_transposed<D>(vt, v + b * vst.b + kvh * vst.h + (long long)k0 * vst.s,
                     vst.s, nk);
  int kp[4];
  const long long* kpb = pos.k + b * pos.k_sb;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    kp[i] = k0 + r0 + i < S ? (int)kpb[(long long)(k0 + r0 + i) * pos.k_ss]
                            : -1;

  // query tiles [qt_begin, qt_end) see these keys
  const int n_qt = (S + BN - 1) / BN;
  const int qt_begin = k0 / BN;
  const int qt_end =
      window ? min(n_qt, (k0 + BM - 1 + window - 1) / BN + 1) : n_qt;
  const long long* qpb = pos.q + b * pos.q_sb;
  const float scale2 = scale * LOG2E;

  float ak[4][8], av[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) ak[i][c] = 0.f, av[i][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float* qb = q + b * qst.b + h * qst.h;
    const float* dob = dout + b * dost.b + h * dost.h;
    const float* lb = lse + ((long long)b * H + h) * S;
    const float* db = delta + ((long long)b * H + h) * S;
    for (int t = qt_begin; t < qt_end; ++t) {
      const int row0 = t * BN;
      const int n = min(BN, S - row0);
      load_rows<D>(qs, qb + (long long)row0 * qst.s, qst.s, n);
      load_rows<D>(dos, dob + (long long)row0 * dost.s, dost.s, n);
      rt::cp_async_commit();
      for (int i = threadIdx.x; i < BN; i += nthreads<D>()) {
        const bool ok = i < n;
        qps[i] = ok ? (int)qpb[(long long)(row0 + i) * pos.q_ss] : 0;
        lse2s[i] = ok ? lb[row0 + i] * LOG2E : 0.f;
        dls[i] = ok ? db[row0 + i] : 0.f;
      }
      rt::cp_async_wait<0>();
      __syncthreads();

      float s[4][NJ], dp[4][NJ];
      gemm_nt<D>(s, kt, qs, r0, tx);   // S^T: keys x queries
      gemm_nt<D>(dp, vt, dos, r0, tx); // dP^T
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + TX * j;
        const float l2 = lse2s[c], dl = dls[c];
        const int qpc = qps[c];
        const bool row_ok = row0 + c < S;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok = row_ok && k0 + r0 + i < S &&
                          visible(qpc, kp[i], window);
          const float p = ok ? ex2(fmaf(s[i][j], scale2, -l2)) : 0.f;
          s[i][j] = p;
          dp[i][j] = p * (dp[i][j] - dl);
        }
      }
      store_t<D>(ps, s, r0, tx);    // P [query][key]
      store_t<D>(dss, dp, r0, tx);  // dS [query][key]
      __syncthreads();
      gemm_tn<D>(av, ps, dos, r0, tx);   // dV += P^T dO
      gemm_tn<D>(ak, dss, qs, r0, tx);   // dK += dS^T Q
      __syncthreads();
    }
  }
  store_rows<D>(dk + b * dkst.b + kvh * dkst.h + (long long)k0 * dkst.s,
                dkst.s, ak, r0, nk, tx, scale);
  store_rows<D>(dv + b * dvst.b + kvh * dvst.h + (long long)k0 * dvst.s,
                dvst.s, av, r0, nk, tx, 1.f);
}

template <typename K>
cudaError_t opt_in(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// Plain C entries, loaded with ctypes.  Tensor strides are in elements,
// (batch, head, sequence) of a (B, H, S, D) view whose last dim is
// contiguous; positions are int64 (B, S) with strides (batch, sequence);
// LSE and Delta are contiguous (B, H, S).  Each returns the CUDA error
// code (0 = ok); a D other than 64 or 128 is cudaErrorInvalidValue.
extern "C" int flash_train_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* q_pos, const void* k_pos, int B, int H, int KV, int S, int D,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    long long qp_sb, long long qp_ss, long long kp_sb, long long kp_ss,
    float scale, int window, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const rt::Strides qst{q_sb, q_sh, q_ss}, kst{k_sb, k_sh, k_ss},
      vst{v_sb, v_sh, v_ss}, ost{o_sb, o_sh, o_ss};
  const PosArgs pos{static_cast<const long long*>(q_pos),
                    static_cast<const long long*>(k_pos), qp_sb, qp_ss,
                    kp_sb, kp_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(H, (S + BM - 1) / BM, B);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  if (D == 64) {
    if ((err = opt_in(fwd_kernel<64>, fwd_bytes<64>())) != cudaSuccess)
      return (int)err;
    fwd_kernel<64><<<grid, nthreads<64>(), fwd_bytes<64>(), s>>>(
        qf, kf, vf, of, lf, pos, H, KV, S, qst, kst, vst, ost, scale, window);
  } else if (D == 128) {
    if ((err = opt_in(fwd_kernel<128>, fwd_bytes<128>())) != cudaSuccess)
      return (int)err;
    fwd_kernel<128><<<grid, nthreads<128>(), fwd_bytes<128>(), s>>>(
        qf, kf, vf, of, lf, pos, H, KV, S, qst, kst, vst, ost, scale, window);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int flash_train_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq,
    const void* q_pos, const void* k_pos, int B, int H, int KV, int S, int D,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    long long do_sb, long long do_sh, long long do_ss, long long dq_sb,
    long long dq_sh, long long dq_ss, long long qp_sb, long long qp_ss,
    long long kp_sb, long long kp_ss, float scale, int window, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const rt::Strides qst{q_sb, q_sh, q_ss}, kst{k_sb, k_sh, k_ss},
      vst{v_sb, v_sh, v_ss}, ost{o_sb, o_sh, o_ss},
      dost{do_sb, do_sh, do_ss}, dqst{dq_sb, dq_sh, dq_ss};
  const PosArgs pos{static_cast<const long long*>(q_pos),
                    static_cast<const long long*>(k_pos), qp_sb, qp_ss,
                    kp_sb, kp_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(H, (S + BM - 1) / BM, B);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(o);
  const float* df = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  float* dlt = static_cast<float*>(delta);
  float* dqf = static_cast<float*>(dq);
  if (D == 64) {
    if ((err = opt_in(dq_kernel<64>, dq_bytes<64>())) != cudaSuccess)
      return (int)err;
    dq_kernel<64><<<grid, nthreads<64>(), dq_bytes<64>(), s>>>(
        qf, kf, vf, of, df, lf, dlt, dqf, pos, H, KV, S, qst, kst, vst, ost,
        dost, dqst, scale, window);
  } else if (D == 128) {
    if ((err = opt_in(dq_kernel<128>, dq_bytes<128>())) != cudaSuccess)
      return (int)err;
    dq_kernel<128><<<grid, nthreads<128>(), dq_bytes<128>(), s>>>(
        qf, kf, vf, of, df, lf, dlt, dqf, pos, H, KV, S, qst, kst, vst, ost,
        dost, dqst, scale, window);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int flash_train_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const void* q_pos, const void* k_pos, int B, int H, int KV, int S, int D,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long do_sb, long long do_sh, long long do_ss,
    long long dk_sb, long long dk_sh, long long dk_ss, long long dv_sb,
    long long dv_sh, long long dv_ss, long long qp_sb, long long qp_ss,
    long long kp_sb, long long kp_ss, float scale, int window, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const rt::Strides qst{q_sb, q_sh, q_ss}, kst{k_sb, k_sh, k_ss},
      vst{v_sb, v_sh, v_ss}, dost{do_sb, do_sh, do_ss},
      dkst{dk_sb, dk_sh, dk_ss}, dvst{dv_sb, dv_sh, dv_ss};
  const PosArgs pos{static_cast<const long long*>(q_pos),
                    static_cast<const long long*>(k_pos), qp_sb, qp_ss,
                    kp_sb, kp_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(KV, (S + BM - 1) / BM, B);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* df = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* dlt = static_cast<const float*>(delta);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  if (D == 64) {
    if ((err = opt_in(dkdv_kernel<64>, dkdv_bytes<64>())) != cudaSuccess)
      return (int)err;
    dkdv_kernel<64><<<grid, nthreads<64>(), dkdv_bytes<64>(), s>>>(
        qf, kf, vf, df, lf, dlt, dkf, dvf, pos, H, KV, S, qst, kst, vst, dost,
        dkst, dvst, scale, window);
  } else if (D == 128) {
    if ((err = opt_in(dkdv_kernel<128>, dkdv_bytes<128>())) != cudaSuccess)
      return (int)err;
    dkdv_kernel<128><<<grid, nthreads<128>(), dkdv_bytes<128>(), s>>>(
        qf, kf, vf, df, lf, dlt, dkf, dvf, pos, H, KV, S, qst, kst, vst, dost,
        dkst, dvst, scale, window);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The contract query of each kernel (rt::query_kernel): what the runtime
// reports at the launch's threads and dynamic shared memory.  kind 0 is
// fwd_kernel, 1 dq_kernel, 2 dkdv_kernel.  Launches nothing.  Returns the
// CUDA error code; an uninstantiated D or kind is cudaErrorInvalidValue.
extern "C" int flash_train_query(int kind, int D, int device,
                                 long long* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (D == 64 && kind == 0)
    err = rt::query_kernel(fwd_kernel<64>, nthreads<64>(), fwd_bytes<64>(),
                           true, out);
  else if (D == 128 && kind == 0)
    err = rt::query_kernel(fwd_kernel<128>, nthreads<128>(),
                           fwd_bytes<128>(), true, out);
  else if (D == 64 && kind == 1)
    err = rt::query_kernel(dq_kernel<64>, nthreads<64>(), dq_bytes<64>(),
                           true, out);
  else if (D == 128 && kind == 1)
    err = rt::query_kernel(dq_kernel<128>, nthreads<128>(), dq_bytes<128>(),
                           true, out);
  else if (D == 64 && kind == 2)
    err = rt::query_kernel(dkdv_kernel<64>, nthreads<64>(), dkdv_bytes<64>(),
                           true, out);
  else if (D == 128 && kind == 2)
    err = rt::query_kernel(dkdv_kernel<128>, nthreads<128>(),
                           dkdv_bytes<128>(), true, out);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
