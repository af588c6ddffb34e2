// Mamba-2 SSD chunked scan for Hopper (sm_90a) on the tensor cores: bf16
// in, y in bf16, the chunk states and the final state in fp32.
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan (the Pallas TPU kernel,
// body _kernel).  Same function: x (B,H,L,P), dt (B,H,L), a (H,), b/c
// (B,L,N) shared across heads.  Per chunk of Q steps, with cl the
// inclusive cumsum of dt * a over the chunk and h the (N,P) state carried
// from the previous chunk:
//   y_i = sum_{j<=i} (C_i . B_j) exp(cl_i - cl_j) dt_j x_j + exp(cl_i) C_i h
//   h'  = exp(cl_{Q-1}) h + sum_j B_j^T exp(cl_{Q-1} - cl_j) dt_j x_j
// The causal mask is applied before the exp (the Pallas body takes exp
// first and masks after, which is inf above the diagonal).
//
// Bound on the H100: at mamba2-780m width (B = 1, L = 2048, H = 48, P = 64,
// N = 128, Q = 256) the bytes are ~28 MB (x and y in bf16, B, C, dt, the
// fp32 final state), ~8.4 us at 3.35 TB/s; the operations ~4.9 GFLOP (C B^T
// once per chunk; per head the masked Q x Q product with x, C h and the
// state update), ~5 us at the bf16 tensor-core rate: the bytes bound it.
//
// Design.  Only the (N,P) state recurrence across chunks is sequential, so
// the scan is the chunked SSD algorithm (Dao & Gu 2024, section 6) in
// three passes, launched in order on the caller's stream by one C call
// (bytes at full width, fp32 scratch included):
//   1. chunk pass, grid (B * chunks, head groups of G1), 8 warps: per head
//      the chunk's own state S_c = (B^T o s) x, s_j = exp(cl_last - cl_j)
//      dt_j, to an fp32 scratch (B, chunks, H, N, P), and cl, the cumsum
//      of dt a, to (B, chunks, H, Q).  Reads x, B, dt (12.6 MB), writes
//      S_c (12.6 MB).  One warp scans each head's cl up front; x comes
//      through a two-slot cp.async ring, the next head's in flight while
//      this one computes.
//   2. state pass, grid (B * H * N * P / 4 / 256): h <- h exp(cl_last) +
//      S_c over the chunks in order, in fp32 registers, four state values
//      a thread; each chunk's starting state overwrites its S_c in place,
//      the final state goes to h_out.  Reads and writes 12.6 MB.
//   3. output pass, grid (B * chunks * R, head groups of G3), 8 warps:
//      y = (C B^T o L o dt) x + exp(cl_i) C h_start.  The chunk's 16-row
//      strips are paired (p, T - 1 - p), T + 1 tiles of C B^T a pair; row
//      block rb of R = 2 takes every other pair, computes its pairs' C B^T
//      tiles once and keeps them (68 KB at Q = 256) for every head of its
//      group.  Per head, two warps share a pair: one takes strip p and the
//      diagonal end of strip q, the other the rest of q and q's C h term,
//      handed over through shared memory.  Reads x, C, B, dt, cl and the
//      starting states (12.6 + 12.6 MB), writes y (12.6 MB).
// With one chunk (L <= chunk) the starting state is 0: pass 1 writes S_c
// straight to h_out, pass 2 is not launched and pass 3 skips C h.  The
// wrapper picks G1, G3 and R so that each pass is one wave of blocks on
// the SMs (G1 = 3, G3 = 6, R = 2 at full width: 128 blocks each); a last
// group may hold fewer heads.
//
// Every product runs on mma.sync m16n8k16 (bf16 operands, fp32
// accumulate), from shared memory through ldmatrix, with rows stored in
// 16-byte chunks swizzled by the row (chunk c of row r at c ^ (r % 8)).
// bf16 operands alone miss the tolerances (y 3e-2 + 3e-2 |y| where y
// cancels to ~0, the state 1e-3): a product whose operand is an fp32 value
// takes it as a bf16 high and a bf16 low part, two products (the pair
// carries ~16 bits of mantissa), into separate accumulators:
//   C B^T       C and B are bf16 inputs: exact; kept as high and low parts;
//   W x         W = C B^T o exp(cl_i - cl_j) dt_j, built in fp32, high and
//               low; left of the diagonal exp(cl_i - cl_j) = r_i q_j with
//               r_i = exp(cl_i - cl_i0), q_j = exp(cl_i0 - cl_j) (i0 the
//               strip's first row; both <= 1), r_i applied once per strip;
//               on the diagonal tile masked (j > i) before the exp;
//   C h         h_start (fp32) high and low;
//   (B^T o s) x B^T o s (fp32) high and low, as the A operand.
// cl and the recurrence stay in fp32.  Ragged chunks (Q not a multiple of
// 16, Q = L < chunk) are zero-filled to Qp = 16 ceil(Q / 16) rows: dt = 0
// and zero rows there add nothing, and rows >= Q are never written.  No
// atomics: two calls on the same inputs give the same bits.
#include "attention_tile.cuh"

namespace {

using rt::cp_async16;
using rt::mma_bf16;
using rt::pack_bf16;
using rt::smem_u32;

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int QMAX = 256;
constexpr int MAX_GROUP = NWARPS;  // heads per block of pass 1
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* dt;
  const float* a;
  const __nv_bfloat16* b;
  const __nv_bfloat16* c;
  __nv_bfloat16* y;
  float* h_out;
  float* state;  // (B, nc, H, N, P): S_c after pass 1, h_start after pass 2
  float* cls;    // (B, nc, H, Q): cl
  int H, L, Q, G1, G3, R, nc;  // heads per block of passes 1 and 3
  long long x_sb, x_sh, x_sl;
  long long dt_sb, dt_sh, dt_sl;
  long long b_sb, b_sl, c_sb, c_sl;
  long long y_sb, y_sh, y_sl;
};

// Element offset of (row r, column col) in a tile of W bf16 columns whose
// 16-byte chunks are swizzled by the row.
template <int W>
__device__ __forceinline__ int swz(int r, int col) {
  constexpr int CH = W / 8;
  constexpr int MASK = (CH < 8 ? CH : 8) - 1;
  return r * W + ((((col >> 3) ^ (r & MASK))) << 3) + (col & 7);
}

// Qp rows of W bf16 (row r at src + r * row_stride) into a swizzled tile;
// rows >= n_valid are zero-filled (n_valid >= 1: row 0 is a valid address).
template <int W>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int rows,
                                          int n_valid) {
  constexpr int CH = W / 8;
  for (int i = threadIdx.x; i < rows * CH; i += NTHREADS) {
    const int r = i / CH, ch = i % CH;
    const bool ok = r < n_valid;
    cp_async16(smem_u32(dst + swz<W>(r, ch * 8)),
               ok ? src + r * row_stride + ch * 8 : src, ok ? 16 : 0);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The fragment loads, for a warp, lane l, q = l / 8.  Tiles are swizzled
// row-major with W columns.
// A (16 x 16) at rows m0, columns k0 of a tile stored [m][k]
template <int W>
__device__ __forceinline__ void frag_a(uint32_t (&r)[4],
                                       const __nv_bfloat16* t, int m0,
                                       int k0) {
  const int l = threadIdx.x & 31, q = l >> 3;
  ldsm_x4(r, t + swz<W>(m0 + (l & 7) + 8 * (q & 1), k0 + 8 * (q >> 1)));
}
// A (16 x 16) at rows m0, columns k0 of the transpose of a tile stored [k][m]
template <int W>
__device__ __forceinline__ void frag_a_t(uint32_t (&r)[4],
                                         const __nv_bfloat16* t, int m0,
                                         int k0) {
  const int l = threadIdx.x & 31, q = l >> 3;
  ldsm_x4_t(r, t + swz<W>(k0 + (l & 7) + 8 * (q >> 1), m0 + 8 * (q & 1)));
}
// B of two n-tiles (n0 .. n0 + 15) at k0 .. k0 + 15 of a tile stored
// [n][k]: r[0], r[1] for n-tile 0, r[2], r[3] for n-tile 1
template <int W>
__device__ __forceinline__ void frag_b(uint32_t (&r)[4],
                                       const __nv_bfloat16* t, int k0,
                                       int n0) {
  const int l = threadIdx.x & 31, q = l >> 3;
  ldsm_x4(r, t + swz<W>(n0 + (l & 7) + 8 * (q >> 1), k0 + 8 * (q & 1)));
}
// the same from a tile stored [k][n]
template <int W>
__device__ __forceinline__ void frag_b_t(uint32_t (&r)[4],
                                         const __nv_bfloat16* t, int k0,
                                         int n0) {
  const int l = threadIdx.x & 31, q = l >> 3;
  ldsm_x4_t(r, t + swz<W>(k0 + (l & 7) + 8 * (q & 1), n0 + 8 * (q >> 1)));
}

// dt of step threadIdx.x of the chunk (0 past Q), loaded a head ahead of
// its use so that its latency hides behind the current head's work
static_assert(QMAX <= NTHREADS && MAX_GROUP * QMAX % NTHREADS == 0,
              "one step of the chunk per thread");
__device__ __forceinline__ float load_dt(const __nv_bfloat16* dt,
                                         long long dt_sl, int Q) {
  return threadIdx.x < Q ? __bfloat162float(dt[threadIdx.x * dt_sl]) : 0.f;
}

// cl of step threadIdx.x of the chunk (cl[Q - 1] past Q), as pass 1
// wrote it; loaded a head ahead, as dt is
__device__ __forceinline__ float load_cl(const float* cl, int Q) {
  return cl[min((int)threadIdx.x, Q - 1)];
}

__host__ __device__ constexpr int padded(int Q) { return (Q + 15) & ~15; }

// bf16 high and low parts of a pair of fp32 values: hi + lo carries ~16
// bits of mantissa
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 hb = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(hb);
  hi = *reinterpret_cast<const uint32_t*>(&hb);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}
__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Pass 1: shared memory for B, the x ring, and s for the block's heads.
__host__ __device__ constexpr size_t chunk_smem(int Qp, int P, int N) {
  return (size_t)Qp * N * 2 + (size_t)2 * Qp * P * 2 +
         (size_t)MAX_GROUP * Qp * 4;
}

template <int P, int N>
__global__ void __launch_bounds__(NTHREADS) chunk_pass(Args g) {
  const int Q = g.Q, Qp = padded(Q);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // Qp x N
  __nv_bfloat16* xr = bs + Qp * N;  // two slots of Qp x P
  float* sv = reinterpret_cast<float*>(xr + 2 * Qp * P);  // [head][Qp]

  const int b = blockIdx.x / g.nc, ci = blockIdx.x % g.nc, c0 = ci * Q;
  const int h0 = blockIdx.y * g.G1, h1 = min(h0 + g.G1, g.H);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const __nv_bfloat16* xb = g.x + b * g.x_sb + (long long)c0 * g.x_sl;

  load_rows<N>(bs, g.b + b * g.b_sb + (long long)c0 * g.b_sl, g.b_sl, Qp, Q);
  load_rows<P>(xr, xb + h0 * g.x_sh, g.x_sl, Qp, Q);
  rt::cp_async_commit();

  // dt of every head of the block, all loads in flight together
  const int nh = h1 - h0;
#pragma unroll
  for (int k = 0; k < MAX_GROUP * QMAX / NTHREADS; ++k) {
    const int i = threadIdx.x + k * NTHREADS, hh = i / Qp, j = i % Qp;
    if (hh < nh)
      sv[i] = j < Q ? __bfloat162float(
                          g.dt[b * g.dt_sb + (h0 + hh) * g.dt_sh +
                               (long long)(c0 + j) * g.dt_sl])
                    : 0.f;
  }
  __syncthreads();
  // cl of every head at once, warp w taking head h0 + w: to the scratch
  // (for passes 2 and 3), and s_j = exp(cl_last - cl_j) dt_j in place of dt
  if (warp < nh) {
    const int h = h0 + warp;
    float* s = sv + warp * Qp;
    float* cl = g.cls + (((long long)b * g.nc + ci) * g.H + h) * Q;
    const float a = g.a[h];
    const int per = (Q + 31) / 32;
    const int lo = min(lane * per, Q), hi = min(lo + per, Q);
    float run = 0.f;
    for (int j = lo; j < hi; ++j) run = fmaf(s[j], a, run);
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += t;
    }
    run = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) run = 0.f;
    for (int j = lo; j < hi; ++j) {
      run = fmaf(s[j], a, run);
      cl[j] = run;
    }
    const float last = __shfl_sync(FULL, run, (Q - 1) / per);
    for (int j = lo; j < hi; ++j) s[j] = expf(last - cl[j]) * s[j];
  }

  for (int h = h0; h < h1; ++h) {
    const int slot = (h - h0) & 1;
    __syncthreads();  // the previous head is done with its x slot; s is set
    if (h + 1 < h1)
      load_rows<P>(xr + (slot ^ 1) * Qp * P, xb + (h + 1) * g.x_sh, g.x_sl,
                   Qp, Q);
    rt::cp_async_commit();
    rt::cp_async_wait<1>();  // this head's x (and B) have landed
    __syncthreads();

    // S_c (N x P) = (B^T o s) x: warp w takes state rows 16 w ...; the A
    // operand B^T o s is an fp32 product, taken as its bf16 high and low
    // parts (separate accumulators, so the two products do not wait on
    // each other); x is bf16, exact
    const __nv_bfloat16* xs = xr + slot * Qp * P;
    const float* s = sv + (h - h0) * Qp;
    float* out = g.state + (((long long)b * g.nc + ci) * g.H + h) * N * P;
    for (int m0 = warp * 16; m0 < N; m0 += NWARPS * 16) {
      float acc[P / 8][4], acc2[P / 8][4];
#pragma unroll
      for (int n = 0; n < P / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][i] = acc2[n][i] = 0.f;
      for (int k0 = 0; k0 < Qp; k0 += 16) {
        uint32_t af[4], ahi[4], alo[4];
        frag_a_t<N>(af, bs, m0, k0);
        const float2 s0 = *reinterpret_cast<const float2*>(s + k0 + 2 * tq);
        const float2 s1 = *reinterpret_cast<const float2*>(s + k0 + 8 + 2 * tq);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 v = unpack2(af[r]), sc = r < 2 ? s0 : s1;
          split2(v.x * sc.x, v.y * sc.y, ahi[r], alo[r]);
        }
#pragma unroll
        for (int n2 = 0; n2 < P / 16; ++n2) {
          uint32_t bf[4];
          frag_b_t<P>(bf, xs, k0, 16 * n2);
          mma_bf16(acc[2 * n2], ahi, bf[0], bf[1]);
          mma_bf16(acc[2 * n2 + 1], ahi, bf[2], bf[3]);
          mma_bf16(acc2[2 * n2], alo, bf[0], bf[1]);
          mma_bf16(acc2[2 * n2 + 1], alo, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < P / 8; ++n) {
        const int col = 8 * n + 2 * tq;
        *reinterpret_cast<float2*>(out + (m0 + gq) * P + col) =
            make_float2(acc[n][0] + acc2[n][0], acc[n][1] + acc2[n][1]);
        *reinterpret_cast<float2*>(out + (m0 + gq + 8) * P + col) =
            make_float2(acc[n][2] + acc2[n][2], acc[n][3] + acc2[n][3]);
      }
    }
  }
}

// Pass 2: the recurrence over the chunks, four state values a thread.
__global__ void __launch_bounds__(256) state_pass(float* state,
                                                  const float* cls,
                                                  float* h_out, int B, int H,
                                                  int nc, int Q, int np4) {
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  if (idx >= (long long)B * H * np4) return;
  const int bh = (int)(idx / np4), e = (int)(idx % np4);
  const int b = bh / H, h = bh % H;
  float4* st = reinterpret_cast<float4*>(state);
  float4 hv = make_float4(0.f, 0.f, 0.f, 0.f);
  long long off = ((long long)b * nc * H + h) * np4 + e;
  float4 s = st[off];
  for (int ci = 0; ci < nc; ++ci) {
    const long long next = off + (long long)H * np4;
    const float4 s_next = ci + 1 < nc ? st[next] : s;
    st[off] = hv;  // the chunk's starting state
    const float d = expf(cls[(((long long)b * nc + ci) * H + h) * Q + Q - 1]);
    hv.x = fmaf(hv.x, d, s.x);
    hv.y = fmaf(hv.y, d, s.y);
    hv.z = fmaf(hv.z, d, s.z);
    hv.w = fmaf(hv.w, d, s.w);
    s = s_next;
    off = next;
  }
  reinterpret_cast<float4*>(h_out)[(long long)bh * np4 + e] = hv;
}

// Pass 3's strips.  The Qp rows are T = Qp / 16 strips of 16; strip s
// needs s + 1 tiles of C B^T, so strips are paired (p, T - 1 - p), T + 1
// tiles a pair (the middle strip of an odd T is a pair alone).  Row block
// rb of R takes the pairs p = lp R + rb, lp = 0, 1, ...: R = 2 halves the
// C B^T a block keeps, at the same work per block.
__host__ __device__ constexpr int pairs_max(int Qp, int R) {
  return ((Qp / 16 + 1) / 2 + R - 1) / R;
}
// Shared memory: the block's C B^T tiles (high and low fragments, 1 KB a
// tile), C of its strips, a region for x slot 0 then B (later x slot 1 and
// the starting state's high and low parts: the first head's x is in flight
// while C B^T is made), cl and dt, and the partial sums handed between
// warps.
__host__ __device__ constexpr size_t region_elems(int Qp, int P, int N) {
  return Qp * P + Qp * N > 2 * Qp * P + 2 * N * P
             ? (size_t)Qp * P + Qp * N
             : (size_t)2 * Qp * P + 2 * N * P;
}
__host__ __device__ constexpr size_t output_smem(int Qp, int P, int N, int R) {
  return (size_t)pairs_max(Qp, R) * (Qp / 16 + 1) * 1024 +
         (size_t)2 * pairs_max(Qp, R) * 16 * N * 2 +
         region_elems(Qp, P, N) * 2 + (size_t)2 * Qp * 4 +
         (size_t)pairs_max(Qp, R) * 16 * P * 4;
}

// One warp's share of the 16-row strip s of y, all P columns, in acc:
//   acc = r_i (e0 [C_i h] + sum_{tj0 <= tj < tj1} (C B^T o q) x) [+ diag]
// with i0 = 16 s, e0 = exp(cl_i0), r_i = exp(cl_i - cl_i0) and, for the
// tiles left of the diagonal (j < i0 <= i), q_j = exp(cl_i0 - cl_j) dt_j:
// exp(cl_i - cl_j) = r_i q_j / dt_j with both factors <= 1, so a tile's W
// costs 4 exps a thread, not 8.  The diagonal tile (j, i in the strip)
// takes exp(cl_i - cl_j) whole, masked before the exp.  W = C B^T o ...
// is built in fp32 from the tile's high and low fragments and taken as its
// own high and low parts; C h as h's high and low parts.
template <int P, int N>
__device__ __forceinline__ void strip_part(
    float (&acc)[P / 8][4], int s, int tj0, int tj1, bool inter, bool diag,
    const __nv_bfloat16* cst, const uint4* tiles, const __nv_bfloat16* xs,
    const __nv_bfloat16* h_hi, const __nv_bfloat16* h_lo, const float* cl,
    const float* dts) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int i0 = s * 16, ia = i0 + gq, ib = ia + 8;
  const float cl0 = cl[i0], cla = cl[ia], clb = cl[ib];
  float acc2[P / 8][4];  // the low parts' products: no wait on the high ones
#pragma unroll
  for (int n = 0; n < P / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = acc2[n][i] = 0.f;
  if (inter) {  // C_i h_start, then times e0
#pragma unroll
    for (int k0 = 0; k0 < N; k0 += 16) {
      uint32_t af[4];
      frag_a<N>(af, cst, 0, k0);
#pragma unroll
      for (int n2 = 0; n2 < P / 16; ++n2) {
        uint32_t bh[4], bl[4];
        frag_b_t<P>(bh, h_hi, k0, 16 * n2);
        frag_b_t<P>(bl, h_lo, k0, 16 * n2);
        mma_bf16(acc[2 * n2], af, bh[0], bh[1]);
        mma_bf16(acc[2 * n2 + 1], af, bh[2], bh[3]);
        mma_bf16(acc2[2 * n2], af, bl[0], bl[1]);
        mma_bf16(acc2[2 * n2 + 1], af, bl[2], bl[3]);
      }
    }
    const float e0 = __expf(cl0);
#pragma unroll
    for (int n = 0; n < P / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[n][i] *= e0;
        acc2[n][i] *= e0;
      }
  }
  for (int tj = tj0; tj < tj1; ++tj) {  // tiles left of the diagonal
    const uint4 fh = tiles[tj * 64 + lane], fl = tiles[tj * 64 + 32 + lane];
    const uint32_t ch[4] = {fh.x, fh.y, fh.z, fh.w};
    const uint32_t cw[4] = {fl.x, fl.y, fl.z, fl.w};
    const int j0 = tj * 16 + 2 * tq;
    float qv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = j0 + (k & 1) + 8 * (k >> 1);
      qv[k] = __expf(cl0 - cl[j]) * dts[j];
    }
    uint32_t whi[4], wlo[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 vh = unpack2(ch[r]), vl = unpack2(cw[r]);
      const int k = 2 * (r >> 1);
      split2((vh.x + vl.x) * qv[k], (vh.y + vl.y) * qv[k + 1], whi[r],
             wlo[r]);
    }
#pragma unroll
    for (int n2 = 0; n2 < P / 16; ++n2) {
      uint32_t bf[4];
      frag_b_t<P>(bf, xs, tj * 16, 16 * n2);
      mma_bf16(acc[2 * n2], whi, bf[0], bf[1]);
      mma_bf16(acc[2 * n2 + 1], whi, bf[2], bf[3]);
      mma_bf16(acc2[2 * n2], wlo, bf[0], bf[1]);
      mma_bf16(acc2[2 * n2 + 1], wlo, bf[2], bf[3]);
    }
  }
  const float ra = __expf(cla - cl0), rb = __expf(clb - cl0);
#pragma unroll
  for (int n = 0; n < P / 8; ++n) {
    acc[n][0] = (acc[n][0] + acc2[n][0]) * ra;
    acc[n][1] = (acc[n][1] + acc2[n][1]) * ra;
    acc[n][2] = (acc[n][2] + acc2[n][2]) * rb;
    acc[n][3] = (acc[n][3] + acc2[n][3]) * rb;
  }
  if (!diag) return;
  const uint4 fh = tiles[s * 64 + lane], fl = tiles[s * 64 + 32 + lane];
  const uint32_t ch[4] = {fh.x, fh.y, fh.z, fh.w};
  const uint32_t cw[4] = {fl.x, fl.y, fl.z, fl.w};
  const int j0 = i0 + 2 * tq;
  uint32_t whi[4], wlo[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = (r & 1) ? ib : ia;
    const float cli = (r & 1) ? clb : cla;
    const int j = j0 + 8 * (r >> 1);
    const float2 vh = unpack2(ch[r]), vl = unpack2(cw[r]);
    const float w0 =
        j <= i ? (vh.x + vl.x) * __expf(cli - cl[j]) * dts[j] : 0.f;
    const float w1 =
        j + 1 <= i ? (vh.y + vl.y) * __expf(cli - cl[j + 1]) * dts[j + 1]
                   : 0.f;
    split2(w0, w1, whi[r], wlo[r]);
  }
#pragma unroll
  for (int n2 = 0; n2 < P / 16; ++n2) {
    uint32_t bf[4];
    frag_b_t<P>(bf, xs, i0, 16 * n2);
    mma_bf16(acc[2 * n2], whi, bf[0], bf[1]);
    mma_bf16(acc[2 * n2 + 1], whi, bf[2], bf[3]);
    mma_bf16(acc[2 * n2], wlo, bf[0], bf[1]);
    mma_bf16(acc[2 * n2 + 1], wlo, bf[2], bf[3]);
  }
}

// rows i0 .. i0 + 15 of y (those < Q) from a strip's accumulators
template <int P>
__device__ __forceinline__ void store_y(const float (&acc)[P / 8][4],
                                        __nv_bfloat16* yb, int i0, int Q,
                                        long long y_sl) {
  const int lane = threadIdx.x & 31, ia = i0 + (lane >> 2), ib = ia + 8;
#pragma unroll
  for (int n = 0; n < P / 8; ++n) {
    const int col = 8 * n + 2 * (lane & 3);
    if (ia < Q)
      *reinterpret_cast<__nv_bfloat162*>(yb + ia * y_sl + col) =
          __floats2bfloat162_rn(acc[n][0], acc[n][1]);
    if (ib < Q)
      *reinterpret_cast<__nv_bfloat162*>(yb + ib * y_sl + col) =
          __floats2bfloat162_rn(acc[n][2], acc[n][3]);
  }
}

template <int P, int N>
__global__ void __launch_bounds__(NTHREADS) output_pass(Args g) {
  const int Q = g.Q, Qp = padded(Q), T = Qp / 16, R = g.R;
  const int npairs = (T + 1) / 2, PT = T + 1;  // tiles per pair
  const bool has_state = g.nc > 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* cbt = reinterpret_cast<uint4*>(smem_raw);  // [lp][t][hi, lo][lane]
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(
      cbt + pairs_max(Qp, R) * PT * 64);            // [2 lp + which][16][N]
  __nv_bfloat16* region = cs + 2 * pairs_max(Qp, R) * 16 * N;
  __nv_bfloat16* h_hi = region + 2 * Qp * P;        // N x P
  __nv_bfloat16* h_lo = h_hi + N * P;
  float* cl = reinterpret_cast<float*>(region + region_elems(Qp, P, N));
  float* dts = cl + Qp;
  float4* part = reinterpret_cast<float4*>(dts + Qp);  // [lp][P / 8][lane]

  const int rb = blockIdx.x % R, bc = blockIdx.x / R;
  const int b = bc / g.nc, ci = bc % g.nc, c0 = ci * Q;
  const int h0 = blockIdx.y * g.G3, h1 = min(h0 + g.G3, g.H);
  const int nlp = (npairs - rb + R - 1) / R;  // this block's pairs
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const __nv_bfloat16* xb = g.x + b * g.x_sb + (long long)c0 * g.x_sl;
  const __nv_bfloat16* cb0 = g.c + b * g.c_sb + (long long)c0 * g.c_sl;
  const __nv_bfloat16* dtb = g.dt + b * g.dt_sb + (long long)c0 * g.dt_sl;

  // the first head's dt and starting state, in flight while C B^T is made
  constexpr int HV = (N * P / 4 + NTHREADS - 1) / NTHREADS;
  float4 h_next[HV];
  const float4* st4 = reinterpret_cast<const float4*>(
      g.state + ((long long)b * g.nc + ci) * g.H * N * P);
  auto load_state = [&](int hh) {
#pragma unroll
    for (int k = 0; k < HV; ++k) {
      const int i = threadIdx.x + k * NTHREADS;
      if (i < N * P / 4) h_next[k] = st4[(long long)hh * (N * P / 4) + i];
    }
  };
  const float* clb = g.cls + ((long long)b * g.nc + ci) * g.H * Q;
  float dt_next = load_dt(dtb + h0 * g.dt_sh, g.dt_sl, Q);
  float cl_next = load_cl(clb + h0 * Q, Q);
  if (has_state) load_state(h0);

  for (int ls = 0; ls < 2 * nlp; ++ls) {  // C of the block's strips
    const int p = (ls >> 1) * R + rb, s = (ls & 1) ? T - 1 - p : p;
    if ((ls & 1) && s == p) continue;
    load_rows<N>(cs + ls * 16 * N, cb0 + (long long)s * 16 * g.c_sl, g.c_sl,
                 16, Q - s * 16);
  }
  __nv_bfloat16* bs = region + Qp * P;  // B, until C B^T is made
  load_rows<N>(bs, g.b + b * g.b_sb + (long long)c0 * g.b_sl, g.b_sl, Qp, Q);
  rt::cp_async_commit();
  load_rows<P>(region, xb + h0 * g.x_sh, g.x_sl, Qp, Q);
  rt::cp_async_commit();
  rt::cp_async_wait<1>();  // C and B have landed
  __syncthreads();

  // C B^T tiles of the block's strips, in fp32, kept as the high and low
  // A fragments of their 16 rows (i) and 16 columns (j): tile t of pair lp
  // is tile t of strip p (t <= p), else tile t - p - 1 of strip T - 1 - p
  for (int k = warp; k < nlp * PT; k += NWARPS) {
    const int lp = k / PT, t = k % PT, p = lp * R + rb;
    const int which = t > p, s = which ? T - 1 - p : p;
    if (which && s == p) continue;
    const int tj = which ? t - p - 1 : t;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int k0 = 0; k0 < N; k0 += 16) {
      uint32_t af[4], bf[4];
      frag_a<N>(af, cs + (2 * lp + which) * 16 * N, 0, k0);
      frag_b<N>(bf, bs, k0, tj * 16);
      mma_bf16(acc[0], af, bf[0], bf[1]);
      mma_bf16(acc[1], af, bf[2], bf[3]);
    }
    uint32_t hi[4], lo[4];
    split2(acc[0][0], acc[0][1], hi[0], lo[0]);
    split2(acc[0][2], acc[0][3], hi[1], lo[1]);
    split2(acc[1][0], acc[1][1], hi[2], lo[2]);
    split2(acc[1][2], acc[1][3], hi[3], lo[3]);
    cbt[k * 64 + lane] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    cbt[k * 64 + 32 + lane] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }

  // warps 2 lp and 2 lp + 1 share pair lp (strips p and q = T - 1 - p):
  // warp 2 lp + 1 takes strip p whole and the last tiles of strip q, warp
  // 2 lp the first (T + 1) / 2 tiles of q and its C h term, which it hands
  // over in shared memory; a pair that is one strip is split the same way
  const int lp = warp >> 1, role = warp & 1;
  for (int h = h0; h < h1; ++h) {
    const int slot = (h - h0) & 1;
    __syncthreads();  // done with B (first head) or the previous head
    if (threadIdx.x < Qp) {
      dts[threadIdx.x] = dt_next;
      cl[threadIdx.x] = cl_next;
    }
    if (has_state) {  // the chunk's starting state, as bf16 high and low
#pragma unroll
      for (int k = 0; k < HV; ++k) {
        const int i = threadIdx.x + k * NTHREADS;
        if (i >= N * P / 4) break;
        const int r = i / (P / 4), col = (i % (P / 4)) * 4;
        uint2 hv, lv;
        split2(h_next[k].x, h_next[k].y, hv.x, lv.x);
        split2(h_next[k].z, h_next[k].w, hv.y, lv.y);
        *reinterpret_cast<uint2*>(h_hi + swz<P>(r, col)) = hv;
        *reinterpret_cast<uint2*>(h_lo + swz<P>(r, col)) = lv;
      }
    }
    if (h + 1 < h1) {  // the next head's x, dt and starting state
      load_rows<P>(region + (slot ^ 1) * Qp * P, xb + (h + 1) * g.x_sh,
                   g.x_sl, Qp, Q);
      dt_next = load_dt(dtb + (h + 1) * g.dt_sh, g.dt_sl, Q);
      cl_next = load_cl(clb + (h + 1) * Q, Q);
      if (has_state) load_state(h + 1);
    }
    rt::cp_async_commit();
    rt::cp_async_wait<1>();  // this head's x has landed
    __syncthreads();
    if (lp >= nlp) continue;
    const __nv_bfloat16* xs = region + slot * Qp * P;
    __nv_bfloat16* yb = g.y + b * g.y_sb + h * g.y_sh + (long long)c0 * g.y_sl;
    const int p = lp * R + rb, q = T - 1 - p;
    const uint4* tiles_p = cbt + lp * PT * 64;
    const uint4* tiles_q = tiles_p + (q == p ? 0 : p + 1) * 64;
    const __nv_bfloat16* cs_q = cs + (2 * lp + (q != p)) * 16 * N;
    const int m = q == p ? (p + 1) / 2 : (T + 1) / 2;  // warp 2 lp's tiles of q
    float acc[P / 8][4];
    if (role == 0) {
      strip_part<P, N>(acc, q, 0, m, has_state, false, cs_q, tiles_q, xs,
                       h_hi, h_lo, cl, dts);
#pragma unroll
      for (int n = 0; n < P / 8; ++n)
        part[(lp * (P / 8) + n) * 32 + lane] =
            make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
      asm volatile("bar.arrive %0, 64;\n" ::"r"(1 + lp) : "memory");
      continue;
    }
    if (q != p) {
      strip_part<P, N>(acc, p, 0, p, has_state, true, cs + 2 * lp * 16 * N,
                       tiles_p, xs, h_hi, h_lo, cl, dts);
      store_y<P>(acc, yb, p * 16, Q, g.y_sl);
    }
    strip_part<P, N>(acc, q, m, q, false, true, cs_q, tiles_q, xs, h_hi, h_lo,
                     cl, dts);
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + lp) : "memory");
#pragma unroll
    for (int n = 0; n < P / 8; ++n) {
      const float4 v = part[(lp * (P / 8) + n) * 32 + lane];
      acc[n][0] += v.x;
      acc[n][1] += v.y;
      acc[n][2] += v.z;
      acc[n][3] += v.w;
    }
    store_y<P>(acc, yb, q * 16, Q, g.y_sl);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int P, int N>
cudaError_t run(const Args& g, int B, int upto, cudaStream_t stream) {
  const int Qp = padded(g.Q);
  const dim3 grid1(B * g.nc, (g.H + g.G1 - 1) / g.G1);
  const dim3 grid3(B * g.nc * g.R, (g.H + g.G3 - 1) / g.G3);
  cudaError_t err = allow_smem(chunk_pass<P, N>, chunk_smem(Qp, P, N));
  if (err != cudaSuccess) return err;
  chunk_pass<P, N><<<grid1, NTHREADS, chunk_smem(Qp, P, N), stream>>>(g);
  if ((err = cudaGetLastError()) != cudaSuccess || upto < 2) return err;
  if (g.nc > 1) {
    const long long threads = (long long)B * g.H * N * P / 4;
    state_pass<<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
        g.state, g.cls, g.h_out, B, g.H, g.nc, g.Q, N * P / 4);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (upto < 3) return err;
  const size_t bytes = output_smem(Qp, P, N, g.R);
  if ((err = allow_smem(output_pass<P, N>, bytes)) != cudaSuccess) return err;
  output_pass<P, N><<<grid3, NTHREADS, bytes, stream>>>(g);
  return cudaGetLastError();
}

template <int P>
cudaError_t run_n(const Args& g, int B, int N, int upto, cudaStream_t s) {
  switch (N) {
    case 16: return run<P, 16>(g, B, upto, s);
    case 32: return run<P, 32>(g, B, upto, s);
    case 64: return run<P, 64>(g, B, upto, s);
    case 128: return run<P, 128>(g, B, upto, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int P, int N>
cudaError_t query(int pass, int Qp, int R, long long* out) {
  switch (pass) {
    case 1:
      return rt::query_kernel(chunk_pass<P, N>, NTHREADS,
                              (int)chunk_smem(Qp, P, N), true, out);
    case 2:
      return rt::query_kernel(state_pass, 256, 0, false, out);
    case 3:
      return rt::query_kernel(output_pass<P, N>, NTHREADS,
                              (int)output_smem(Qp, P, N, R), true, out);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int P>
cudaError_t query_n(int pass, int N, int Qp, int R, long long* out) {
  switch (N) {
    case 16: return query<P, 16>(pass, Qp, R, out);
    case 32: return query<P, 32>(pass, Qp, R, out);
    case 64: return query<P, 64>(pass, Qp, R, out);
    case 128: return query<P, 128>(pass, Qp, R, out);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry, loaded with ctypes.  Strides are in elements: x and y
// (batch, head, step), dt (batch, head, step), b and c (batch, step); the
// last dim of x, y, b and c is contiguous; a is fp32 (H,), h_out fp32
// (B,H,N,P) contiguous.  state: fp32 scratch of B * (L / Q) * H * N * P
// values and cls of B * L * H (each chunk's cl; with one chunk, state may
// be h_out).
// G1 and G3 heads per block of passes 1 and 3, R row blocks per chunk in
// pass 3 (1 or 2, each with at most 4 strip pairs).  upto = 1, 2 or 3: the
// passes to run (3 for the scan; fewer leave the intermediates in the
// scratch, for the tests).  L % Q == 0, Q % 4 == 0, Q <= 256.  Returns the
// CUDA error code (0 = ok).
extern "C" int ssd_scan_bf16(
    const void* x, const void* dt, const void* a, const void* b,
    const void* c, void* y, void* h_out, void* state, void* cls, int B,
    int H, int L, int P, int N, int Q, int G1, int G3, int R, int upto,
    long long x_sb,
    long long x_sh, long long x_sl, long long dt_sb, long long dt_sh,
    long long dt_sl, long long b_sb, long long b_sl, long long c_sb,
    long long c_sl, long long y_sb, long long y_sh, long long y_sl,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Q <= 0 || Q > QMAX || L % Q || Q % 4 || G1 < 1 || G1 > MAX_GROUP ||
      G3 < 1 || R < 1 ||
      R > 2 || pairs_max(padded(Q), R) > NWARPS / 2 || upto < 1 || upto > 3)
    return (int)cudaErrorInvalidValue;
  const int nc = L / Q;
  const Args g{static_cast<const __nv_bfloat16*>(x),
               static_cast<const __nv_bfloat16*>(dt),
               static_cast<const float*>(a),
               static_cast<const __nv_bfloat16*>(b),
               static_cast<const __nv_bfloat16*>(c),
               static_cast<__nv_bfloat16*>(y), static_cast<float*>(h_out),
               static_cast<float*>(nc == 1 ? h_out : state),
               static_cast<float*>(cls), H, L, Q, G1, G3, R, nc, x_sb,
               x_sh, x_sl,
               dt_sb, dt_sh, dt_sl, b_sb, b_sl, c_sb, c_sl, y_sb, y_sh, y_sl};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P == 32)
    err = run_n<32>(g, B, N, upto, s);
  else if (P == 64)
    err = run_n<64>(g, B, N, upto, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// The contract query (rt::query_kernel) of pass 1, 2 or 3 of the <P, N>
// instantiation at a chunk of Q rows and R row blocks: the threads and the
// dynamic shared memory run() launches it with.  Launches nothing.
// Returns the CUDA error code; sizes run() refuses are
// cudaErrorInvalidValue.
extern "C" int ssd_scan_query(int pass, int P, int N, int Q, int R, int device,
                              long long* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Q <= 0 || Q > QMAX || Q % 4 || R < 1 || R > 2 ||
      pairs_max(padded(Q), R) > NWARPS / 2)
    return (int)cudaErrorInvalidValue;
  if (P == 32)
    err = query_n<32>(pass, N, padded(Q), R, out);
  else if (P == 64)
    err = query_n<64>(pass, N, padded(Q), R, out);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
