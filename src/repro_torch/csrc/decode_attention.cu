// Flash-decoding for Hopper (sm_90a), split-K: one query token per row
// against a linear KV cache (decode_attention_bf16) or a paged one read
// through a block table (paged_decode_attention_bf16), bf16 in and out,
// fp32 running softmax state.
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention and
// ::paged_decode_attention (the Pallas TPU kernels, bodies _kernel and
// _paged_kernel around the shared _flash_body).  Same function: q (B,H,D)
// against k/v (B,KV,S,D), or against pools (N,KV,bs,D) with a block table
// (B,nb) mapping logical block i of row b to pool block table[b, i]; each
// row b attends to cache positions <= pos[b] (and > pos[b] - window),
// optional tanh cap, masked scores NEG_INF = -2e38, output
// acc / max(l, 1e-30).
//
// Bound on the H100: the bytes of K and V up to pos (2 * KV * D * 2 bytes
// per cached token per row): at B = 4, S = 4096, KV = 8, D = 64 and pos
// 4095/1000/2047/17 that is 14.7 MB, 4.4 us at 3.35 TB/s.  The FLOPs are
// ~1 per byte, far below the card's ridge.
//
// Design.  Reaching the bandwidth takes many blocks in flight, and one
// block per (kv head, row) is only B * KV (32 at the serving shape) on 132
// SMs.  So the kv walk is split (split-K): the grid is (KV, B, splits), and
// split s walks the 64-key tiles [s T, (s + 1) T), clipped to the row's
// [window start, pos].  The wrapper picks splits and T from B, KV and S
// only (kernels/decode_attention.py::decode_splits: about four blocks per
// SM once the cache is long enough, every split at least one tile of the
// full length, one split when S <= 64); pos stays on the device.  A block
// reads each K/V tile once for all G = H / KV query heads of its kv head:
// its 4 warps hold the same 16 query rows (G <= 16, zero-padded) and each
// takes 16 keys of every tile, running the tile step shared with the paged
// kernel (attention_tile.cuh) on the tensor cores (mma.sync, bf16 in, fp32
// accumulate); the four warps' states are merged once, at the end.  K/V
// tiles are staged as bf16 in a cp.async ring of four stages (three at
// D = 128), so the next tiles' loads overlap this tile's step.  A split
// writes its unnormalised fp32 partial (acc, m, l) to scratch; a split
// whose range holds no tile of its row writes m = NEG_INF, l = 0,
// acc = 0.  A second kernel, launched from the same C entry, combines
// them:
//   M = max_s m_s,  out = sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-30)
// in fp32, written in bf16.  It reads splits * B * H * (D + 2) floats
// (0.54 MB at the shape above).  With one split the split kernel
// writes the output itself and the combine is not launched.
//
// The paged kernel is the same kernel with another tile load: it builds
// each 64-key tile row by row, key `key` from pool[table[b, key / bs], kvh,
// key % bs, :], for keys <= pos[b] only (table entries past a row's
// length are never read; those tile rows are zero and masked).  Its splits
// come from the logical length S = nb * bs.  Every arithmetic step is the
// linear kernel's, so for finite cache values the paged output is
// bit-identical to the linear kernel's on the gathered cache, for every
// block size.
#include "attention_tile.cuh"

namespace {

// K/V ring: up to STAGES - 1 tiles in flight; three stages at D = 128 keep
// two blocks on an SM
template <int D>
__host__ __device__ constexpr int stages() { return D == 64 ? 4 : 3; }

template <int D>
constexpr int smem_bytes() {  // the K/V ring in bf16 (K and V pitch kpitch)
  return stages<D>() * rt::BK * rt::kpitch<D>() * 2 * 2;
}

// Where a block's K/V rows come from.  Linear: k + b * kst.b + kvh * kst.h
// + key * kst.s.  Paged: kst.b is the pool's block stride and kst.s the
// position-in-block stride; table (B, nb) row-major int32.
struct KVSource {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  rt::Strides kst, vst;
  const int* table;  // paged only
  int nb, bs;
};

// How the walk is split: split s takes tiles [s * tiles, (s + 1) * tiles).
// part (splits > 1 only): acc (splits, B, H, D), then m and l (splits, B, H),
// fp32.
struct Split {
  int splits, tiles;
  float* part;
};

// Issue the cp.async copies of one 64-key tile of kv head kvh of row b
// into bf16 shared memory: K at ks and V at vs, both pitch kpitch<D>().
// Linear: rows at positions >= S are zero-filled.  Paged: only keys < k_end
// (<= pos) are fetched, through the table; the rest are zero-filled and
// the table is not read for them.
template <int D, bool PAGED>
__device__ __forceinline__ void load_kv_tile(__nv_bfloat16* ks,
                                             __nv_bfloat16* vs,
                                             const KVSource& kv, int b,
                                             int kvh, int key0, int n_valid) {
  constexpr int PER_ROW = D / 8;  // 16-byte chunks
  const __nv_bfloat16* kh = kv.k + kvh * kv.kst.h;
  const __nv_bfloat16* vh = kv.v + kvh * kv.vst.h;
  for (int i = threadIdx.x; i < rt::BK * PER_ROW; i += blockDim.x) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * 8;
    const bool ok = r < n_valid;
    const int key = key0 + (ok ? r : 0);  // row 0 is always valid
    const __nv_bfloat16* krow;
    const __nv_bfloat16* vrow;
    if constexpr (PAGED) {
      const long long blk = __ldg(kv.table + (long long)b * kv.nb + key / kv.bs);
      krow = kh + blk * kv.kst.b + (long long)(key % kv.bs) * kv.kst.s;
      vrow = vh + blk * kv.vst.b + (long long)(key % kv.bs) * kv.vst.s;
    } else {
      krow = kh + b * kv.kst.b + (long long)key * kv.kst.s;
      vrow = vh + b * kv.vst.b + (long long)key * kv.vst.s;
    }
    rt::cp_async16(rt::smem_u32(ks + r * rt::kpitch<D>() + c), krow + c,
                   ok ? 16 : 0);
    rt::cp_async16(rt::smem_u32(vs + r * rt::kpitch<D>() + c), vrow + c,
                   ok ? 16 : 0);
  }
}

// PAGED picks the tile load at compile time, so the linear and the paged
// kernel are two symbols (and two rows of a profile) with one tile step.
template <int D, bool PAGED>
__global__ void __launch_bounds__(rt::NTHREADS)
decode_kernel(const __nv_bfloat16* __restrict__ q, KVSource kv,
              const int* __restrict__ pos, __nv_bfloat16* __restrict__ o,
              Split sp, int B, int H, int KV, int S, rt::Strides qst,
              rt::Strides ost, rt::MaskArgs mk) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int STAGES = stages<D>();
  constexpr int TILE = rt::BK * rt::kpitch<D>();  // one K or V tile
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);  // K, V, ...

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int G = H / KV;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int p = pos[b];
  const int k_end = min(p + 1, S);
  const int k_begin = mk.window ? max(0, p - mk.window + 1) : 0;
  const int t_lo = max(k_begin / rt::BK, split * sp.tiles);
  const int t_hi = min((k_end + rt::BK - 1) / rt::BK, (split + 1) * sp.tiles);
  const int n_part = B * H;  // partials per split
  auto load = [&](int t, int stage) {
    const int key0 = t * rt::BK;
    load_kv_tile<D, PAGED>(ring + 2 * stage * TILE, ring + (2 * stage + 1) * TILE,
                           kv, b, kvh, key0,
                           min(rt::BK, (PAGED ? k_end : S) - key0));
  };
  // a split whose range holds no tile of this row loads nothing and leaves
  // the initial state: m = NEG_INF, l = 0, acc = 0
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {  // one commit group per tile
    if (t_lo + i < t_hi) load(t_lo + i, i);
    rt::cp_async_commit();
  }
  // the group's query heads kvh * G ... kvh * G + G - 1, as A fragments
  uint32_t qa[D / 16][4];
  rt::load_q_frags<D>(qa, q + b * qst.b + (long long)kvh * G * qst.h, qst.h,
                      G);
  rt::WarpState<D> st;
  st.init();

  for (int t = t_lo; t < t_hi; ++t) {
    const int stage = (t - t_lo) % STAGES;
    if (t + STAGES - 1 < t_hi)
      load(t + STAGES - 1, (stage + STAGES - 1) % STAGES);
    rt::cp_async_commit();  // possibly empty: the group count stays fixed
    rt::cp_async_wait<STAGES - 1>();  // tile t has landed
    __syncthreads();
    rt::tile_step<D>(st, qa, G, p, ring + 2 * stage * TILE,
                     ring + (2 * stage + 1) * TILE, t * rt::BK, mk);
    __syncthreads();  // this stage is consumed before it is loaded again
  }

  // merge the warps' states (each saw its own quarter of every tile)
  // through shared memory, the ring being free: mrg[w][row] holds the
  // row's D output sums, then m and l
  float* mrg = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = st.l[h];
    l += __shfl_xor_sync(rt::FULL, l, 1);
    l += __shfl_xor_sync(rt::FULL, l, 2);
    float* row = mrg + (warp * 16 + g + 8 * h) * (D + 2);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(row + 8 * n + 2 * t4) =
          make_float2(st.o[n][2 * h], st.o[n][2 * h + 1]);
    if (t4 == 0) {
      row[D] = st.m[h];
      row[D + 1] = l;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += rt::NTHREADS) {
    const int r = i / D;
    const int d = i % D;
    float M = rt::NEG_INF;
#pragma unroll
    for (int w = 0; w < rt::NWARPS; ++w)
      M = fmaxf(M, mrg[(w * 16 + r) * (D + 2) + D]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < rt::NWARPS; ++w) {
      const float* row = mrg + (w * 16 + r) * (D + 2);
      const float e = expf(row[D] - M);
      num = fmaf(e, row[d], num);
      den = fmaf(e, row[D + 1], den);
    }
    if (sp.splits == 1) {
      o[b * ost.b + (long long)(kvh * G + r) * ost.h + d] =
          __float2bfloat16(num / fmaxf(den, 1e-30f));
    } else {
      const int pi = split * n_part + b * H + kvh * G + r;
      sp.part[(long long)pi * D + d] = num;
      if (d == 0) {
        float* ml = sp.part + (long long)sp.splits * n_part * D;
        ml[pi] = M;
        ml[sp.splits * n_part + pi] = den;
      }
    }
  }
}

// One block of D threads per (row, query head).  The block first finds
// M = max_s m_s and the weights e^(m_s - M) (one split per thread, kept
// in shared memory) and the denominator; then thread d sums column d of
// the splits' acc, its loads unrolled so that several are in flight.
template <int D>
__global__ void __launch_bounds__(D)
decode_combine_kernel(const float* __restrict__ part,
                      __nv_bfloat16* __restrict__ o, int splits, int B, int H,
                      rt::Strides ost) {
  extern __shared__ float wsm[];  // splits weights
  __shared__ float red[2][D / 32];
  const int bh = blockIdx.x;
  const int n_part = B * H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* m = part + (long long)splits * n_part * D;
  const float* l = m + splits * n_part;

  float mx = rt::NEG_INF;
  for (int s = threadIdx.x; s < splits; s += D)
    mx = fmaxf(mx, m[s * n_part + bh]);
  mx = rt::warp_max(mx);
  if (lane == 0) red[0][warp] = mx;
  __syncthreads();
  float M = red[0][0];
#pragma unroll
  for (int w = 1; w < D / 32; ++w) M = fmaxf(M, red[0][w]);
  float den = 0.f;
  for (int s = threadIdx.x; s < splits; s += D) {
    const float w = expf(m[s * n_part + bh] - M);
    wsm[s] = w;
    den = fmaf(w, l[s * n_part + bh], den);
  }
  den = rt::warp_sum(den);
  if (lane == 0) red[1][warp] = den;
  __syncthreads();
  den = 0.f;
#pragma unroll
  for (int w = 0; w < D / 32; ++w) den += red[1][w];

  float num = 0.f;
  const float* acc = part + (long long)bh * D + threadIdx.x;
#pragma unroll 8
  for (int s = 0; s < splits; ++s)
    num = fmaf(wsm[s], acc[(long long)s * n_part * D], num);
  o[(bh / H) * ost.b + (long long)(bh % H) * ost.h + threadIdx.x] =
      __float2bfloat16(num / fmaxf(den, 1e-30f));
}

template <int D, bool PAGED>
cudaError_t launch(const void* q, const KVSource& kv, const int* pos, void* o,
                   const Split& sp, int B, int H, int KV, int S,
                   rt::Strides qst, rt::Strides ost, rt::MaskArgs mk,
                   cudaStream_t stream) {
  if (H / KV > 16) return cudaErrorInvalidValue;  // 16 query rows per warp
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<D, PAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(KV, B, sp.splits);
  decode_kernel<D, PAGED><<<grid, rt::NTHREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), kv, pos,
      static_cast<__nv_bfloat16*>(o), sp, B, H, KV, S, qst, ost, mk);
  err = cudaGetLastError();
  if (err != cudaSuccess || sp.splits == 1) return err;
  decode_combine_kernel<D><<<B * H, D, sp.splits * sizeof(float), stream>>>(
      sp.part, static_cast<__nv_bfloat16*>(o), sp.splits, B, H, ost);
  return cudaGetLastError();
}

template <bool PAGED>
int run(const void* q, const KVSource& kv, const void* pos, void* o,
        const Split& sp, int B, int H, int KV, int S, int D, rt::Strides qst,
        rt::Strides ost, float scale, int window, float cap, int device,
        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (sp.splits < 1 || sp.tiles < 1 || (sp.splits > 1 && sp.part == nullptr))
    return (int)cudaErrorInvalidValue;
  const rt::MaskArgs mk{scale, cap, window, S};
  const int* p = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    err = launch<64, PAGED>(q, kv, p, o, sp, B, H, KV, S, qst, ost, mk, s);
  else if (D == 128)
    err = launch<128, PAGED>(q, kv, p, o, sp, B, H, KV, S, qst, ost, mk, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

template <int D>
cudaError_t query(int kind, int splits, long long* out) {
  switch (kind) {
    case 0:
      return rt::query_kernel(decode_kernel<D, false>, rt::NTHREADS,
                              smem_bytes<D>(), true, out);
    case 1:
      return rt::query_kernel(decode_kernel<D, true>, rt::NTHREADS,
                              smem_bytes<D>(), true, out);
    case 2:
      return rt::query_kernel(decode_combine_kernel<D>, D,
                              splits * (int)sizeof(float), false, out);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entries, loaded with ctypes.  pos is a device int32 array (B,).
// Strides are in elements; every tensor's last dim is contiguous.  splits
// and tiles (per split) as decode_splits gives them; scratch holds
// splits * B * H * (D + 2) floats (may be null when splits == 1).  Return
// the CUDA error code (0 = ok).
//
// Linear cache: k/v (B,KV,S,D); strides q/o: batch, head; k/v: batch, kv
// head, position.
extern "C" int decode_attention_bf16(
    const void* q, const void* k, const void* v, const void* pos, void* o,
    int B, int H, int KV, int S, int D, long long q_sb, long long q_sh,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    float scale, int window, float cap, int splits, int tiles, void* scratch,
    int device, void* stream) {
  const KVSource kv{static_cast<const __nv_bfloat16*>(k),
                    static_cast<const __nv_bfloat16*>(v),
                    rt::Strides{k_sb, k_sh, k_ss},
                    rt::Strides{v_sb, v_sh, v_ss},
                    nullptr, 0, 0};
  const Split sp{splits, tiles, static_cast<float*>(scratch)};
  return run<false>(q, kv, pos, o, sp, B, H, KV, S, D,
                    rt::Strides{q_sb, q_sh, 0}, rt::Strides{o_sb, o_sh, 0},
                    scale, window, cap, device, stream);
}

// Paged cache: pools (N,KV,bs,D) with strides block, kv head, position in
// block; table a device int32 array (B, nb), row-major.  The logical
// length is S = nb * bs.
extern "C" int paged_decode_attention_bf16(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* pos, void* o, int B, int H, int KV, int nb, int bs, int D,
    long long q_sb, long long q_sh, long long k_sn, long long k_sh,
    long long k_ss, long long v_sn, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, float scale, int window, float cap,
    int splits, int tiles, void* scratch, int device, void* stream) {
  const KVSource kv{static_cast<const __nv_bfloat16*>(k_pool),
                    static_cast<const __nv_bfloat16*>(v_pool),
                    rt::Strides{k_sn, k_sh, k_ss},
                    rt::Strides{v_sn, v_sh, v_ss},
                    static_cast<const int*>(table), nb, bs};
  const Split sp{splits, tiles, static_cast<float*>(scratch)};
  return run<true>(q, kv, pos, o, sp, B, H, KV, nb * bs, D,
                   rt::Strides{q_sb, q_sh, 0}, rt::Strides{o_sb, o_sh, 0},
                   scale, window, cap, device, stream);
}

// The contract query (rt::query_kernel) of the split kernel, linear (kind
// 0) or paged (kind 1), at the launch's threads and smem_bytes<D>(), or of
// the combine kernel (kind 2) at splits * 4 bytes.  Launches nothing.
// Returns the CUDA error code; an uninstantiated D or kind is
// cudaErrorInvalidValue.
extern "C" int decode_attention_query(int kind, int D, int splits, int device,
                                      long long* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (D == 64)
    err = query<64>(kind, splits, out);
  else if (D == 128)
    err = query<128>(kind, splits, out);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
