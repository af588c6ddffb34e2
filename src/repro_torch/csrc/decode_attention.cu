// Flash-decoding for Hopper (sm_90a): one query token per row against a
// linear KV cache (decode_attention_bf16) or a paged one read through a
// block table (paged_decode_attention_bf16), bf16 in and out, fp32 running
// softmax state.
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
// per cached token per row): at B = 4, S = 4096, KV = 8, D = 64 that is
// 33.5 MB, ~10 us at 3.35 TB/s.  The FLOPs are ~1 per byte, far below the
// card's ridge.
//
// Design (simple and right first): one block of 4 warps per (kv head,
// row), so the G = H / KV query heads of a kv head share every K/V tile
// load — the cache is read once per row, not G times.  Warp w holds query
// heads w * ROWS ... w * ROWS + ROWS - 1 of the group and runs the tile
// step shared with the flash kernel (attention_tile.cuh).  The kv loop
// runs over tiles of 64 positions from the window's start to pos[b] only.
// At the serving shapes (B = 4, KV = 8) this is 32 blocks on 132 SMs, each
// walking its tiles in order with no overlap of load and compute: the
// card's bandwidth is not reached.  Splitting the kv loop across blocks
// (split-K with a combine pass) is the next step and later work.
//
// The paged kernel is the same kernel with another tile load: it builds
// each 64-key tile row by row, key `key` from pool[table[b, key / bs], kvh,
// key % bs, :], for keys <= pos[b] only (table entries past a row's
// length are never read; those tile rows are zero and masked).  Every
// arithmetic step is the linear kernel's, so for finite cache values the
// paged output is bit-identical to the linear kernel's on the gathered
// cache, for every block size bs.
#include "attention_tile.cuh"

namespace {

template <int D, int ROWS>
constexpr int smem_bytes() {
  return (rt::NWARPS * ROWS * D + rt::BK * (D + 1) + rt::BK * D) *
         (int)sizeof(float);
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

// Paged twin of rt::load_tile: rows key0 ... key0 + BK - 1 of one kv head,
// each from its pool block; rows >= n_valid become 0 and the table is not
// read for them.
template <int D>
__device__ __forceinline__ void load_paged_tile(
    float* dst, int pitch, const __nv_bfloat16* pool, long long blk_stride,
    long long row_stride, const int* table_row, int bs, int key0,
    int n_valid) {
  constexpr int VEC = 8;
  constexpr int PER_ROW = D / VEC;
  for (int i = threadIdx.x; i < rt::BK * PER_ROW; i += blockDim.x) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VEC;
    float* out = dst + r * pitch + c;
    if (r < n_valid) {
      const int key = key0 + r;
      const __nv_bfloat16* row = pool +
                                 (long long)__ldg(table_row + key / bs) * blk_stride +
                                 (long long)(key % bs) * row_stride;
      const uint4 raw = *reinterpret_cast<const uint4*>(row + c);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC / 2; ++j) {
        const float2 f = __bfloat1622float2(h2[j]);
        out[2 * j] = f.x;
        out[2 * j + 1] = f.y;
      }
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) out[j] = 0.f;
    }
  }
}

// PAGED picks the tile load at compile time, so the linear and the paged
// kernel are two symbols (and two rows of a profile) with one tile step.
template <int D, int ROWS, bool PAGED>
__global__ void __launch_bounds__(rt::NTHREADS)
decode_kernel(const __nv_bfloat16* __restrict__ q, KVSource kv,
              const int* __restrict__ pos, __nv_bfloat16* __restrict__ o,
              int H, int KV, int S, rt::Strides qst, rt::Strides ost,
              rt::MaskArgs mk) {
  extern __shared__ float smem[];
  float* qsm = smem;                          // NWARPS * ROWS x D
  float* ksm = qsm + rt::NWARPS * ROWS * D;   // BK x (D + 1)
  float* vsm = ksm + rt::BK * (D + 1);        // BK x D

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int warp = threadIdx.x >> 5;

  // the group's query heads kvh * G ... kvh * G + G - 1, one row each
  rt::load_tile<D>(qsm, D, q + b * qst.b + (long long)kvh * G * qst.h, qst.h,
                   rt::NWARPS * ROWS, G);

  const int p = pos[b];
  int qpos[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) qpos[r] = p;

  rt::RowState<D, ROWS> st;
  st.init();

  const int k_end = min(p + 1, S);
  const int k_begin = mk.window ? max(0, p - mk.window + 1) : 0;
  const __nv_bfloat16* kh = kv.k + kvh * kv.kst.h;
  const __nv_bfloat16* vh = kv.v + kvh * kv.vst.h;
  for (int key0 = (k_begin / rt::BK) * rt::BK; key0 < k_end; key0 += rt::BK) {
    __syncthreads();
    if constexpr (PAGED) {
      const int* trow = kv.table + (long long)b * kv.nb;
      const int n = min(rt::BK, k_end - key0);
      load_paged_tile<D>(ksm, D + 1, kh, kv.kst.b, kv.kst.s, trow, kv.bs,
                         key0, n);
      load_paged_tile<D>(vsm, D, vh, kv.vst.b, kv.vst.s, trow, kv.bs, key0, n);
    } else {
      const int n = min(rt::BK, S - key0);
      rt::load_tile<D>(ksm, D + 1, kh + b * kv.kst.b + (long long)key0 * kv.kst.s,
                       kv.kst.s, rt::BK, n);
      rt::load_tile<D>(vsm, D, vh + b * kv.vst.b + (long long)key0 * kv.vst.s,
                       kv.vst.s, rt::BK, n);
    }
    __syncthreads();
    rt::tile_step<D, ROWS>(st, qsm + warp * ROWS * D, qpos, ksm, vsm, key0, mk);
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int g = warp * ROWS + r;
    if (g < G) st.store(r, o + b * ost.b + (long long)(kvh * G + g) * ost.h);
  }
}

template <int D, int ROWS, bool PAGED>
cudaError_t launch(const void* q, const KVSource& kv, const int* pos, void* o,
                   int B, int H, int KV, int S, rt::Strides qst,
                   rt::Strides ost, rt::MaskArgs mk, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D, ROWS>();
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<D, ROWS, PAGED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(KV, B);
  decode_kernel<D, ROWS, PAGED><<<grid, rt::NTHREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), kv, pos,
      static_cast<__nv_bfloat16*>(o), H, KV, S, qst, ost, mk);
  return cudaGetLastError();
}

template <int D, bool PAGED>
cudaError_t launch_rows(const void* q, const KVSource& kv, const int* pos,
                        void* o, int B, int H, int KV, int S, rt::Strides qst,
                        rt::Strides ost, rt::MaskArgs mk, cudaStream_t s) {
  const int G = H / KV;
  if (G <= rt::NWARPS)
    return launch<D, 1, PAGED>(q, kv, pos, o, B, H, KV, S, qst, ost, mk, s);
  if (G <= 2 * rt::NWARPS)
    return launch<D, 2, PAGED>(q, kv, pos, o, B, H, KV, S, qst, ost, mk, s);
  if (G <= 4 * rt::NWARPS)
    return launch<D, 4, PAGED>(q, kv, pos, o, B, H, KV, S, qst, ost, mk, s);
  return cudaErrorInvalidValue;
}

template <bool PAGED>
int run(const void* q, const KVSource& kv, const void* pos, void* o, int B,
        int H, int KV, int S, int D, rt::Strides qst, rt::Strides ost,
        float scale, int window, float cap, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const rt::MaskArgs mk{scale, cap, window, S};
  const int* p = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    err = launch_rows<64, PAGED>(q, kv, p, o, B, H, KV, S, qst, ost, mk, s);
  else if (D == 128)
    err = launch_rows<128, PAGED>(q, kv, p, o, B, H, KV, S, qst, ost, mk, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

}  // namespace

// Plain C entries, loaded with ctypes.  pos is a device int32 array (B,).
// Strides are in elements; every tensor's last dim is contiguous.  Return
// the CUDA error code (0 = ok).
//
// Linear cache: k/v (B,KV,S,D); strides q/o: batch, head; k/v: batch, kv
// head, position.
extern "C" int decode_attention_bf16(
    const void* q, const void* k, const void* v, const void* pos, void* o,
    int B, int H, int KV, int S, int D, long long q_sb, long long q_sh,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    float scale, int window, float cap, int device, void* stream) {
  const KVSource kv{static_cast<const __nv_bfloat16*>(k),
                    static_cast<const __nv_bfloat16*>(v),
                    rt::Strides{k_sb, k_sh, k_ss},
                    rt::Strides{v_sb, v_sh, v_ss},
                    nullptr, 0, 0};
  return run<false>(q, kv, pos, o, B, H, KV, S, D,
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
    int device, void* stream) {
  const KVSource kv{static_cast<const __nv_bfloat16*>(k_pool),
                    static_cast<const __nv_bfloat16*>(v_pool),
                    rt::Strides{k_sn, k_sh, k_ss},
                    rt::Strides{v_sn, v_sh, v_ss},
                    static_cast<const int*>(table), nb, bs};
  return run<true>(q, kv, pos, o, B, H, KV, nb * bs, D,
                   rt::Strides{q_sb, q_sh, 0}, rt::Strides{o_sb, o_sh, 0},
                   scale, window, cap, device, stream);
}
