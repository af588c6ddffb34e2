// Flash-decoding for Hopper (sm_90a): one query token per row against a
// linear KV cache, bf16 in and out, fp32 running softmax state.
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention (the
// Pallas TPU kernel, bodies _kernel / _flash_body).  Same function: q
// (B,H,D) against k/v (B,KV,S,D), each row b attends to cache positions
// <= pos[b] (and > pos[b] - window), optional tanh cap, masked scores
// NEG_INF = -2e38, output acc / max(l, 1e-30).
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
#include "attention_tile.cuh"

namespace {

template <int D, int ROWS>
constexpr int smem_bytes() {
  return (rt::NWARPS * ROWS * D + rt::BK * (D + 1) + rt::BK * D) *
         (int)sizeof(float);
}

template <int D, int ROWS>
__global__ void __launch_bounds__(rt::NTHREADS)
decode_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const int* __restrict__ pos, __nv_bfloat16* __restrict__ o,
              int H, int KV, int S, rt::Strides qst, rt::Strides kst,
              rt::Strides vst, rt::Strides ost, rt::MaskArgs mk) {
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
  const __nv_bfloat16* kb = k + b * kst.b + kvh * kst.h;
  const __nv_bfloat16* vb = v + b * vst.b + kvh * vst.h;
  for (int key0 = (k_begin / rt::BK) * rt::BK; key0 < k_end; key0 += rt::BK) {
    __syncthreads();
    const int n = min(rt::BK, S - key0);
    rt::load_tile<D>(ksm, D + 1, kb + (long long)key0 * kst.s, kst.s, rt::BK, n);
    rt::load_tile<D>(vsm, D, vb + (long long)key0 * vst.s, vst.s, rt::BK, n);
    __syncthreads();
    rt::tile_step<D, ROWS>(st, qsm + warp * ROWS * D, qpos, ksm, vsm, key0, mk);
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int g = warp * ROWS + r;
    if (g < G) st.store(r, o + b * ost.b + (long long)(kvh * G + g) * ost.h);
  }
}

template <int D, int ROWS>
cudaError_t launch(const void* q, const void* k, const void* v, const int* pos,
                   void* o, int B, int H, int KV, int S, rt::Strides qst,
                   rt::Strides kst, rt::Strides vst, rt::Strides ost,
                   rt::MaskArgs mk, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D, ROWS>();
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<D, ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(KV, B);
  decode_kernel<D, ROWS><<<grid, rt::NTHREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), pos, static_cast<__nv_bfloat16*>(o),
      H, KV, S, qst, kst, vst, ost, mk);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_rows(const void* q, const void* k, const void* v,
                        const int* pos, void* o, int B, int H, int KV, int S,
                        rt::Strides qst, rt::Strides kst, rt::Strides vst,
                        rt::Strides ost, rt::MaskArgs mk, cudaStream_t s) {
  const int G = H / KV;
  if (G <= rt::NWARPS)
    return launch<D, 1>(q, k, v, pos, o, B, H, KV, S, qst, kst, vst, ost, mk, s);
  if (G <= 2 * rt::NWARPS)
    return launch<D, 2>(q, k, v, pos, o, B, H, KV, S, qst, kst, vst, ost, mk, s);
  if (G <= 4 * rt::NWARPS)
    return launch<D, 4>(q, k, v, pos, o, B, H, KV, S, qst, kst, vst, ost, mk, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry, loaded with ctypes.  pos is a device int32 array (B,).
// Strides are in elements (q/o: batch, head; k/v: batch, kv head,
// position); every tensor's last dim is contiguous.  Returns the CUDA
// error code (0 = ok).
extern "C" int decode_attention_bf16(
    const void* q, const void* k, const void* v, const void* pos, void* o,
    int B, int H, int KV, int S, int D, long long q_sb, long long q_sh,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    float scale, int window, float cap, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const rt::Strides qst{q_sb, q_sh, 0}, kst{k_sb, k_sh, k_ss},
      vst{v_sb, v_sh, v_ss}, ost{o_sb, o_sh, 0};
  const rt::MaskArgs mk{scale, cap, window, S};
  const int* p = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    err = launch_rows<64>(q, k, v, p, o, B, H, KV, S, qst, kst, vst, ost, mk, s);
  else if (D == 128)
    err = launch_rows<128>(q, k, v, p, o, B, H, KV, S, qst, kst, vst, ost, mk, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
