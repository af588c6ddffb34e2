// Causal GQA flash attention for Hopper (sm_90a), bf16 in and out, fp32
// scores and running softmax state.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (the
// Pallas TPU kernel, body _kernel).  Same function: q (B,H,Sq,D) against
// k/v (B,KV,Sk,D), causal from position 0, optional sliding window and
// tanh cap, keys at positions >= Sk masked, masked scores NEG_INF = -2e38,
// output acc / max(l, 1e-30) in q's dtype.
//
// Bound on the H100: for long prompts the FLOPs (4 * Sq * Sk * D * H / 2
// for the causal half) — at Sq = 2048, H = 32, D = 64 that is ~17 GFLOP,
// ~17 us at the 989 TFLOP/s bf16 tensor-core peak.  For the serving path's
// short prompts (Sq <= 64) the launch and one pass over q/k/v dominate.
//
// Design (simple and right first; a tensor-core version is later work):
// one block of 4 warps per (64-row q tile, head, batch), kv head
// h / (H / KV).  The q tile is staged once in shared memory as fp32; K/V
// tiles of 64 rows are staged in turn.  Each warp holds 16 q rows and runs
// the shared tile step (attention_tile.cuh) on CUDA cores in fp32.  The kv
// loop starts at the first tile the sliding window can reach and stops at
// the causal diagonal, so fully masked tiles are never loaded; the ragged
// edge k >= Sk is zero-filled and masked in the kernel, so the host pads
// nothing.  Inputs are read through strides (last dim contiguous), so the
// model-layout (B,S,H,D) tensors need no transposing copy.
#include "attention_tile.cuh"

namespace {

constexpr int BQ = 64;                   // q rows per block
constexpr int ROWS = BQ / rt::NWARPS;    // q rows per warp

template <int D>
constexpr int smem_bytes() {
  return (BQ * D + rt::BK * (D + 1) + rt::BK * D) * (int)sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(rt::NTHREADS)
flash_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
             int H, int KV, int Sq, int Sk, rt::Strides qst, rt::Strides kst,
             rt::Strides vst, rt::Strides ost, rt::MaskArgs mk) {
  extern __shared__ float smem[];
  float* qsm = smem;                    // BQ x D
  float* ksm = qsm + BQ * D;            // BK x (D + 1)
  float* vsm = ksm + rt::BK * (D + 1);  // BK x D

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5;

  rt::load_tile<D>(qsm, D, q + b * qst.b + h * qst.h + (long long)q0 * qst.s,
                   qst.s, BQ, min(BQ, Sq - q0));

  int qpos[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) qpos[r] = q0 + warp * ROWS + r;

  rt::RowState<D, ROWS> st;
  st.init();

  // keys any row of this tile can see: [k_begin, k_end)
  const int k_end = min(min(q0 + BQ, Sq), Sk);
  const int k_begin = mk.window ? max(0, q0 - mk.window + 1) : 0;
  const __nv_bfloat16* kb = k + b * kst.b + kvh * kst.h;
  const __nv_bfloat16* vb = v + b * vst.b + kvh * vst.h;
  for (int key0 = (k_begin / rt::BK) * rt::BK; key0 < k_end; key0 += rt::BK) {
    __syncthreads();  // the previous tile is consumed (first pass: q is in)
    const int n = min(rt::BK, Sk - key0);
    rt::load_tile<D>(ksm, D + 1, kb + (long long)key0 * kst.s, kst.s, rt::BK, n);
    rt::load_tile<D>(vsm, D, vb + (long long)key0 * vst.s, vst.s, rt::BK, n);
    __syncthreads();
    rt::tile_step<D, ROWS>(st, qsm + warp * ROWS * D, qpos, ksm, vsm, key0, mk);
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = qpos[r];
    if (row < Sq)
      st.store(r, o + b * ost.b + h * ost.h + (long long)row * ost.s);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int H, int KV, int Sq, int Sk, rt::Strides qst,
                   rt::Strides kst, rt::Strides vst, rt::Strides ost,
                   rt::MaskArgs mk, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_kernel<D><<<grid, rt::NTHREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H, KV,
      Sq, Sk, qst, kst, vst, ost, mk);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry, loaded with ctypes.  Strides are in elements; every
// tensor's last dim is contiguous.  Returns the CUDA error code (0 = ok).
extern "C" int flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
    int Sq, int Sk, int D, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, float scale, int window, float cap, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const rt::Strides qst{q_sb, q_sh, q_ss}, kst{k_sb, k_sh, k_ss},
      vst{v_sb, v_sh, v_ss}, ost{o_sb, o_sh, o_ss};
  const rt::MaskArgs mk{scale, cap, window, Sk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    err = launch<64>(q, k, v, o, B, H, KV, Sq, Sk, qst, kst, vst, ost, mk, s);
  else if (D == 128)
    err = launch<128>(q, k, v, o, B, H, KV, Sq, Sk, qst, kst, vst, ost, mk, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
