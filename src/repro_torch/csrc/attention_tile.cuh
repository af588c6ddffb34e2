// Shared pieces of the attention kernels: strides and mask arguments,
// cp.async copies, and, for the decode kernels (decode_attention.cu), the
// one-tile step of the running (online) softmax on the tensor cores.
//
// The decode kernels walk K/V in tiles of BK = 64 keys staged in shared
// memory as bf16.  Every warp of a block holds the same 16 query rows (the
// G <= 16 query heads of one kv head, zero-padded) and takes its own 16
// keys of each tile, so the warps of a block are four independent running
// softmaxes that are merged once at the end.  Per tile a warp computes its
// 16 x 16 fp32 scores with mma.sync m16n8k16 (bf16 in, fp32 accumulate),
// applies scale, tanh cap and the causal / window / length mask with the
// JAX package's conventions (masked scores are NEG_INF = -2e38, never
// -inf), updates the running max m and sum l, and accumulates P @ V with
// mma.sync, P rounded to bf16 in registers (the accumulator layout of the
// scores, packed in bf16 pairs, is the A-operand layout).  The final
// output is acc / max(l, 1e-30), as in
// repro/kernels/flash_attention.py::_kernel and
// repro/kernels/decode_attention.py::_flash_body.  The flash kernel
// (flash_attention.cu) runs its own tile step on wgmma.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

constexpr float NEG_INF = -2.0e38f;
constexpr int BK = 64;  // keys per K/V tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr unsigned FULL = 0xffffffffu;

// Element strides of a 4-d tensor whose last dim is contiguous.
struct Strides {
  long long b, h, s;
};

struct MaskArgs {
  float scale;
  float cap;   // 0 = no tanh cap
  int window;  // 0 = no sliding window
  int sk;      // keys at positions >= sk are masked
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; src_bytes = 0 zero-fills the
// destination (src must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cap * tanh(x / cap), written as cap * (1 - 2 / (e^(2x / cap) + 1)): one
// fast exp and one fast divide, within ~1e-6 * cap of tanhf, and +-cap
// when the exp overflows or underflows.
__device__ __forceinline__ float softcap(float x, float cap) {
  return cap * (1.f - __fdividef(2.f, __expf(2.f * x / cap) + 1.f));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// Row pitch of a K or V tile in shared memory, in bf16: 8 more than D
// keeps rows 16-byte aligned for cp.async and ldmatrix, and puts the eight
// rows one fragment load touches in eight different 4-bank groups.
template <int D>
__host__ __device__ constexpr int kpitch() { return D + 8; }

constexpr int WARP_KEYS = BK / NWARPS;  // keys of each tile one warp takes

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row-major fragments) b (16 x 8,
// bf16, column-major fragments)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices, transposed, from shared memory: lane i gives
// the address of row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The 16 query rows of a warp as mma A fragments, for the D / 16 steps of
// 16 along d: thread (g = lane / 4, t = lane % 4) holds rows g and g + 8,
// columns 2t, 2t + 1, 2t + 8, 2t + 9 of each step.  Row r is query head
// r of the group (q + r * head_stride); rows >= G are zero.
template <int D>
__device__ __forceinline__ void load_q_frags(uint32_t (&qa)[D / 16][4],
                                             const __nv_bfloat16* q,
                                             long long head_stride, int G) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = g + 8 * (i & 1);
      const int col = kk * 16 + 2 * t + 8 * (i >> 1);
      qa[kk][i] = row < G ? *reinterpret_cast<const uint32_t*>(
                                q + row * head_stride + col)
                          : 0u;
    }
}

// Running-softmax state of one warp over the keys it has seen: thread
// (g = lane / 4, t = lane % 4) holds rows g (h = 0) and g + 8 (h = 1): the
// row max m[h] (the same in the 4 lanes of a quad), its own share l[h] of
// the row sum, and o[n][2h], o[n][2h + 1], output columns 8n + 2t, 8n +
// 2t + 1 (the mma accumulator layout).
template <int D>
struct WarpState {
  float m[2];
  float l[2];
  float o[D / 8][4];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = NEG_INF;
      l[h] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  }
};

// One BK-key tile: this warp's 16 keys (warp * WARP_KEYS ...) against its
// 16 query rows, all at position qpos, of which the first G are query
// heads.  ks / vs: the tile's keys and values in bf16, pitch kpitch<D>();
// key0: position of the tile's first key.
template <int D>
__device__ __forceinline__ void tile_step(WarpState<D>& st,
                                          const uint32_t (&qa)[D / 16][4],
                                          int G, int qpos,
                                          const __nv_bfloat16* ks,
                                          const __nv_bfloat16* vs, int key0,
                                          const MaskArgs& mk) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kw = (threadIdx.x >> 5) * WARP_KEYS;

  // S = Q K^T: two n-tiles of 8 keys; B (d x key) is K read row by row
  float s[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const __nv_bfloat16* kr =
          ks + (kw + 8 * nt + g) * kpitch<D>() + kk * 16 + 2 * t;
      mma_bf16(s[nt], qa[kk], *reinterpret_cast<const uint32_t*>(kr),
               *reinterpret_cast<const uint32_t*>(kr + 8));
    }

  // Rows 8-15 (h = 1) are all padding when G <= 8: their q is zero, so
  // are their scores, P and output, and their softmax is skipped.
  const int n_h = G > 8 ? 2 : 1;

  // scale, cap, mask: s[nt][i] is key kw + 8 nt + 2t + i % 2 of row
  // g + 8 (i / 2); every row sits at qpos, so the mask is the key's
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i / 2 >= n_h) continue;
      const int kpos = key0 + kw + 8 * nt + 2 * t + (i & 1);
      float x = s[nt][i] * mk.scale;
      if (mk.cap != 0.f) x = softcap(x, mk.cap);
      bool ok = kpos <= qpos && kpos < mk.sk;
      if (mk.window) ok = ok && (qpos - kpos) < mk.window;
      s[nt][i] = ok ? x : NEG_INF;
    }

  float corr[2] = {1.f, 1.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h >= n_h) continue;
    float mx = fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]),
                     fmaxf(s[1][2 * h], s[1][2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    const float m_new = fmaxf(st.m[h], mx);
    corr[h] = expf(st.m[h] - m_new);
    st.m[h] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 2 * h; i < 2 * h + 2; ++i) {
        s[nt][i] = expf(s[nt][i] - m_new);
        sum += s[nt][i];
      }
    st.l[h] = st.l[h] * corr[h] + sum;
  }
  // P (16 rows x 16 keys) as an A fragment: the scores' accumulator layout
  const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                          pack_bf16(s[0][2], s[0][3]),
                          pack_bf16(s[1][0], s[1][1]),
                          pack_bf16(s[1][2], s[1][3])};

  // O = O * corr + P V: B (key x d) is V, transposed by ldmatrix, two
  // n-tiles of 8 columns per load
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    st.o[n][0] *= corr[0];
    st.o[n][1] *= corr[0];
    st.o[n][2] *= corr[1];
    st.o[n][3] *= corr[1];
  }
#pragma unroll
  for (int n2 = 0; n2 < D / 16; ++n2) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, vs + (kw + 8 * ((lane >> 3) & 1) + (lane & 7)) *
                                  kpitch<D>() +
                             16 * n2 + 8 * (lane >> 4));
    mma_bf16(st.o[2 * n2], pa, b[0], b[1]);
    mma_bf16(st.o[2 * n2 + 1], pa, b[2], b[3]);
  }
}

// What the runtime reports of one compiled kernel at the block size and
// dynamic shared memory its launch uses, for the kernels' contract check
// (analysis/kernel_contracts.py::card_check).  Launches nothing.  opt_in:
// the launch raises the kernel's dynamic shared memory limit to dyn, and
// so does this query.  out: registers a thread, local (spill) bytes a
// thread, static shared bytes, the most threads a block, dyn, threads, and
// the blocks an SM can hold at dyn.
template <typename K>
inline cudaError_t query_kernel(K kernel, int threads, int dyn, bool opt_in,
                                long long* out) {
  cudaError_t err = cudaSuccess;
  if (opt_in)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes a;
  if ((err = cudaFuncGetAttributes(&a, kernel)) != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, dyn);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = (long long)a.localSizeBytes;
  out[2] = (long long)a.sharedSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  out[4] = dyn;
  out[5] = threads;
  out[6] = blocks;
  return cudaSuccess;
}

}  // namespace rt
