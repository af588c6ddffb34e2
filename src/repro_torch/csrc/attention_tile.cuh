// Shared pieces of the two attention kernels (flash_attention.cu,
// decode_attention.cu): tile loads into shared memory and the one-tile
// step of the running (online) softmax.
//
// Both kernels hold a few query rows per warp and walk K/V in tiles of
// BK = 64 keys staged in shared memory as fp32.  For each tile a warp
// computes the fp32 scores of its rows against the 64 keys (lane l owns
// keys l and l+32), applies scale, tanh cap and the causal / window /
// length mask with the JAX package's conventions (masked scores are
// NEG_INF = -2e38, never -inf), updates the running max m and sum l, and
// accumulates P @ V into fp32 registers (lane l owns output columns
// l, l+32, ...).  The final output is acc / max(l, 1e-30), as in
// repro/kernels/flash_attention.py::_kernel and
// repro/kernels/decode_attention.py::_flash_body.
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

// Copy `rows` rows of D bf16 values (row r at src + r * row_stride) into
// fp32 shared memory with row pitch `pitch`; rows >= n_valid become 0.
// 16-byte loads: the wrapper checks that rows are 16-byte aligned.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int rows,
                                          int n_valid) {
  constexpr int VEC = 8;
  constexpr int PER_ROW = D / VEC;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += blockDim.x) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VEC;
    float* out = dst + r * pitch + c;
    if (r < n_valid) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + r * row_stride + c);
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

// Running-softmax state of the ROWS query rows one warp holds.
template <int D, int ROWS>
struct RowState {
  float m[ROWS];
  float l[ROWS];
  float acc[ROWS][D / 32];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      m[r] = NEG_INF;
      l[r] = 0.f;
#pragma unroll
      for (int j = 0; j < D / 32; ++j) acc[r][j] = 0.f;
    }
  }

  // out(row r) = acc / max(l, 1e-30), written as bf16 by column.
  __device__ __forceinline__ void store(int r, __nv_bfloat16* out_row) const {
    const int lane = threadIdx.x & 31;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 32; ++j)
      out_row[lane + 32 * j] = __float2bfloat16(acc[r][j] / denom);
  }
};

// One BK-key tile for the warp's ROWS rows.  qs: the rows' fp32 queries in
// shared memory (row r at qs + r * D); qpos[r]: row r's position.  ks: the
// tile's keys (pitch D + 1, so lanes reading different keys hit different
// banks); vs: its values (pitch D).  key0: position of the tile's first key.
template <int D, int ROWS>
__device__ __forceinline__ void tile_step(RowState<D, ROWS>& st,
                                          const float* qs, const int* qpos,
                                          const float* ks, const float* vs,
                                          int key0, const MaskArgs& mk) {
  const int lane = threadIdx.x & 31;
  float s[ROWS][2];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) s[r][0] = s[r][1] = 0.f;

  const float* k_lo = ks + lane * (D + 1);
  const float* k_hi = ks + (lane + 32) * (D + 1);
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float a = k_lo[d];
    const float b = k_hi[d];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float qv = qs[r * D + d];
      s[r][0] = fmaf(qv, a, s[r][0]);
      s[r][1] = fmaf(qv, b, s[r][1]);
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kpos = key0 + lane + 32 * j;
      float x = s[r][j] * mk.scale;
      if (mk.cap != 0.f) x = mk.cap * tanhf(x / mk.cap);
      bool ok = kpos <= qpos[r] && kpos < mk.sk;
      if (mk.window) ok = ok && (qpos[r] - kpos) < mk.window;
      s[r][j] = ok ? x : NEG_INF;
    }
    const float m_new = fmaxf(st.m[r], warp_max(fmaxf(s[r][0], s[r][1])));
    const float p0 = expf(s[r][0] - m_new);
    const float p1 = expf(s[r][1] - m_new);
    const float corr = expf(st.m[r] - m_new);
    st.l[r] = st.l[r] * corr + warp_sum(p0 + p1);
#pragma unroll
    for (int j = 0; j < D / 32; ++j) st.acc[r][j] *= corr;
    st.m[r] = m_new;
    s[r][0] = p0;  // the scores' registers now hold the probabilities
    s[r][1] = p1;
  }

  // acc += P @ V: key `key` has its probability in lane `key` (s[.][0])
  // and key `key + 32` in lane `key` (s[.][1]).
#pragma unroll 4
  for (int key = 0; key < 32; ++key) {
    float va[D / 32], vb[D / 32];
#pragma unroll
    for (int j = 0; j < D / 32; ++j) {
      va[j] = vs[key * D + lane + 32 * j];
      vb[j] = vs[(key + 32) * D + lane + 32 * j];
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float pa = __shfl_sync(FULL, s[r][0], key);
      const float pb = __shfl_sync(FULL, s[r][1], key);
#pragma unroll
      for (int j = 0; j < D / 32; ++j)
        st.acc[r][j] = fmaf(pb, vb[j], fmaf(pa, va[j], st.acc[r][j]));
    }
  }
}

}  // namespace rt
