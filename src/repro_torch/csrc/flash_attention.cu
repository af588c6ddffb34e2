// Causal GQA flash attention for Hopper (sm_90a) on the tensor cores: bf16
// in and out, bf16 products on wgmma, fp32 scores and running softmax
// state.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (the
// Pallas TPU kernel, body _kernel).  Same function: q (B,H,Sq,D) against
// k/v (B,KV,Sk,D), causal from position 0, optional sliding window and
// tanh cap, keys at positions >= Sk masked, masked scores NEG_INF = -2e38,
// output acc / max(l, 1e-30) in bf16.
//
// Bound on the H100: for long prompts the operations, 4 * D per kept
// (query, key) pair and head (~Sq^2 / 2 pairs): at Sq = 2048, H = 32,
// D = 64 that is 17.2 GFLOP, 17.4 us at the 989 TFLOP/s bf16 tensor-core
// peak.  For the serving path's short prompts (Sq <= 64) the launch and one
// pass over q/k/v dominate.
//
// Design.  Only the tensor cores reach that rate, and on Hopper only
// through wgmma, which wants bf16 operands in shared memory in the 128-byte
// swizzled layout.  One block of two warpgroups per (128 q rows, head,
// batch); warpgroup w owns q rows 64w ... 64w + 63, and the kv head is
// h / (H / KV).  At D = 64 a thread needs at most 128 registers, so two
// blocks share an SM and one block's softmax can run beside the other's
// wgmma (the block's own warpgroups meet at a barrier every tile).  Q
// (loaded once) and K/V tiles of 64 keys (a ring of two stages, the next
// tile's copy in flight while this one is used) go into
// bf16 shared memory with cp.async 16-byte copies, each row's 16-byte
// chunk c at chunk c ^ (row % 8): for D = 64 a row is exactly one 128-byte
// swizzle row, for D = 128 the tile is two such column blocks.  cp.async
// zero-fills the ragged edges (q rows >= Sq, keys >= Sk), so the host pads
// nothing, and it reads the model's strided (B,S,H,D) views as they are.
// Per tile and warpgroup:
//   S = Q K^T   wgmma m64n64k16, A = Q and B = K from shared memory, both
//               K-major (D contiguous), D / 16 instructions;
//   softmax     in the accumulator's registers, in fp32: the tanh cap
//               (its own loop, only when there is one), then the causal /
//               window / Sk masks (only in tiles that cross the diagonal,
//               the window edge or Sk); a row lives in the 4 lanes of a
//               quad, so its max takes two shuffles; the running max is
//               kept in log2 units, and without a cap the scale is folded
//               into the FFMA that feeds ex2.approx (one FFMA and one
//               MUFU.EX2 per score);
//   O += P V    wgmma m64nDk16 with P, rounded to bf16, as the register A
//               operand (the fp32 accumulator layout of S, packed in bf16
//               pairs, is the A-fragment layout) and V from shared memory
//               as B, stored (keys, D) with D contiguous: MN-major, the
//               transpose bit set.
// The kv walk starts at the first tile the window can reach and stops at
// the causal diagonal; a warpgroup skips the tiles none of its rows can
// see.  Blocks are issued longest q tile first.  The output O / max(l,
// 1e-30) is written in bf16 through the output strides; rows >= Sq are
// never written.  Where the time goes (benchmarks/torch_flash_breakdown.py):
// the K/V copies, the softmax's arithmetic, the exponentials and the wgmma
// take their turns and barely overlap.  Later step: TMA loads from a
// producer warp, with the two warpgroups taking turns on the tensor cores
// (warp specialisation).
#include "attention_tile.cuh"

namespace {

constexpr int BQ = 128;       // q rows per block: two warpgroups of 64
constexpr int BK = 64;        // keys per K/V tile
constexpr int NTHREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
constexpr int smem_bytes() {  // Q, two stages of K and V, 1024 for alignment
  return (BQ * D + 4 * BK * D) * 2 + 1024;
}

// ROWS rows of D bf16 (row r at src + r * row_stride) into the swizzled
// layout at dst: column block D / 64, then row, then 16-byte chunk
// c ^ (row % 8).  Rows >= n_valid are zero-filled; n_valid >= 1, so row 0
// is a valid address for the zero-filling copies.
template <int ROWS, int D>
__device__ __forceinline__ void load_swizzled(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int n_valid) {
  constexpr int CHUNKS = D / 8;
  static_assert(ROWS * CHUNKS % NTHREADS == 0, "whole copies per thread");
#pragma unroll
  for (int j = 0; j < ROWS * CHUNKS / NTHREADS; ++j) {
    const int i = threadIdx.x + j * NTHREADS;
    const int r = i / CHUNKS;
    const int c = i % CHUNKS;
    const uint32_t off =
        (c / 8) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
    const bool ok = r < n_valid;
    rt::cp_async16(dst + off, ok ? src + r * row_stride + c * 8 : src,
                   ok ? 16 : 0);
  }
}

// wgmma shared-memory descriptor, 128-byte swizzle.  lbo / sbo in bytes:
// sbo is the stride between 8-row groups (1024 here); lbo, for the
// MN-major V, the stride between 64-column blocks (unused for K-major).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// 2^x on the special-function unit, subnormal results flushed to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma (it sees only the issuing asm).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_D32 WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
#define WG_D64 WG_D32, WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
#define WG_R32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31}"
#define WG_R64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x N, fp32) = (accumulate ? d : 0) + A B, A and B K-major in shared
// memory.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate);
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N) += A B, A (64 x 16 bf16) from registers, B MN-major (N
// contiguous) in shared memory: the transpose bit is set.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Accumulator layout of a 64 x N wgmma tile: thread t (of 128) holds, in
// register i, row 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2) and
// column 8 * (i / 4) + 2 * (t % 4) + i % 2.  So "half" hf = (i / 2) % 2
// picks one of the thread's two rows.
template <int D>
__global__ void __launch_bounds__(NTHREADS, D == 64 ? 2 : 1)
flash_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
             int H, int KV, int Sq, int Sk, rt::Strides qst, rt::Strides kst,
             rt::Strides vst, rt::Strides ost, rt::MaskArgs mk) {
  constexpr int Q_BYTES = BQ * D * 2;
  constexpr int KV_BYTES = BK * D * 2;  // one K or V tile
  extern __shared__ uint8_t smem_raw[];
  // the swizzle is a function of the address: align the tiles to 1024
  const uint32_t qs = (rt::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t ks0 = qs + Q_BYTES;  // stage s: K at ks0 + 2 s KV_BYTES,
                                      // V right after it

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - blockIdx.x) * BQ;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;
  const int row0 = q0 + wg * 64 + ((threadIdx.x & 127) >> 5) * 16 + lane / 4;

  // keys any row of the block can see: tiles [t_begin, t_end)
  const int k_end = min(min(q0 + BQ, Sq), Sk);
  const int k_begin = mk.window ? max(0, q0 - mk.window + 1) : 0;
  const int t_begin = k_begin / BK;
  const int t_end = (k_end + BK - 1) / BK;
  // this warpgroup's rows [w_lo, w_hi] and the keys [wk_lo, wk_hi] they see
  const int w_lo = q0 + wg * 64;
  const int w_hi = min(w_lo + 63, Sq - 1);
  const int wk_lo = mk.window ? max(0, w_lo - mk.window + 1) : 0;
  const int wk_hi = min(w_hi, Sk - 1);

  const __nv_bfloat16* kb = k + b * kst.b + kvh * kst.h;
  const __nv_bfloat16* vb = v + b * vst.b + kvh * vst.h;
  auto load_kv = [&](int tile, int stage) {
    const int key0 = tile * BK;
    const int n = min(BK, Sk - key0);
    const uint32_t ks = ks0 + stage * 2 * KV_BYTES;
    load_swizzled<BK, D>(ks, kb + (long long)key0 * kst.s, kst.s, n);
    load_swizzled<BK, D>(ks + KV_BYTES, vb + (long long)key0 * vst.s, vst.s, n);
  };
  load_swizzled<BQ, D>(qs, q + b * qst.b + h * qst.h + (long long)q0 * qst.s,
                   qst.s, min(BQ, Sq - q0));
  load_kv(t_begin, 0);
  rt::cp_async_commit();

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {rt::NEG_INF, rt::NEG_INF};  // running max, log2 units
  float l[2] = {0.f, 0.f};                  // this thread's part of the sum

  // Q of this warpgroup; column block cb of a tile with R rows is R * 128
  // bytes further on
  const uint32_t qw = qs + wg * 64 * 128;
  const float scale2 = mk.scale * LOG2E;

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    if (t + 1 < t_end) load_kv(t + 1, stage ^ 1);
    rt::cp_async_commit();  // possibly empty, so that wait_group 1 always fits
    rt::cp_async_wait<1>();
    // cp.async writes through the generic proxy; wgmma reads through the
    // async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    const int key0 = t * BK;
    if (w_lo <= w_hi && key0 <= wk_hi && key0 + BK - 1 >= wk_lo) {
      const uint32_t ks = ks0 + stage * 2 * KV_BYTES;
      const uint32_t vs = ks + KV_BYTES;

      float s[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 bf16 along the row
        wgmma_ss<BK>(s,
                     sw128_desc(qw + (kk / 4) * (BQ * 128) + off, 16, 1024),
                     sw128_desc(ks + (kk / 4) * (BK * 128) + off, 16, 1024),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);

      // scores in log2 units are s * sc: without a cap sc folds the scale
      // into the exponent's FFMA; with one the capped scores are stored
      float sc = scale2;
      if (mk.cap != 0.f) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          s[i] = rt::softcap(s[i] * mk.scale, mk.cap) * LOG2E;
        sc = 1.f;
      }
      if (key0 + BK - 1 > w_lo || key0 + BK > Sk ||
          (mk.window && key0 <= w_hi - mk.window)) {  // an edge tile
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int kp = key0 + 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
          const int rp = row0 + 8 * ((i >> 1) & 1);
          bool ok = kp <= rp && kp < mk.sk;
          if (mk.window) ok = ok && (rp - kp) < mk.window;
          s[i] = ok ? s[i] : rt::NEG_INF;
        }
      }

      float corr[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = rt::NEG_INF;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          if (((i >> 1) & 1) == hf) mx = fmaxf(mx, s[i]);
        mx = fmaxf(mx, __shfl_xor_sync(rt::FULL, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(rt::FULL, mx, 2));
        const float m_new = fmaxf(m[hf], mx * sc);
        corr[hf] = ex2(m[hf] - m_new);
        m[hf] = m_new;
        l[hf] *= corr[hf];
      }
      uint32_t p[BK / 16][4];  // P in bf16, A fragments of k-steps of 16 keys
#pragma unroll
      for (int i = 0; i < BK / 2; i += 2) {
        const int hf = (i >> 1) & 1;
        const float p0 = ex2(fmaf(s[i], sc, -m[hf]));
        const float p1 = ex2(fmaf(s[i + 1], sc, -m[hf]));
        l[hf] += p0 + p1;
        p[i / 8][(i % 8) / 2] = rt::pack_bf16(p0, p1);
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<D>(acc, p[kk], sw128_desc(vs + kk * 16 * 128, BK * 128, 1024));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
    }
    __syncthreads();  // this stage is consumed before it is loaded again
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(rt::FULL, l[hf], 1);
    l[hf] += __shfl_xor_sync(rt::FULL, l[hf], 2);
    l[hf] = 1.f / fmaxf(l[hf], 1e-30f);
  }
  __nv_bfloat16* ob = o + b * ost.b + h * ost.h;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int hf = (i >> 1) & 1;
    const int row = row0 + 8 * hf;
    if (row < Sq) {
      const int col = 8 * (i / 4) + 2 * (lane & 3);
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row * ost.s + col) =
          __floats2bfloat162_rn(acc[i] * l[hf], acc[i + 1] * l[hf]);
    }
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
  flash_kernel<D><<<grid, NTHREADS, bytes, stream>>>(
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

// The contract query of flash_kernel<D> (rt::query_kernel): what the
// runtime reports at the launch's 256 threads and smem_bytes<D>().
// Launches nothing.  Returns the CUDA error code; an uninstantiated D is
// cudaErrorInvalidValue.
extern "C" int flash_attention_query(int D, int device, long long* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (D == 64)
    err = rt::query_kernel(flash_kernel<64>, NTHREADS, smem_bytes<64>(), true,
                           out);
  else if (D == 128)
    err = rt::query_kernel(flash_kernel<128>, NTHREADS, smem_bytes<128>(),
                           true, out);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
