// Mamba-2 SSD chunked scan for Hopper (sm_90a): bf16 in, fp32 arithmetic
// and state, y in bf16, the final state in fp32.
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
// fp32 final state), ~8.4 us at 3.35 TB/s, and the operations ~4.9 GFLOP
// (C B^T once per chunk, shared by the heads; per head the masked Q x Q
// product with x, C h and the state update), ~5 us at the tensor cores'
// bf16 rate: the bytes bound it.  This kernel executes ~8 GFLOP (it
// recomputes C B^T for every head), in fp32 on CUDA cores.
//
// Design (simple and right first): the TPU grid (B, H, chunks) runs its
// chunk axis in order with the state in VMEM scratch; Hopper runs blocks
// in no order, so one block of 8 warps takes one (batch, head) and walks
// its chunks in a loop, the (N,P) fp32 state staying in shared memory
// throughout.  Per chunk, x, B and C are staged in shared memory as bf16
// (the inputs' own type, so nothing is lost): at Q = 256, N = 128 fp32
// copies of B and C alone would be 256 KB, over the 227 KB a block may use.
// The Q x Q score matrix is never stored: each warp takes groups of 4 rows,
// and for every 32 keys j <= i a lane computes w_ij = (C_i . B_j)
// exp(cl_i - cl_j) dt_j for its key and the warp shuffles it to every
// lane, which owns output columns p = lane + 32 k.  All arithmetic runs on
// CUDA cores in fp32.  The blocks are B * H (48 at full width) on 132 SMs,
// and C B^T is recomputed by every head; a tensor-core (wgmma) design that
// shares C B^T across heads is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int ROWS = 4;  // output rows per warp pass
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int b_pitch(int N) { return N + 2; }

__host__ __device__ constexpr size_t smem_bytes(int Q, int P, int N) {
  return (size_t)Q * P * 2 + (size_t)Q * b_pitch(N) * 2 + (size_t)Q * N * 2 +
         (size_t)N * P * 4 + (size_t)3 * Q * 4;
}

// Copy `rows` rows of W bf16 values (row r at src + r * row_stride, 16-byte
// aligned) into shared memory with row pitch `pitch` bf16 values (even).
template <int W>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int pitch,
                                           const __nv_bfloat16* src,
                                           long long row_stride, int rows) {
  constexpr int VEC = 8;
  constexpr int PER_ROW = W / VEC;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += blockDim.x) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VEC;
    const uint4 raw =
        *reinterpret_cast<const uint4*>(src + r * row_stride + c);
    uint32_t* out = reinterpret_cast<uint32_t*>(dst + r * pitch + c);
    out[0] = raw.x;
    out[1] = raw.y;
    out[2] = raw.z;
    out[3] = raw.w;
  }
}

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* dt;
  const float* a;
  const __nv_bfloat16* b;
  const __nv_bfloat16* c;
  __nv_bfloat16* y;
  float* h_out;
  int H, L, Q;
  long long x_sb, x_sh, x_sl;
  long long dt_sb, dt_sh, dt_sl;
  long long b_sb, b_sl, c_sb, c_sl;
  long long y_sb, y_sh, y_sl;
};

template <int P, int N>
__global__ void __launch_bounds__(NTHREADS) ssd_kernel(Args g) {
  constexpr int KP = P / 32;       // output columns per lane
  constexpr int MN = N / NWARPS;   // state rows per warp in the update
  const int Q = g.Q;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // Q x P
  __nv_bfloat16* bsm = xs + Q * P;                     // Q x b_pitch(N)
  __nv_bfloat16* csm = bsm + Q * b_pitch(N);           // Q x N
  float* hs = reinterpret_cast<float*>(csm + Q * N);   // N x P
  float* cl = hs + N * P;                              // Q
  float* dts = cl + Q;                                 // Q
  float* se = dts + Q;                                 // Q

  const int bh = blockIdx.x;
  const int b = bh / g.H;
  const int h = bh % g.H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float a = g.a[h];

  for (int i = threadIdx.x; i < N * P; i += NTHREADS) hs[i] = 0.f;

  const __nv_bfloat16* xbh = g.x + b * g.x_sb + h * g.x_sh;
  const __nv_bfloat16* dtbh = g.dt + b * g.dt_sb + h * g.dt_sh;
  __nv_bfloat16* ybh = g.y + b * g.y_sb + h * g.y_sh;

  for (int c0 = 0; c0 < g.L; c0 += Q) {
    __syncthreads();  // the previous chunk's readers are done
    stage_rows<P>(xs, P, xbh + (long long)c0 * g.x_sl, g.x_sl, Q);
    stage_rows<N>(bsm, b_pitch(N), g.b + b * g.b_sb + (long long)c0 * g.b_sl,
                  g.b_sl, Q);
    stage_rows<N>(csm, N, g.c + b * g.c_sb + (long long)c0 * g.c_sl, g.c_sl, Q);
    for (int j = threadIdx.x; j < Q; j += NTHREADS)
      dts[j] = __bfloat162float(dtbh[(long long)(c0 + j) * g.dt_sl]);
    __syncthreads();

    // inclusive cumsum of dt * a over the chunk, in one warp: each lane
    // sums a run of consecutive steps, then the runs are scanned
    if (warp == 0) {
      const int per = (Q + 31) / 32;
      const int lo = min(lane * per, Q), hi = min(lo + per, Q);
      float run = 0.f;
      for (int j = lo; j < hi; ++j) {
        run += dts[j] * a;
        cl[j] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += t;
      }
      float excl = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) excl = 0.f;
      for (int j = lo; j < hi; ++j) cl[j] += excl;
    }
    __syncthreads();
    const float cl_last = cl[Q - 1];
    for (int j = threadIdx.x; j < Q; j += NTHREADS)
      se[j] = expf(cl_last - cl[j]) * dts[j];

    // y for groups of ROWS rows: warp w takes rows w*ROWS.., then
    // w*ROWS + NWARPS*ROWS.., so the causal work is spread over the warps
    for (int i0 = warp * ROWS; i0 < Q; i0 += NWARPS * ROWS) {
      float acc[ROWS][KP], cli[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        cli[r] = cl[i0 + r];
#pragma unroll
        for (int k = 0; k < KP; ++k) acc[r][k] = 0.f;
      }
      const int jmax = i0 + ROWS - 1;  // the last key any of the rows sees
      for (int j0 = 0; j0 <= jmax; j0 += 32) {
        const int j = j0 + lane;
        float w[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) w[r] = 0.f;
        if (j <= jmax) {
          float dot[ROWS];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) dot[r] = 0.f;
          const __nv_bfloat162* brow =
              reinterpret_cast<const __nv_bfloat162*>(bsm + j * b_pitch(N));
#pragma unroll 4
          for (int n2 = 0; n2 < N / 2; ++n2) {
            const float2 bv = __bfloat1622float2(brow[n2]);
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
              const float2 cv = __bfloat1622float2(
                  reinterpret_cast<const __nv_bfloat162*>(csm + (i0 + r) * N)[n2]);
              dot[r] = fmaf(cv.x, bv.x, dot[r]);
              dot[r] = fmaf(cv.y, bv.y, dot[r]);
            }
          }
          const float dtj = dts[j], clj = cl[j];
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
            if (j <= i0 + r) w[r] = dot[r] * expf(cli[r] - clj) * dtj;
        }
        const int nj = min(32, jmax + 1 - j0);
        for (int jj = 0; jj < nj; ++jj) {
          float xv[KP];
#pragma unroll
          for (int k = 0; k < KP; ++k)
            xv[k] = __bfloat162float(xs[(j0 + jj) * P + lane + 32 * k]);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const float wr = __shfl_sync(FULL, w[r], jj);
#pragma unroll
            for (int k = 0; k < KP; ++k) acc[r][k] = fmaf(wr, xv[k], acc[r][k]);
          }
        }
      }
      // the carried state's term exp(cl_i) C_i h
      float hc[ROWS][KP];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int k = 0; k < KP; ++k) hc[r][k] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float hv[KP];
#pragma unroll
        for (int k = 0; k < KP; ++k) hv[k] = hs[n * P + lane + 32 * k];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float cv = __bfloat162float(csm[(i0 + r) * N + n]);
#pragma unroll
          for (int k = 0; k < KP; ++k) hc[r][k] = fmaf(cv, hv[k], hc[r][k]);
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float e = expf(cli[r]);
        __nv_bfloat16* yrow = ybh + (long long)(c0 + i0 + r) * g.y_sl;
#pragma unroll
        for (int k = 0; k < KP; ++k)
          yrow[lane + 32 * k] = __float2bfloat16(acc[r][k] + hc[r][k] * e);
      }
    }
    __syncthreads();  // every warp has read h and se is complete

    // state update: warp w owns state rows n = w + NWARPS * m, lane owns
    // columns p = lane + 32 k
    {
      float s[MN][KP];
#pragma unroll
      for (int m = 0; m < MN; ++m)
#pragma unroll
        for (int k = 0; k < KP; ++k) s[m][k] = 0.f;
      for (int j = 0; j < Q; ++j) {
        const float sj = se[j];
        float xv[KP];
#pragma unroll
        for (int k = 0; k < KP; ++k)
          xv[k] = __bfloat162float(xs[j * P + lane + 32 * k]) * sj;
        const __nv_bfloat16* brow = bsm + j * b_pitch(N);
#pragma unroll
        for (int m = 0; m < MN; ++m) {
          const float bv = __bfloat162float(brow[warp + NWARPS * m]);
#pragma unroll
          for (int k = 0; k < KP; ++k) s[m][k] = fmaf(bv, xv[k], s[m][k]);
        }
      }
      const float decay = expf(cl_last);
#pragma unroll
      for (int m = 0; m < MN; ++m)
#pragma unroll
        for (int k = 0; k < KP; ++k) {
          float* hp = hs + (warp + NWARPS * m) * P + lane + 32 * k;
          *hp = *hp * decay + s[m][k];
        }
    }
  }
  __syncthreads();
  float* hout = g.h_out + (long long)bh * N * P;
  for (int i = threadIdx.x; i < N * P; i += NTHREADS) hout[i] = hs[i];
}

template <int P, int N>
cudaError_t launch(const Args& g, int B, cudaStream_t stream) {
  const size_t bytes = smem_bytes(g.Q, P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  ssd_kernel<P, N><<<B * g.H, NTHREADS, bytes, stream>>>(g);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_n(const Args& g, int B, int N, cudaStream_t s) {
  switch (N) {
    case 16: return launch<P, 16>(g, B, s);
    case 32: return launch<P, 32>(g, B, s);
    case 64: return launch<P, 64>(g, B, s);
    case 128: return launch<P, 128>(g, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry, loaded with ctypes.  Strides are in elements: x and y
// (batch, head, step), dt (batch, head, step), b and c (batch, step); the
// last dim of x, y, b and c is contiguous; a is fp32 (H,), h_out fp32
// (B,H,N,P) contiguous.  L % Q == 0, Q % 4 == 0.  Returns the CUDA error
// code (0 = ok).
extern "C" int ssd_scan_bf16(
    const void* x, const void* dt, const void* a, const void* b,
    const void* c, void* y, void* h_out, int B, int H, int L, int P, int N,
    int Q, long long x_sb, long long x_sh, long long x_sl, long long dt_sb,
    long long dt_sh, long long dt_sl, long long b_sb, long long b_sl,
    long long c_sb, long long c_sl, long long y_sb, long long y_sh,
    long long y_sl, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Q <= 0 || L % Q || Q % ROWS) return (int)cudaErrorInvalidValue;
  const Args g{static_cast<const __nv_bfloat16*>(x),
               static_cast<const __nv_bfloat16*>(dt),
               static_cast<const float*>(a),
               static_cast<const __nv_bfloat16*>(b),
               static_cast<const __nv_bfloat16*>(c),
               static_cast<__nv_bfloat16*>(y), static_cast<float*>(h_out),
               H, L, Q, x_sb, x_sh, x_sl, dt_sb, dt_sh, dt_sl, b_sb, b_sl,
               c_sb, c_sl, y_sb, y_sh, y_sl};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P == 32)
    err = launch_n<32>(g, B, N, s);
  else if (P == 64)
    err = launch_n<64>(g, B, N, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
