// Ragged SSD scan (Mamba2, recurrent form) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_chunk.py::ragged_ssd_chunk_scan
// (body _ragged_ssd_kernel).  Over the packed token axis of a mixed
// serving step, each request's tokens form a contiguous segment; at a
// segment start the state is gathered from init_states[slot_rows[t]],
// inside a segment the recurrence runs on:
//
//   state_t = exp(dA_t) * entry + dt_t * (B_t (x) x_t)    (N x P per head)
//   y_t     = C_t . state_t
//
// and every post-token state is written out (the runner gathers the
// segment-final rows for the live pool and the block-boundary rows for
// the prefix cache's snapshots).  All float32, one rounding per output.
//
// Design.  The TPU kernel's sequential chunk grid axis becomes a loop
// over the packed tokens inside each block.  Grid (H, P / 16): a block
// owns one head and a 16-column tile of P; thread n owns state row n of
// that tile in 16 registers (one thread per row, N <= 256).  Per token:
// load the entry row at a segment start, update, store the row as four
// 16-byte stores, and reduce C[n] * state[n, :] over n with warp shuffles
// plus one shared-memory pass across warps (double-buffered by token
// parity, so one __syncthreads per token).  The next token's inputs are
// loaded before the current token's update, one token ahead.  The kernel
// masks nothing: T needs no padding to a chunk multiple.
//
// What bounds it on this card.  Bytes: the T x H x N x P x 4 B post-token
// state writes dominate (335 MB per layer call at T = 128 for mamba2's
// H 80, N 128, P 64), plus the per-segment init_states rows read once.
// The per-block token loop is sequential, so at small T (decode) the
// block's per-token latency, not bandwidth, sets the time.
//
// What the next design would do.  Emit only the rows the caller gathers
// (segment ends and block boundaries), which cuts the state writes by
// the block size; then run the chunked SSD form (C.B^T masked decay,
// W.x, C.state) on tensor cores with wgmma, carrying the state across
// chunks in shared memory.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kPt = 16;           // P columns per block
constexpr int kMaxThreads = 256;  // one thread per state row: N <= 256

__device__ __forceinline__ void load16(const float* __restrict__ src,
                                       float (&dst)[kPt]) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int i = 0; i < kPt / 4; ++i) {
    float4 v = __ldg(s4 + i);
    dst[4 * i] = v.x;
    dst[4 * i + 1] = v.y;
    dst[4 * i + 2] = v.z;
    dst[4 * i + 3] = v.w;
  }
}

__device__ __forceinline__ void store16(float* __restrict__ dst,
                                        const float (&src)[kPt]) {
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int i = 0; i < kPt / 4; ++i)
    d4[i] = make_float4(src[4 * i], src[4 * i + 1], src[4 * i + 2],
                        src[4 * i + 3]);
}

// one token's inputs as thread n of block (h, p0) reads them
struct TokenIn {
  float x[kPt];
  float b, c, da, dt;
  int start, slot;
};

__device__ __forceinline__ void load_token(
    TokenIn& in, int t, int h, int p0, int n, bool row, int H, int N, int P,
    const float* __restrict__ x, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ dA,
    const float* __restrict__ dt, const int* __restrict__ seg_starts,
    const int* __restrict__ slot_rows) {
  load16(x + ((size_t)t * H + h) * P + p0, in.x);
  in.b = row ? __ldg(Bm + ((size_t)t * H + h) * N + n) : 0.f;
  in.c = row ? __ldg(Cm + ((size_t)t * H + h) * N + n) : 0.f;
  in.da = __ldg(dA + (size_t)t * H + h);
  in.dt = __ldg(dt + (size_t)t * H + h);
  in.start = __ldg(seg_starts + t);
  in.slot = __ldg(slot_rows + t);
}

__global__ void __launch_bounds__(kMaxThreads)
ragged_ssd_scan_kernel(const float* __restrict__ x,      // (T, H, P)
                       const float* __restrict__ Bm,     // (T, H, N)
                       const float* __restrict__ Cm,     // (T, H, N)
                       const float* __restrict__ dA,     // (T, H)
                       const float* __restrict__ dt,     // (T, H)
                       const int* __restrict__ seg_starts,  // (T,)
                       const int* __restrict__ slot_rows,   // (T,)
                       const float* __restrict__ init,   // (S, H, N, P)
                       float* __restrict__ y,            // (T, H, P)
                       float* __restrict__ states,       // (T, H, N, P)
                       int T, int H, int N, int P) {
  extern __shared__ float red[];  // [2][n_warps][kPt]
  const int h = blockIdx.x;
  const int p0 = blockIdx.y * kPt;
  const int n = threadIdx.x;
  const bool row = n < N;
  const int lane = n & 31;
  const int warp = n >> 5;
  const int n_warps = blockDim.x >> 5;

  float s[kPt];
#pragma unroll
  for (int j = 0; j < kPt; ++j) s[j] = 0.f;

  TokenIn cur, nxt;
  if (T > 0)
    load_token(cur, 0, h, p0, n, row, H, N, P, x, Bm, Cm, dA, dt,
               seg_starts, slot_rows);
  for (int t = 0; t < T; ++t) {
    if (t + 1 < T)  // one token ahead
      load_token(nxt, t + 1, h, p0, n, row, H, N, P, x, Bm, Cm, dA, dt,
                 seg_starts, slot_rows);
    float prod[kPt];
    if (row) {
      if (cur.start)
        load16(init + (((size_t)cur.slot * H + h) * N + n) * P + p0, s);
      const float decay = expf(cur.da);
      const float coef = cur.b * cur.dt;
#pragma unroll
      for (int j = 0; j < kPt; ++j) s[j] = decay * s[j] + coef * cur.x[j];
      store16(states + (((size_t)t * H + h) * N + n) * P + p0, s);
#pragma unroll
      for (int j = 0; j < kPt; ++j) prod[j] = cur.c * s[j];
    } else {
#pragma unroll
      for (int j = 0; j < kPt; ++j) prod[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kPt; ++j) prod[j] = warp_sum(prod[j]);
    float* buf = red + (t & 1) * n_warps * kPt;
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kPt; ++j) buf[warp * kPt + j] = prod[j];
    }
    __syncthreads();
    if (n < kPt) {
      float acc = 0.f;
      for (int w = 0; w < n_warps; ++w) acc += buf[w * kPt + n];
      y[((size_t)t * H + h) * P + p0 + n] = acc;
    }
    cur = nxt;
  }
}

}  // namespace
}  // namespace repro_torch

// x (T,H,P), B/C (T,H,N), dA/dt (T,H), seg_starts/slot_rows (T,) int32,
// init_states (S,H,N,P) -> y (T,H,P), states (T,H,N,P); all float32.
// P must be a multiple of 16 and N at most 256 (the wrapper checks).
extern "C" int ragged_ssd_chunk_scan(const void* x, const void* B,
                                     const void* C, const void* dA,
                                     const void* dt, const void* seg_starts,
                                     const void* slot_rows,
                                     const void* init_states, void* y,
                                     void* states, int T, int H, int N,
                                     int P, void* stream) {
  using namespace repro_torch;
  const int threads = ((N + 31) / 32) * 32;
  dim3 grid(H, P / kPt);
  const size_t smem = sizeof(float) * 2 * (threads / 32) * kPt;
  ragged_ssd_scan_kernel<<<grid, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(dA),
      static_cast<const float*>(dt), static_cast<const int*>(seg_starts),
      static_cast<const int*>(slot_rows),
      static_cast<const float*>(init_states), static_cast<float*>(y),
      static_cast<float*>(states), T, H, N, P);
  return cudaGetLastError();
}
