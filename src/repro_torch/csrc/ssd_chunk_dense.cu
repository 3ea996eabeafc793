// Dense SSD chunk scan (Mamba2, chunked form) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_chunk.py::ssd_chunk_scan (body
// _ssd_kernel).  Per (batch b, head h) the sequence runs the recurrence
//
//   state_t = exp(dA_t) * state_{t-1} + dt_t * (B_t (x) x_t)   (N x P)
//   y_t     = C_t . state_t
//
// from a zero state, and returns every y_t and the final state, all
// float32.  Like the TPU kernel it computes the chunked (SSD) form: per
// chunk of Q tokens, with cs the in-chunk cumulative sum of dA,
//
//   W[q][k] = (C_q . B_k) exp(cs_q - cs_k) dt_k        (k <= q, else 0)
//   y_q     = sum_k W[q][k] x_k + exp(cs_q) C_q . state
//   state   = exp(cs_Q) state + sum_k B_k (x) (exp(cs_Q - cs_k) dt_k x_k)
//
// Layout.  One block per (head, 32 columns of P, batch row): 320 blocks
// at mamba2-2.7b's widths (H 80, P 64, two rows).  The TPU grid's
// sequential chunk axis becomes a loop inside the block, with the
// (N x 32) state carried across chunks in registers (thread (warp w,
// lane p) owns rows w*N/8 .. w*N/8 + N/8 - 1 of column p) and mirrored
// in shared memory for the C . state products.  The chunk is Q = 32
// tokens, one warp's lanes: every warp computes the cumulative sum of dA
// itself with shuffles, so no barrier waits for it.  Per chunk the block
// stages C, B (Q x N) and x (Q x 32) in shared memory (58.5 KB at
// N = 128, hence the dynamic shared-memory attribute), then W (one thread
// per (q, four k)), y (one thread per (four q, p)), and the state update
// (one thread per (N/8 rows, p)).  Tokens past S load as zeros with dt = 0
// and dA = 0: they add nothing and decay nothing, so S needs no padding.
// All float32 on CUDA cores; the sums run in another order than the
// token recurrence, so the two agree to float32 rounding.
//
// What bounds it on this card (NVIDIA H100 SXM data sheet: 67 TFLOP/s
// float32, 3.35 TB/s).  At mamba2's widths with two rows of 2048 tokens:
// operations, narrowly, at N = 128.  The least the function needs is the
// chunked form at its best chunk length (6 or 7 tokens): about
// 4NP + Q(N + P) + NP/Q = 35 K operations per token and head, 11.6 GFLOP,
// 0.173 ms; the 511 MB of unique bytes (x, B, C, dA, dt read once, y
// written once) need 0.153 ms.  This kernel's 32-token chunks do 39 K per
// token and head, in 64 chunk steps instead of 2048 token steps; its
// CUDA-core products read every operand from shared memory, which likely
// holds it well above the bound.  At N = 64 the bytes bound it.
//
// What the next PR should do.  Run the three products on tensor cores
// (TF32 or bf16-split wgmma, if the tolerance allows), double-buffer the
// chunk loads with cp.async or TMA, and split the C . B^T work across the
// P-slices of one head instead of repeating it in each.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kQ = 32;        // tokens per chunk: one warp's lanes
constexpr int kPs = 32;       // P columns per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 128;
constexpr int kRows = kMaxN / kWarps;  // state rows per thread, at most
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
ssd_chunk_dense_kernel(const float* __restrict__ x,   // (Bt, S, H, P)
                       const float* __restrict__ Bm,  // (Bt, S, H, N)
                       const float* __restrict__ Cm,  // (Bt, S, H, N)
                       const float* __restrict__ dA,  // (Bt, S, H)
                       const float* __restrict__ dt,  // (Bt, S, H)
                       float* __restrict__ y,         // (Bt, S, H, P)
                       float* __restrict__ state_out, // (Bt, H, N, P)
                       int S, int H, int N, int P) {
  extern __shared__ float smem[];
  const int ldn = N + 4;           // skews the rows across the banks
  float* Cs = smem;                // kQ x ldn
  float* Bs = Cs + kQ * ldn;       // kQ x ldn
  float* Xs = Bs + kQ * ldn;       // kQ x kPs
  float* Ss = Xs + kQ * kPs;       // N x kPs: the state, for C . state
  float* Ws = Ss + N * kPs;        // kQ x (kQ + 1)

  const int h = blockIdx.x;
  const int p0 = blockIdx.y * kPs;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p = p0 + lane;
  const bool p_ok = p < P;
  const int rows = N / kWarps;     // state rows of this thread
  const int n_lo = warp * rows;
  const int n4 = N / 4;

  float st[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) st[i] = 0.f;
  for (int e = tid; e < N * kPs; e += kThreads) Ss[e] = 0.f;

  for (int t0 = 0; t0 < S; t0 += kQ) {
    // stage the chunk; rows past S are zeros
    for (int ch = tid; ch < kQ * n4; ch += kThreads) {
      const int row = ch / n4;
      const int c = (ch - row * n4) * 4;
      const int t = t0 + row;
      float4 cv = make_float4(0.f, 0.f, 0.f, 0.f), bv = cv;
      if (t < S) {
        const size_t off = (((size_t)b * S + t) * H + h) * N + c;
        cv = __ldg(reinterpret_cast<const float4*>(Cm + off));
        bv = __ldg(reinterpret_cast<const float4*>(Bm + off));
      }
      *reinterpret_cast<float4*>(Cs + row * ldn + c) = cv;
      *reinterpret_cast<float4*>(Bs + row * ldn + c) = bv;
    }
    for (int ch = tid; ch < kQ * kPs; ch += kThreads) {
      const int row = ch >> 5;
      const int pc = p0 + (ch & 31);
      const int t = t0 + row;
      Xs[ch] = t < S && pc < P
                   ? __ldg(x + (((size_t)b * S + t) * H + h) * P + pc)
                   : 0.f;
    }
    // lane q holds token t0 + q: cs = inclusive cumulative sum of dA
    const int tq = t0 + lane;
    const size_t hq = ((size_t)b * S + tq) * H + h;
    const float dt_q = tq < S ? __ldg(dt + hq) : 0.f;
    float cs = tq < S ? __ldg(dA + hq) : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(kFull, cs, off);
      if (lane >= off) cs += v;
    }
    const float total = __shfl_sync(kFull, cs, kQ - 1);
    // weight of token q's input in the chunk-end state
    const float dec_q = expf(total - cs) * dt_q;
    __syncthreads();

    {  // W[q][k] for one q and four k
      const int q = tid >> 3;
      const float cs_q = __shfl_sync(kFull, cs, q);
      float dot[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c = 0; c < N; c += 4) {
        const float4 cv = *reinterpret_cast<const float4*>(Cs + q * ldn + c);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = (tid & 7) + 8 * j;
          if (k > q) continue;
          const float4 bv =
              *reinterpret_cast<const float4*>(Bs + k * ldn + c);
          dot[j] += cv.x * bv.x + cv.y * bv.y + cv.z * bv.z + cv.w * bv.w;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = (tid & 7) + 8 * j;
        const float cs_k = __shfl_sync(kFull, cs, k);
        const float dt_k = __shfl_sync(kFull, dt_q, k);
        Ws[q * (kQ + 1) + k] =
            k <= q ? dot[j] * expf(cs_q - cs_k) * dt_k : 0.f;
      }
    }
    __syncthreads();

    {  // y for four q (warp + 8 i) and column p
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      float acs[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < kQ; ++k) {
        const float xk = Xs[k * kPs + lane];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[i] += Ws[(warp + kWarps * i) * (kQ + 1) + k] * xk;
      }
      for (int n = 0; n < N; n += 4) {
        const float s0 = Ss[n * kPs + lane], s1 = Ss[(n + 1) * kPs + lane];
        const float s2 = Ss[(n + 2) * kPs + lane], s3 = Ss[(n + 3) * kPs + lane];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 cv = *reinterpret_cast<const float4*>(
              Cs + (warp + kWarps * i) * ldn + n);
          acs[i] += cv.x * s0 + cv.y * s1 + cv.z * s2 + cv.w * s3;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = warp + kWarps * i;
        const float e_q = expf(__shfl_sync(kFull, cs, q));
        const int t = t0 + q;
        if (t < S && p_ok)
          y[(((size_t)b * S + t) * H + h) * P + p] = acc[i] + e_q * acs[i];
      }
    }
    __syncthreads();  // y read the old state

    {  // state = exp(total) state + sum_k B_k (x) (dec_k x_k)
      const float e_t = expf(total);
#pragma unroll
      for (int i = 0; i < kRows; ++i) st[i] *= e_t;
      for (int k = 0; k < kQ; ++k) {
        const float xd = Xs[k * kPs + lane] * __shfl_sync(kFull, dec_q, k);
        const float* bk = Bs + k * ldn + n_lo;
#pragma unroll
        for (int i = 0; i < kRows; i += 4) {
          if (i < rows) {
            const float4 bv = *reinterpret_cast<const float4*>(bk + i);
            st[i] += bv.x * xd;
            st[i + 1] += bv.y * xd;
            st[i + 2] += bv.z * xd;
            st[i + 3] += bv.w * xd;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        if (i < rows) Ss[(n_lo + i) * kPs + lane] = st[i];
    }
    __syncthreads();  // the next chunk overwrites B and x
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    if (i < rows && p_ok)
      state_out[(((size_t)b * H + h) * N + n_lo + i) * P + p] = st[i];
}

}  // namespace
}  // namespace repro_torch

// x (Bt,S,H,P), B/C (Bt,S,H,N), dA/dt (Bt,S,H) -> y (Bt,S,H,P) and the
// final state (Bt,H,N,P); all float32.  N a multiple of 32, at most 128;
// B and C 16-byte aligned (the wrapper checks).
extern "C" int ssd_chunk_scan(const void* x, const void* B, const void* C,
                              const void* dA, const void* dt, void* y,
                              void* state, int Bt, int S, int H, int N, int P,
                              void* stream) {
  using namespace repro_torch;
  const size_t smem =
      sizeof(float) * (2 * kQ * (N + 4) + kQ * kPs + N * kPs + kQ * (kQ + 1));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(H, (P + kPs - 1) / kPs, Bt);
  ssd_chunk_dense_kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(dA),
      static_cast<const float*>(dt), static_cast<float*>(y),
      static_cast<float*>(state), S, H, N, P);
  return cudaGetLastError();
}
