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
// What bounds it on this card (NVIDIA H100 SXM data sheet: 3.35 TB/s,
// 495 TFLOP/s TF32 on tensor cores, so 165 for float32 as three TF32
// products).  At mamba2's widths with two rows of 2048 tokens the 511 MB
// of unique bytes (x, B, C, dA, dt read once, y written once) need
// 0.153 ms, the least operations (the chunked form at its best chunk
// length) 0.07 ms in 3xTF32: bytes, at N = 128 and N = 64.  What holds
// a kernel above that is the chain: each (b, h) is one sequential walk
// over the chunks, and Bt * H = 160 walks barely exceed 132 SMs.
//
// Design.  The TPU grid's sequential chunk axis stays a loop inside the
// block, so the (N x P-slice) state never leaves the SM and every input
// is read once.
// * Grid (H, P slices, Bt), launched from ssd_chunk.dense_plan: a block
//   owns a slice of up to 64 columns of P, one warp per 16 columns; the
//   plan cuts P into more slices only when Bt * H alone leaves SMs idle,
//   and picks the stage count so that a block takes at most ~110 KB of
//   shared memory: two blocks share each SM, so no SM idles through the
//   tail of the chains.  Chunks are Q = 32 tokens: the chunked form's
//   work per token, Q (N + P) / 2 + 2 N P multiply-adds, is lower than at
//   64, and the double-buffered block stays within the 110 KB.
// * The four products run on tensor cores, mma.sync.m16n8k8 in 3xTF32
//   (each operand split into a TF32 hi and lo part; hi*hi + hi*lo + lo*hi
//   with fp32 accumulation keeps float32 accuracy, one-pass TF32 would
//   keep three digits; the lo terms of C . B^T and of y accumulate apart,
//   which halves their dependent chains).
// * C . B^T once per chunk: each warp takes its share of the state
//   dimension for all six lower-triangle tiles (independent chains, no
//   warp idle), the partials meet in shared memory and are summed in
//   warp order while the mask and decay make W.
// * Then each warp, for its 16 columns p, computes
//   y^T = x^T W^T + state^T (C e^cs)^T and the update
//   state^T = e^total state^T + x^T (B * decay).  The warp's state^T
//   stays in its mma accumulators for the whole walk: the accumulator
//   layout feeds the next chunk's C . state as the A operand directly,
//   with the k index of that product permuted (the lane's columns 2c,
//   2c + 1 read as k = c, c + 4), and B loaded in the same order.
// * The next chunks' C, B, x, dA and dt arrive by cp.async into a ring
//   of stages while the current chunk multiplies: three barriers a
//   chunk.  Between the second and the third, the block scales C's rows
//   by e^cs and B's by the decay in place, once for all its warps.
// * Shared rows are padded so every fragment load is free of bank
//   conflicts.
// * Tokens past S load as zeros with dt = 0 and dA = 0: they add nothing
//   and decay nothing, so S needs no padding; columns past P load as
//   zeros and are not stored.

#include "async_mma.cuh"

namespace repro_torch {
namespace {

using namespace sm90;
constexpr int kWarpCols = 16;     // columns of P per warp (the mma M)
constexpr int kMaxWarps = 4;      // a slice holds at most 64 columns

constexpr int Q = 32;             // tokens per chunk
constexpr int kTiles = (Q / 16) * (Q / 16 + 1);  // lower-triangle W tiles

template <int N>
struct Layout {
  static constexpr int LDC = N + 8;   // C rows: float2 B-operand loads
  static constexpr int LDB = N + 8;   // B rows
  static constexpr int LDW = Q + 4;   // W rows
};

// the stage's floats: C (Q x LDC), B (Q x LDB), x (Q x ldx), dA, dt
__host__ __device__ constexpr int stage_floats(int N, int ldx) {
  return Q * (2 * (N + 8) + ldx) + 2 * Q;
}

// the stages, W (Q x (Q + 4)), per warp its cumulative sums (Q) and its
// C . B^T partials (kTiles x 128), and the rows' two factors (2 Q)
__host__ __device__ constexpr int smem_bytes(int N, int ps, int stages) {
  return 4 * (stages * stage_floats(N, ps + 8) + Q * (Q + 4) +
              (ps / kWarpCols) * (Q + kTiles * 128) + 2 * Q);
}

template <int N>
__global__ void __launch_bounds__(kMaxWarps * 32)
ssd_dense_kernel(const float* __restrict__ x,   // (Bt, S, H, P)
                 const float* __restrict__ Bm,  // (Bt, S, H, N)
                 const float* __restrict__ Cm,  // (Bt, S, H, N)
                 const float* __restrict__ dA,  // (Bt, S, H)
                 const float* __restrict__ dt,  // (Bt, S, H)
                 float* __restrict__ y,         // (Bt, S, H, P)
                 float* __restrict__ state_out, // (Bt, H, N, P)
                 int S, int H, int P, int ps, int stages) {
  using L = Layout<N>;
  constexpr int NT = N / 8;   // state column tiles (and C . B^T k steps)
  constexpr int QT = Q / 8;   // chunk k steps (and y column tiles)
  constexpr int QM = Q / 16;  // W row tiles
  extern __shared__ __align__(16) float smem[];
  const int ldx = ps + 8;
  const int sfl = stage_floats(N, ldx);
  float* Ws = smem + stages * sfl;          // Q x LDW
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  float* csw = Ws + Q * L::LDW + warp * Q;  // the warp's cumulative sums
  float* cbp = Ws + Q * L::LDW + nw * Q;    // the warps' C . B^T partials
  float* fac = cbp + nw * kTiles * 128;     // e^cs_q, then decay_k
  const int g = lane >> 2, c4 = lane & 3;
  const int h = blockIdx.x, p0 = blockIdx.y * ps, b = blockIdx.z;
  const int pw = warp * kWarpCols;          // the warp's columns
  const int nchunks = (S + Q - 1) / Q;

  auto load = [&](int c) {
    float* cs = smem + (c % stages) * sfl;
    float* bs = cs + Q * L::LDC;
    float* xs = bs + Q * L::LDB;
    float* da = xs + Q * ldx;
    float* dts = da + Q;
    const int t0 = c * Q;
    constexpr int n4 = N / 4;
    for (int e = tid; e < Q * n4; e += blockDim.x) {
      const int row = e / n4, col = (e - row * n4) * 4;
      const int t = t0 + row;
      const bool ok = t < S;
      const size_t off = (((size_t)b * S + (ok ? t : 0)) * H + h) * N + col;
      cp_async16(smem_u32(cs + row * L::LDC + col), Cm + off, ok);
      cp_async16(smem_u32(bs + row * L::LDB + col), Bm + off, ok);
    }
    const int p4 = ps / 4;
    for (int e = tid; e < Q * p4; e += blockDim.x) {
      const int row = e / p4, col = (e - row * p4) * 4;
      const int t = t0 + row;
      const bool ok = t < S && p0 + col < P;
      const size_t off =
          ok ? (((size_t)b * S + t) * H + h) * P + p0 + col : 0;
      cp_async16(smem_u32(xs + row * ldx + col), x + off, ok);
    }
    for (int e = tid; e < Q; e += blockDim.x) {
      const int t = t0 + e;
      const bool ok = t < S;
      const size_t off = ok ? ((size_t)b * S + t) * H + h : 0;
      cp_async4(smem_u32(da + e), dA + off, ok);
      cp_async4(smem_u32(dts + e), dt + off, ok);
    }
  };

  // the warp's state^T (its 16 columns p x N), in mma accumulator layout:
  // st[j] holds rows pw + g, + 8 and state columns 8 j + 2 c4, + 1
  float st[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;

  for (int s = 0; s < stages - 1; ++s) {
    if (s < nchunks) load(s);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    // chunk c has landed (stages - 2 younger groups may be in flight)
    switch (stages) {
      case 2: cp_async_wait<0>(); break;
      case 3: cp_async_wait<1>(); break;
      default: cp_async_wait<2>(); break;
    }
    __syncthreads();  // ... for every thread; chunk c - 1 is consumed
    if (c + stages - 1 < nchunks) load(c + stages - 1);
    cp_async_commit();
    float* Cs = smem + (c % stages) * sfl;
    float* Bs = Cs + Q * L::LDC;
    const float* Xs = Bs + Q * L::LDB;
    const float* da = Xs + Q * ldx;
    const float* dts = da + Q;

    // inclusive cumulative sum of dA over the chunk, each warp its own
    {
      float v = da[lane];  // one token a lane
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      csw[lane] = v;
      __syncwarp();
      if (warp == 0) {  // the rows' factors, for every warp after a barrier
        fac[lane] = expf(v);                                       // e^cs_q
        fac[Q + lane] = expf(csw[Q - 1] - v) * dts[lane];          // decay_k
      }
    }
    const float total = csw[Q - 1];

    // C . B^T over the warp's share of the state dimension n (the NT
    // k steps split evenly over the warps), for every lower-triangle
    // 16 x 8 tile (row tile qi, column tile kj <= 2 qi + 1): the tiles'
    // chains are independent.  The product's k index is permuted: lane
    // column c reads n = 2c, c + 4 reads 2c + 1, in both operands.  The
    // warp's partials go to its slot of cbp, in accumulator order.
    {
      float acc[kTiles][4], accc[kTiles][4];
#pragma unroll
      for (int t = 0; t < kTiles; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = accc[t][e] = 0.f;
      for (int kn = warp * NT / nw; kn < (warp + 1) * NT / nw; ++kn) {
        Tf32 a[QM][4];
#pragma unroll
        for (int qi = 0; qi < QM; ++qi) {
          const float* cr = Cs + (16 * qi + g) * L::LDC + 8 * kn + 2 * c4;
          const float2 u = *reinterpret_cast<const float2*>(cr);
          const float2 v = *reinterpret_cast<const float2*>(cr + 8 * L::LDC);
          a[qi][0] = split_tf32(u.x);
          a[qi][1] = split_tf32(v.x);
          a[qi][2] = split_tf32(u.y);
          a[qi][3] = split_tf32(v.y);
        }
#pragma unroll
        for (int kj = 0; kj < QT; ++kj) {
          const float2 w = *reinterpret_cast<const float2*>(
              Bs + (8 * kj + g) * L::LDB + 8 * kn + 2 * c4);
          const Tf32 b0 = split_tf32(w.x), b1 = split_tf32(w.y);
#pragma unroll
          for (int qi = kj / 2; qi < QM; ++qi) {
            const int t = qi * (qi + 1) + kj;
            mma_3xtf32(acc[t], accc[t], a[qi], b0, b1);
          }
        }
      }
      float* mine = cbp + warp * kTiles * 128;
#pragma unroll
      for (int t = 0; t < kTiles; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mine[(t * 4 + e) * 32 + lane] = acc[t][e] + accc[t][e];
    }
    __syncthreads();  // every warp's partials are written
    // W = the partials summed in warp order, masked and decayed
    for (int i = tid; i < kTiles * 128; i += blockDim.x) {
      const int t = i >> 7, e = (i >> 5) & 3, l = i & 31;
      int qi = 0;
      while ((qi + 1) * (qi + 2) <= t) ++qi;
      const int kj = t - qi * (qi + 1);
      const int q = 16 * qi + (l >> 2) + 8 * (e >> 1);
      const int k = 8 * kj + 2 * (l & 3) + (e & 1);
      float v = cbp[i];
      for (int w = 1; w < nw; ++w) v += cbp[w * kTiles * 128 + i];
      Ws[q * L::LDW + k] = k <= q ? v * expf(csw[q] - csw[k]) * dts[k] : 0.f;
    }
    // C . B^T has read C and B: scale their rows in place, C_q by e^cs_q
    // (for y's C . state) and B_k by decay_k (for the update)
    for (int e = tid; e < Q * (N / 4); e += blockDim.x) {
      const int row = e / (N / 4), col = (e - row * (N / 4)) * 4;
      float4* cp = reinterpret_cast<float4*>(Cs + row * L::LDC + col);
      float4* bp = reinterpret_cast<float4*>(Bs + row * L::LDB + col);
      const float fc = fac[row], fb = fac[Q + row];
      float4 u = *cp, w = *bp;
      u.x *= fc; u.y *= fc; u.z *= fc; u.w *= fc;
      w.x *= fb; w.y *= fb; w.z *= fb; w.w *= fb;
      *cp = u;
      *bp = w;
    }
    __syncthreads();  // W, C e^cs and B decay are complete

    float yacc[QT][4], ycor[QT][4];
#pragma unroll
    for (int j = 0; j < QT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[j][e] = ycor[j][e] = 0.f;

    // y^T += state^T (C e^cs)^T: the state's accumulators are the A
    // operand (k permuted as above), C read in the same order
    if (c > 0) {
#pragma unroll
      for (int kn = 0; kn < NT; ++kn) {
        const Tf32 a[4] = {split_tf32(st[kn][0]), split_tf32(st[kn][2]),
                           split_tf32(st[kn][1]), split_tf32(st[kn][3])};
#pragma unroll
        for (int j = 0; j < QT; ++j) {
          const float2 u = *reinterpret_cast<const float2*>(
              Cs + (8 * j + g) * L::LDC + 8 * kn + 2 * c4);
          mma_3xtf32(yacc[j], ycor[j], a, split_tf32(u.x), split_tf32(u.y));
        }
      }
    }

    // the state decays over the chunk
    const float etot = expf(total);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] *= etot;

    // per k step of the chunk: x^T's fragment, y^T += x^T W^T (W is zero
    // above the diagonal: column tiles j >= kk), and the update
    // state^T += x^T (B * decay)
#pragma unroll 1
    for (int kk = 0; kk < QT; ++kk) {
      const int k = 8 * kk + c4;
      const float* x0 = Xs + k * ldx + pw + g;
      const float* x1 = x0 + 4 * ldx;
      const Tf32 a[4] = {split_tf32(x0[0]), split_tf32(x0[8]),
                         split_tf32(x1[0]), split_tf32(x1[8])};
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        if (j < kk) continue;
        const float* wr = Ws + (8 * j + g) * L::LDW + k;
        mma_3xtf32(yacc[j], ycor[j], a, split_tf32(wr[0]),
                   split_tf32(wr[4]));
      }
      const float* b0 = Bs + k * L::LDB + g;  // rows scaled by decay_k
      const float* b1 = b0 + 4 * L::LDB;
#pragma unroll
      for (int jn = 0; jn < NT; ++jn)
        mma_3xtf32(st[jn], a, split_tf32(b0[8 * jn]), split_tf32(b1[8 * jn]));
    }

    // y: yacc[j] holds columns p = pw + g (+ 8), tokens 8 j + 2 c4 (+ 1)
    const int t0 = c * Q;
#pragma unroll
    for (int j = 0; j < QT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + 8 * j + 2 * c4 + (e & 1);
        const int p = p0 + pw + g + 8 * (e >> 1);
        if (t < S && p < P)
          y[(((size_t)b * S + t) * H + h) * P + p] = yacc[j][e] + ycor[j][e];
      }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 8 * j + 2 * c4 + (e & 1);
      const int p = p0 + pw + g + 8 * (e >> 1);
      if (p < P)
        state_out[(((size_t)b * H + h) * N + n) * P + p] = st[j][e];
    }
}

template <int N>
cudaError_t launch(const float* x, const float* B, const float* C,
                   const float* dA, const float* dt, float* y, float* state,
                   int Bt, int S, int H, int P, int ps, int slices,
                   int stages, cudaStream_t s) {
  const int smem = smem_bytes(N, ps, stages);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_dense_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid(H, slices, Bt);
  ssd_dense_kernel<N><<<grid, (ps / kWarpCols) * 32, smem, s>>>(
      x, B, C, dA, dt, y, state, S, H, P, ps, stages);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// x (Bt,S,H,P), B/C (Bt,S,H,N), dA/dt (Bt,S,H) -> y (Bt,S,H,P) and the
// final state (Bt,H,N,P); all float32, 16-byte aligned.  The launch
// (chunk length, P slice ps and slices, stages) is ssd_chunk.dense_plan's;
// this entry checks it against what the kernel is built for (32-token
// chunks) and sizes shared memory from it.
extern "C" int ssd_chunk_scan(const void* x, const void* B, const void* C,
                              const void* dA, const void* dt, void* y,
                              void* state, int Bt, int S, int H, int N, int P,
                              int chunk, int ps, int slices, int stages,
                              void* stream) {
  using namespace repro_torch;
  if (chunk != Q || ps <= 0 || ps % kWarpCols ||
      ps > kWarpCols * kMaxWarps || (long)ps * slices < P || stages < 2 ||
      stages > 4)
    return cudaErrorInvalidValue;
  const auto* xf = static_cast<const float*>(x);
  const auto* bf = static_cast<const float*>(B);
  const auto* cf = static_cast<const float*>(C);
  const auto* af = static_cast<const float*>(dA);
  const auto* tf = static_cast<const float*>(dt);
  auto* yf = static_cast<float*>(y);
  auto* sf = static_cast<float*>(state);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 16: return launch<16>(xf, bf, cf, af, tf, yf, sf, Bt, S, H, P, ps,
                               slices, stages, s);
    case 32: return launch<32>(xf, bf, cf, af, tf, yf, sf, Bt, S, H, P, ps,
                               slices, stages, s);
    case 64: return launch<64>(xf, bf, cf, af, tf, yf, sf, Bt, S, H, P, ps,
                               slices, stages, s);
    case 96: return launch<96>(xf, bf, cf, af, tf, yf, sf, Bt, S, H, P, ps,
                               slices, stages, s);
    case 128: return launch<128>(xf, bf, cf, af, tf, yf, sf, Bt, S, H, P, ps,
                                 slices, stages, s);
    default: return cudaErrorInvalidValue;
  }
}
