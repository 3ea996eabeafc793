// Fused aLoRA QKV projection for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/alora_qkv.py::alora_qkv (body
// _alora_qkv_kernel):
//
//   out[t] = x[t] @ W + round(x[t] @ A[idx_t]) @ B[idx_t]   if 1 <= idx_t < n
//   out[t] = x[t] @ W                                       otherwise
//
// where round() is the rounding to x's type the TPU kernel applies to
// x @ A before the second product.  Adapter 0 is the zero adapter: it is
// skipped whatever A[0] holds.  Products accumulate in fp32; the output
// is rounded once, to x's type.
//
// Two stages on the caller's stream:
//   shrink  one block per token: xa[t] = round(x[t] . A[idx_t]) over d,
//           fp32 accumulation, into a (T, rp) buffer (rp = r rounded up
//           to 32, zero beyond r and for tokens without an adapter);
//           A's rows are read 16 bytes a thread.
//   tile    one block per (64-token x BN-column) output tile.  The K loop
//           runs over d with the x and W tiles in shared memory; then, for
//           each adapter i in [1, n) that a token of the tile uses, over
//           rp with the xa tile masked to the tokens of adapter i and
//           B[i]'s tile.  That is the TPU kernel's static loop over
//           adapters: a masked row adds exact zeros.
//   bf16    tensor cores through nvcuda::wmma 16x16x16 fragments
//           (mma.sync), BN = 128, BK = 32, eight warps of 32 x 32, tiles
//           brought in by cp.async through a ring of four stages (three
//           in flight while the fourth is multiplied).
//   float32 CUDA-core FMAs, BN = 64, BK = 16, 4 x 4 outputs per thread,
//           the next tile prefetched into registers.
// Both stages mask their own edges: T needs no padding; d and the output
// width must be multiples of 8 (16-byte rows), which the wrapper checks.
//
// What bounds it on this card.  At granite-3.2-8b's fused Q/K/V (d 4096,
// out 6144) and T = 512 in bf16: operations (26 GFLOP, against 63 MB of
// unique bytes); at T = 128 the bytes (the 50 MB of W).  This kernel is
// far from either: wmma (mma.sync) reaches a fraction of the wgmma rate,
// and the shrink re-reads A[idx_t] (256 KiB) per token from L2.
//
// What the next PR should do.  wgmma on TMA-fed tiles with a deeper
// pipeline and a persistent grid; the shrink as one tensor-core product
// per adapter over a token tile.

#include <mma.h>

#include "common.cuh"

namespace repro_torch {
namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One run of the K loop: out_tile += A_rows @ B over K.  The A operand's
// rows are tokens (row t at a + t * lda); with adapter > 0 only the rows
// of tokens on that adapter are read, the others count as zeros.  B has
// b_rows valid rows of ldb elements.
struct Phase {
  const void* a;
  int lda;
  const void* b;
  int ldb;
  int K;
  int b_rows;
  int adapter;
};

// ---------------------------------------------------------------- shrink
// Thread (part, g) sums rows part, part + parts, ... of x[t] * A[s] for
// the V rank columns g*V .. g*V + V - 1, reading them as one 16-byte
// load when r is a multiple of V (V = 1 otherwise); the parts then
// reduce through shared memory.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
alora_shrink_kernel(const T* __restrict__ x, const T* __restrict__ a_stack,
                    const int* __restrict__ adapter_idx, T* __restrict__ xa,
                    int d, int r, int rp, int n) {
  __shared__ float red[kThreads * V];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int s = adapter_idx[t];
  const bool on = s >= 1 && s < n;
  const int groups = r / V;  // r <= kThreads
  const int parts = kThreads / groups;
  const int g = tid % groups;
  const int part = tid / groups;
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
  if (on && part < parts) {
    const T* xt = x + (size_t)t * d;
    const T* a = a_stack + (size_t)s * d * r + g * V;
#pragma unroll 4
    for (int i = part; i < d; i += parts) {
      const float xi = to_f32(xt[i]);
      __align__(16) T row[V];
      if constexpr (V == 1) {
        row[0] = a[(size_t)i * r];
      } else {
        *reinterpret_cast<uint4*>(row) =
            __ldg(reinterpret_cast<const uint4*>(a + (size_t)i * r));
      }
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] += xi * to_f32(row[e]);
    }
  }
  if (part < parts) {
#pragma unroll
    for (int e = 0; e < V; ++e) red[part * r + g * V + e] = acc[e];
  }
  __syncthreads();
  T* xat = xa + (size_t)t * rp;
  for (int kk = tid; kk < rp; kk += kThreads) {
    float sum = 0.f;
    if (on && kk < r)
      for (int p = 0; p < parts; ++p) sum += red[p * r + kk];
    xat[kk] = from_f32<T>(sum);
  }
}

template <typename T>
cudaError_t launch_shrink(const void* x, const void* a_stack, const int* idx,
                          void* xa, int T_, int d, int r, int rp, int n,
                          cudaStream_t s) {
  constexpr int kV = 16 / sizeof(T);  // elements in 16 bytes
  const T* xt = static_cast<const T*>(x);
  const T* at = static_cast<const T*>(a_stack);
  if (r % kV == 0)
    alora_shrink_kernel<T, kV><<<T_, kThreads, 0, s>>>(
        xt, at, idx, static_cast<T*>(xa), d, r, rp, n);
  else
    alora_shrink_kernel<T, 1><<<T_, kThreads, 0, s>>>(
        xt, at, idx, static_cast<T*>(xa), d, r, rp, n);
  return cudaGetLastError();
}

// ------------------------------------------------------ bf16 tile (wmma)
constexpr int kBM = 64, kBN = 128, kBK = 32;
constexpr int kStages = 4;     // tiles in flight: three ahead of the MMAs
constexpr int kLdA = kBK + 8;  // bf16 elements; 80-byte rows skew the banks
constexpr int kLdB = kBN + 8;
constexpr int kLdC = kBN + 4;  // floats

// bf16 tiles are kept as raw 16-bit words: a union member must be
// trivially constructible.  55 KB: dynamic shared memory.
struct SmemBf16 {
  union {
    struct {
      unsigned short a[kStages][kBM * kLdA];
      unsigned short b[kStages][kBK * kLdB];
    } ab;
    float c[kBM * kLdC];  // the accumulators, staged for the stores
  } u;
  int idx[kBM];
};

using FragA = nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, bf16,
                                     nvcuda::wmma::row_major>;
using FragB = nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, bf16,
                                     nvcuda::wmma::row_major>;
using FragC =
    nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ void load_tile_bf16(SmemBf16& sm, int stage,
                                               const Phase& ph, int k0,
                                               int m0, int n0, int T,
                                               int out_dim, int tid) {
  {  // A: 64 rows x 32 columns, one 16-byte chunk per thread
    const int row = tid >> 2, c = (tid & 3) * 8;
    const int t = m0 + row, k = k0 + c;
    const bool ok = t < T && k < ph.K &&
                    (ph.adapter == 0 || sm.idx[row] == ph.adapter);
    const bf16* src =
        static_cast<const bf16*>(ph.a) + (ok ? (size_t)t * ph.lda + k : 0);
    cp_async16(&sm.u.ab.a[stage][row * kLdA + c], src, ok);
  }
  for (int ch = tid; ch < kBK * kBN / 8; ch += kThreads) {  // B: 32 x 128
    const int row = ch >> 4, c = (ch & 15) * 8;
    const int k = k0 + row, o = n0 + c;
    const bool ok = k < ph.b_rows && o < out_dim;
    const bf16* src =
        static_cast<const bf16*>(ph.b) + (ok ? (size_t)k * ph.ldb + o : 0);
    cp_async16(&sm.u.ab.b[stage][row * kLdB + c], src, ok);
  }
}

__device__ __forceinline__ void run_phase_bf16(SmemBf16& sm, const Phase& ph,
                                               FragC (&acc)[2][2], int m0,
                                               int n0, int T, int out_dim,
                                               int tid, int wm, int wn) {
  const int ns = (ph.K + kBK - 1) / kBK;
  // prologue: steps 0 .. kStages - 2 in flight; one commit group per
  // step, empty past the end, so that wait_group counts steps
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ns) load_tile_bf16(sm, st, ph, st * kBK, m0, n0, T, out_dim, tid);
    cp_async_commit();
  }
  for (int s = 0; s < ns; ++s) {
    cp_async_wait<kStages - 2>();  // step s has landed
    __syncthreads();  // for every thread; and step s - 1 is consumed
    const int nxt = s + kStages - 1;
    if (nxt < ns)  // into the stage step s - 1 read
      load_tile_bf16(sm, nxt % kStages, ph, nxt * kBK, m0, n0, T, out_dim,
                     tid);
    cp_async_commit();
    const bf16* a = reinterpret_cast<const bf16*>(sm.u.ab.a[s % kStages]);
    const bf16* b = reinterpret_cast<const bf16*>(sm.u.ab.b[s % kStages]);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      FragA fa[2];
      FragB fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        nvcuda::wmma::load_matrix_sync(fa[i], a + (wm * 32 + i * 16) * kLdA + kk,
                                       kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        nvcuda::wmma::load_matrix_sync(fb[j], b + kk * kLdB + wn * 32 + j * 16,
                                       kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          nvcuda::wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  // no copy left in flight, every stage consumed: the next phase (or the
  // accumulators' staging, which shares the memory) may overwrite them
  cp_async_wait<0>();
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
alora_qkv_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                      const bf16* __restrict__ xa,
                      const bf16* __restrict__ b_stack,
                      const int* __restrict__ adapter_idx,
                      bf16* __restrict__ out, int T, int d, int out_dim,
                      int n, int r, int rp) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemBf16& sm = *reinterpret_cast<SmemBf16*>(smem_raw);
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 32 x 32
  if (tid < kBM) sm.idx[tid] = m0 + tid < T ? adapter_idx[m0 + tid] : 0;
  __syncthreads();
  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.f);

  run_phase_bf16(sm, Phase{x, d, w, out_dim, d, d, 0}, acc, m0, n0, T,
                 out_dim, tid, wm, wn);
  for (int i = 1; i < n; ++i) {
    if (!__syncthreads_or(tid < kBM && sm.idx[tid] == i)) continue;
    run_phase_bf16(sm,
                   Phase{xa, rp, b_stack + (size_t)i * r * out_dim, out_dim,
                         rp, r, i},
                   acc, m0, n0, T, out_dim, tid, wm, wn);
  }
  // every phase ended in a barrier: the operand tiles are free for the
  // accumulators
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      nvcuda::wmma::store_matrix_sync(
          sm.u.c + (wm * 32 + i * 16) * kLdC + wn * 32 + j * 16, acc[i][j],
          kLdC, nvcuda::wmma::mem_row_major);
  __syncthreads();
  for (int ch = tid; ch < kBM * kBN / 8; ch += kThreads) {
    const int row = ch >> 4, c = (ch & 15) * 8;
    const int t = m0 + row, o = n0 + c;
    if (t >= T || o >= out_dim) continue;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16(sm.u.c[row * kLdC + c + e]);
    *reinterpret_cast<uint4*>(out + (size_t)t * out_dim + o) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// ---------------------------------------------------- float32 tile (SIMT)
constexpr int kFM = 64, kFN = 64, kFK = 16;
constexpr int kFLd = 64 + 4;

struct SmemF32 {
  float a[2][kFK][kFLd];  // transposed: a[k][token]
  float b[2][kFK][kFLd];
  int idx[kFM];
};

struct RegTile {
  float4 a, b;
};

__device__ __forceinline__ void fetch_f32(RegTile& rt, const SmemF32& sm,
                                          const Phase& ph, int k0, int m0,
                                          int n0, int T, int out_dim,
                                          int tid) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  {  // A: 64 rows x 16 columns, one float4 per thread
    const int row = tid >> 2, c = (tid & 3) * 4;
    const int t = m0 + row, k = k0 + c;
    const bool ok = t < T && k < ph.K &&
                    (ph.adapter == 0 || sm.idx[row] == ph.adapter);
    rt.a = ok ? __ldg(reinterpret_cast<const float4*>(
                    static_cast<const float*>(ph.a) + (size_t)t * ph.lda + k))
              : zero;
  }
  {  // B: 16 rows x 64 columns
    const int row = tid >> 4, c = (tid & 15) * 4;
    const int k = k0 + row, o = n0 + c;
    const bool ok = k < ph.b_rows && o < out_dim;
    rt.b = ok ? __ldg(reinterpret_cast<const float4*>(
                    static_cast<const float*>(ph.b) + (size_t)k * ph.ldb + o))
              : zero;
  }
}

__device__ __forceinline__ void stash_f32(SmemF32& sm, int stage,
                                          const RegTile& rt, int tid) {
  const int row = tid >> 2, c = (tid & 3) * 4;
  sm.a[stage][c + 0][row] = rt.a.x;
  sm.a[stage][c + 1][row] = rt.a.y;
  sm.a[stage][c + 2][row] = rt.a.z;
  sm.a[stage][c + 3][row] = rt.a.w;
  *reinterpret_cast<float4*>(&sm.b[stage][tid >> 4][(tid & 15) * 4]) = rt.b;
}

__device__ __forceinline__ void run_phase_f32(SmemF32& sm, const Phase& ph,
                                              float (&acc)[4][4], int m0,
                                              int n0, int T, int out_dim,
                                              int tid) {
  const int ns = (ph.K + kFK - 1) / kFK;
  const int ty = tid >> 4, tx = tid & 15;
  RegTile rt;
  fetch_f32(rt, sm, ph, 0, m0, n0, T, out_dim, tid);
  stash_f32(sm, 0, rt, tid);
  __syncthreads();
  for (int s = 0; s < ns; ++s) {
    if (s + 1 < ns) fetch_f32(rt, sm, ph, (s + 1) * kFK, m0, n0, T, out_dim, tid);
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&sm.a[s & 1][k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&sm.b[s & 1][k][tx * 4]);
      const float a4[4] = {av.x, av.y, av.z, av.w};
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a4[i], b4[j], acc[i][j]);
    }
    // the stage written here was read in step s - 1, which ended in a
    // barrier
    if (s + 1 < ns) stash_f32(sm, (s + 1) & 1, rt, tid);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
alora_qkv_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ xa,
                     const float* __restrict__ b_stack,
                     const int* __restrict__ adapter_idx,
                     float* __restrict__ out, int T, int d, int out_dim, int n,
                     int r, int rp) {
  __shared__ __align__(16) SmemF32 sm;
  const int m0 = blockIdx.x * kFM, n0 = blockIdx.y * kFN;
  const int tid = threadIdx.x;
  if (tid < kFM) sm.idx[tid] = m0 + tid < T ? adapter_idx[m0 + tid] : 0;
  __syncthreads();
  float acc[4][4] = {};
  run_phase_f32(sm, Phase{x, d, w, out_dim, d, d, 0}, acc, m0, n0, T, out_dim,
                tid);
  for (int i = 1; i < n; ++i) {
    if (!__syncthreads_or(tid < kFM && sm.idx[tid] == i)) continue;
    run_phase_f32(sm,
                  Phase{xa, rp, b_stack + (size_t)i * r * out_dim, out_dim,
                        rp, r, i},
                  acc, m0, n0, T, out_dim, tid);
  }
  const int ty = tid >> 4, tx = tid & 15;
  const int o = n0 + tx * 4;
  if (o >= out_dim) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = m0 + ty * 4 + i;
    if (t < T)
      *reinterpret_cast<float4*>(out + (size_t)t * out_dim + o) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

}  // namespace
}  // namespace repro_torch

// x (T, d), w (d, out), a_stack (n, d, r), b_stack (n, r, out) of one
// type (float32 or bf16), adapter_idx (T,) int32, xa a (T, rp) scratch
// buffer of that type -> out (T, out).  d and out multiples of 8, r <= 256,
// rp = r rounded up to 32, every pointer 16-byte aligned (the wrapper
// checks).
extern "C" int alora_qkv(const void* x, const void* w, const void* a_stack,
                         const void* b_stack, const void* adapter_idx,
                         void* xa, void* out, int T, int d, int out_dim,
                         int n, int r, int rp, int is_bf16, void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* idx = static_cast<const int*>(adapter_idx);
  if (is_bf16) {
    cudaError_t err = launch_shrink<bf16>(x, a_stack, idx, xa, T, d, r, rp,
                                          n, s);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(alora_qkv_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sizeof(SmemBf16)));
    if (err != cudaSuccess) return err;
    dim3 grid((T + kBM - 1) / kBM, (out_dim + kBN - 1) / kBN);
    alora_qkv_bf16_kernel<<<grid, kThreads, sizeof(SmemBf16), s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<const bf16*>(xa), static_cast<const bf16*>(b_stack), idx,
        static_cast<bf16*>(out), T, d, out_dim, n, r, rp);
    return cudaGetLastError();
  }
  cudaError_t err = launch_shrink<float>(x, a_stack, idx, xa, T, d, r, rp, n,
                                         s);
  if (err != cudaSuccess) return err;
  dim3 grid((T + kFM - 1) / kFM, (out_dim + kFN - 1) / kFN);
  alora_qkv_f32_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(xa), static_cast<const float*>(b_stack), idx,
      static_cast<float*>(out), T, d, out_dim, n, r, rp);
  return cudaGetLastError();
}
