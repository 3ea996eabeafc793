// Ragged grouped-LoRA delta (SGMV) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ragged_lora.py::ragged_grouped_lora
// (body _ragged_lora_kernel, padding wrapper ragged_grouped_lora_padded):
//
//   delta[t] = (x[t] @ A[s_t]) @ B[s_t]  if s_t > 0 and s_t in active_slots
//            = 0 (exactly)               otherwise
//
// Two stages, as Punica/S-LoRA's SGMV does, launched back to back on the
// caller's stream:
//   shrink  one block per token: xa[t] = x[t] . A[s_t] over d, fp32
//           accumulation, rounded once to x's dtype (the TPU kernel's
//           xa.astype(x.dtype)).  Thread (k, part) sums a strided share
//           of d for rank column k, reading A's rows coalesced; the parts
//           reduce through shared memory.
//   expand  one block per (token, 256-wide output tile): delta[t, o] =
//           xa[t] . B[s_t][:, o], fp32 accumulation, one rounding.
// Each block loads the K active slot ids into shared memory and tests its
// token's slot against them.  Both stages mask their own edges, so T and
// the output width need no padding.
//
// What bounds it on this card.  Memory: A[s] (d x r) is re-read once per
// token and B[s] once per token, where the bound counts each active
// slot's weights once (the repeats mostly hit L2, 2 x 4096 x 32 bf16 =
// 256 KiB per slot), and the products run on CUDA cores.
//
// What the next PR should do.  Group tokens by slot (the scheduler
// already packs a request's tokens contiguously) so one block reads A[s]
// and B[s] once for a tile of tokens, and run both stages as mma tiles;
// fuse the three Q/K/V deltas, which share x and the slot list.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool slot_active(int s, int n_slots,
                                            const int* act_s, int K) {
  if (s <= 0 || s >= n_slots) return false;
  for (int i = 0; i < K; ++i)
    if (act_s[i] == s) return true;
  return false;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lora_shrink_kernel(const T* __restrict__ x, const T* __restrict__ a_stack,
                   const int* __restrict__ adapter_idx,
                   const int* __restrict__ active_slots, T* __restrict__ xa,
                   int d, int r, int n_slots, int K) {
  extern __shared__ unsigned char smem_raw[];
  float* red = reinterpret_cast<float*>(smem_raw);        // blockDim floats
  int* act_s = reinterpret_cast<int*>(red + blockDim.x);  // K ints
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < K; i += blockDim.x) act_s[i] = active_slots[i];
  __syncthreads();
  const int s = adapter_idx[t];
  T* xat = xa + (size_t)t * r;
  if (!slot_active(s, n_slots, act_s, K)) {
    for (int k = tid; k < r; k += blockDim.x) xat[k] = from_f32<T>(0.f);
    return;
  }
  const int nparts = blockDim.x / r;
  const int k = tid % r;
  const int part = tid / r;
  const T* xt = x + (size_t)t * d;
  const T* a = a_stack + (size_t)s * d * r;
  float acc = 0.f;
  if (part < nparts)
    for (int i = part; i < d; i += nparts)
      acc += to_f32(xt[i]) * to_f32(a[(size_t)i * r + k]);
  red[tid] = acc;
  __syncthreads();
  if (tid < r) {
    float sum = 0.f;
    for (int p = 0; p < nparts; ++p) sum += red[p * r + tid];
    xat[tid] = from_f32<T>(sum);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lora_expand_kernel(const T* __restrict__ xa, const T* __restrict__ b_stack,
                   const int* __restrict__ adapter_idx,
                   const int* __restrict__ active_slots, T* __restrict__ out,
                   int r, int out_dim, int n_slots, int K) {
  extern __shared__ unsigned char smem_raw[];
  float* xa_s = reinterpret_cast<float*>(smem_raw);  // r floats
  int* act_s = reinterpret_cast<int*>(xa_s + r);     // K ints
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int o = blockIdx.y * blockDim.x + tid;
  for (int i = tid; i < K; i += blockDim.x) act_s[i] = active_slots[i];
  for (int k = tid; k < r; k += blockDim.x)
    xa_s[k] = to_f32(xa[(size_t)t * r + k]);
  __syncthreads();
  const int s = adapter_idx[t];
  if (o >= out_dim) return;
  T* ot = out + (size_t)t * out_dim;
  if (!slot_active(s, n_slots, act_s, K)) {
    ot[o] = from_f32<T>(0.f);
    return;
  }
  const T* b = b_stack + (size_t)s * r * out_dim;
  float acc = 0.f;
  for (int k = 0; k < r; ++k) acc += xa_s[k] * to_f32(b[(size_t)k * out_dim + o]);
  ot[o] = from_f32<T>(acc);
}

template <typename T>
cudaError_t launch(const void* x, const void* a_stack, const void* b_stack,
                   const int* adapter_idx, const int* active_slots, void* xa,
                   void* out, int T_, int d, int r, int out_dim, int n_slots,
                   int K, cudaStream_t stream) {
  const size_t shrink_smem = sizeof(float) * kThreads + sizeof(int) * K;
  lora_shrink_kernel<T><<<T_, kThreads, shrink_smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a_stack), adapter_idx,
      active_slots, static_cast<T*>(xa), d, r, n_slots, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t expand_smem = sizeof(float) * r + sizeof(int) * K;
  dim3 grid(T_, (out_dim + kThreads - 1) / kThreads);
  lora_expand_kernel<T><<<grid, kThreads, expand_smem, stream>>>(
      static_cast<const T*>(xa), static_cast<const T*>(b_stack), adapter_idx,
      active_slots, static_cast<T*>(out), r, out_dim, n_slots, K);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

extern "C" int ragged_grouped_lora(const void* x, const void* a_stack,
                                   const void* b_stack,
                                   const void* adapter_idx,
                                   const void* active_slots, void* xa,
                                   void* out, int T, int d, int r, int out_dim,
                                   int n_slots, int K, int is_bf16,
                                   void* stream) {
  const int* idx = static_cast<const int*>(adapter_idx);
  const int* act = static_cast<const int*>(active_slots);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return repro_torch::launch<__nv_bfloat16>(x, a_stack, b_stack, idx, act,
                                              xa, out, T, d, r, out_dim,
                                              n_slots, K, s);
  return repro_torch::launch<float>(x, a_stack, b_stack, idx, act, xa, out, T,
                                    d, r, out_dim, n_slots, K, s);
}
