// Ragged and decode paged attention for Hopper (sm_90a).
//
// Replaces two TPU kernels of repro/kernels/paged_attention.py, which
// share one body (_paged_attn_kernel):
//   ragged_paged_attention (body _ragged_paged_attn_kernel): every packed
//     token t (a decode singleton or a prefill-chunk row) attends over
//     its own request's paged K/V through block_tables[req_rows[t]],
//     causal to q_lens[t], with an optional window;
//   paged_attention: one query per sequence b over block_tables[b], up
//     to lengths[b] -- the same kernel with req_rows == nullptr (row b
//     of the table is the block's own) and q_lens = lengths.
//
// Layout.  One thread block per (token, KV head).  The block reads
// req_rows[t], q_lens[t] and its row of block_tables itself (the TPU
// kernel took them by scalar prefetch) and keeps the G = H / KV query
// heads of its KV head in shared memory.  It loops only over the blocks
// that hold positions [max(0, q_len - window), q_len): the TPU grid's
// sequential block axis becomes this loop.  The TPU kernel visits every
// block of the table and masks; this one must not, because padding
// entries of a table point at the dump block, which padded rows write,
// and a masked 0 * NaN is still NaN.  Each K/V tile (bs x hd) is staged
// in shared memory as fp32; scores are one warp per (head, key) with a
// shuffle reduction; the softmax is online, in fp32, across the loop.
// Rows with q_lens == 0 write zeros.
//
// What bounds it on this card.  Memory: each token re-reads its whole
// request's K/V, so a prefill chunk of C tokens reads the context C
// times, where the bound counts the unique bytes once.  The loop is
// also serial per block, with no copy/compute overlap, and the dot
// products run on CUDA cores, not tensor cores.  At decode (one token
// per sequence) the grid is only sequences x KV heads, 64 blocks for
// granite's 8 sequences on 132 SMs, each walking its whole context.
//
// What the next PR should do.  Tile the query rows of one request
// together (a prefill chunk shares its K/V: read each tile once for all
// C rows), split a long context across blocks at decode and merge their
// softmax partials, double-buffer the K/V tiles with cp.async or TMA,
// and move QK^T and PV onto mma/wgmma.

#include <math.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_pool,
                              const T* __restrict__ v_pool,
                              const int* __restrict__ block_tables,
                              const int* __restrict__ req_rows,
                              const int* __restrict__ q_lens,
                              T* __restrict__ out, int H, int KV, int hd,
                              int bs, int nb, int window, float scale) {
  extern __shared__ float smem[];
  const int t = blockIdx.x;
  const int kv = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  float* q_s = smem;              // G * hd
  float* acc_s = q_s + G * hd;    // G * hd
  float* k_s = acc_s + G * hd;    // bs * hd
  float* v_s = k_s + bs * hd;     // bs * hd
  float* s_s = v_s + bs * hd;     // G * bs (scores, then probabilities)
  float* m_s = s_s + G * bs;      // G running max
  float* l_s = m_s + G;           // G running denominator
  float* c_s = l_s + G;           // G rescale factor of this tile

  // the G query heads of this KV head are contiguous: q[t, kv*G + g, :]
  const size_t head0 = (size_t)t * H + (size_t)kv * G;
  const T* qt = q + head0 * hd;
  T* ot = out + head0 * hd;
  const int q_len = q_lens[t];
  if (q_len <= 0) {
    for (int e = tid; e < G * hd; e += blockDim.x) ot[e] = from_f32<T>(0.f);
    return;
  }
  for (int e = tid; e < G * hd; e += blockDim.x) {
    q_s[e] = to_f32(qt[e]);
    acc_s[e] = 0.f;
  }
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  const int lo = window > 0 ? max(0, q_len - window) : 0;
  const int row = req_rows != nullptr ? req_rows[t] : t;
  const int* table = block_tables + (size_t)row * nb;
  const size_t row_stride = (size_t)KV * hd;   // one token's K/V row

  for (int ib = lo / bs; ib <= (q_len - 1) / bs; ++ib) {
    const size_t base = (size_t)table[ib] * bs * row_stride + (size_t)kv * hd;
    __syncthreads();  // the previous tile is fully consumed
    for (int e = tid; e < bs * hd; e += blockDim.x) {
      const int j = e / hd;
      const size_t off = base + (size_t)j * row_stride + (e - j * hd);
      k_s[e] = to_f32(k_pool[off]);
      v_s[e] = to_f32(v_pool[off]);
    }
    __syncthreads();
    // scores: one warp per (query head g, key j)
    for (int p = warp; p < G * bs; p += nwarps) {
      const int g = p / bs;
      const int j = p - g * bs;
      float dot = 0.f;
      for (int d = lane; d < hd; d += 32) dot += q_s[g * hd + d] * k_s[j * hd + d];
      dot = warp_sum(dot);
      if (lane == 0) {
        const int pos = ib * bs + j;
        s_s[p] = (pos >= lo && pos < q_len) ? dot * scale : -INFINITY;
      }
    }
    __syncthreads();
    // online softmax update, one thread per query head; every tile holds
    // at least one valid key, so the new max is finite
    if (tid < G) {
      const int g = tid;
      const float m_old = m_s[g];
      float mx = m_old;
      for (int j = 0; j < bs; ++j) mx = fmaxf(mx, s_s[g * bs + j]);
      float sum = 0.f;
      for (int j = 0; j < bs; ++j) {
        const float pj = expf(s_s[g * bs + j] - mx);
        s_s[g * bs + j] = pj;
        sum += pj;
      }
      const float corr = expf(m_old - mx);
      c_s[g] = corr;
      l_s[g] = l_s[g] * corr + sum;
      m_s[g] = mx;
    }
    __syncthreads();
    for (int e = tid; e < G * hd; e += blockDim.x) {
      const int g = e / hd;
      const int d = e - g * hd;
      float a = acc_s[e] * c_s[g];
      for (int j = 0; j < bs; ++j) a += s_s[g * bs + j] * v_s[j * hd + d];
      acc_s[e] = a;
    }
  }
  __syncthreads();
  for (int e = tid; e < G * hd; e += blockDim.x)
    ot[e] = from_f32<T>(acc_s[e] / l_s[e / hd]);
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* block_tables, const int* req_rows,
                   const int* q_lens, void* out, int T_, int H, int KV, int hd,
                   int bs, int nb, int window, float scale,
                   cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem =
      sizeof(float) * (2 * G * hd + 2 * bs * hd + G * bs + 3 * G);
  dim3 grid(T_, KV);
  ragged_paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), block_tables, req_rows, q_lens,
      static_cast<T*>(out), H, KV, hd, bs, nb, window, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

extern "C" int ragged_paged_attention(const void* q, const void* k_pool,
                                      const void* v_pool,
                                      const void* block_tables,
                                      const void* req_rows,
                                      const void* q_lens, void* out, int T,
                                      int H, int KV, int hd, int bs, int nb,
                                      int window, float scale, int is_bf16,
                                      void* stream) {
  const int* bt = static_cast<const int*>(block_tables);
  const int* rows = static_cast<const int*>(req_rows);
  const int* lens = static_cast<const int*>(q_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return repro_torch::launch<__nv_bfloat16>(q, k_pool, v_pool, bt, rows,
                                              lens, out, T, H, KV, hd, bs, nb,
                                              window, scale, s);
  return repro_torch::launch<float>(q, k_pool, v_pool, bt, rows, lens, out, T,
                                    H, KV, hd, bs, nb, window, scale, s);
}

// q (B, H, hd), pools (NB, bs, KV, hd), block_tables (B, nb) and
// lengths (B,) int32 -> out (B, H, hd): row b of the table is sequence
// b's, its causal length lengths[b]; rows with length 0 write zeros.
extern "C" int paged_attention(const void* q, const void* k_pool,
                               const void* v_pool, const void* block_tables,
                               const void* lengths, void* out, int B, int H,
                               int KV, int hd, int bs, int nb, int window,
                               float scale, int is_bf16, void* stream) {
  const int* bt = static_cast<const int*>(block_tables);
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return repro_torch::launch<__nv_bfloat16>(q, k_pool, v_pool, bt, nullptr,
                                              lens, out, B, H, KV, hd, bs, nb,
                                              window, scale, s);
  return repro_torch::launch<float>(q, k_pool, v_pool, bt, nullptr, lens, out,
                                    B, H, KV, hd, bs, nb, window, scale, s);
}
