// Ragged and decode paged attention for Hopper (sm_90a).
//
// Replaces two TPU kernels of repro/kernels/paged_attention.py, which
// share one body (_paged_attn_kernel):
//   ragged_paged_attention (body _ragged_paged_attn_kernel): every packed
//     token t (a decode singleton or a prefill-chunk row) attends over
//     its own request's paged K/V through block_tables[req_rows[t]],
//     causal to q_lens[t], with an optional window;
//   paged_attention: one query per sequence b over block_tables[b], up
//     to lengths[b] -- the same kernels with req_rows == nullptr (row b
//     of the table is the block's own) and q_lens = lengths.
//
// What bounds it on this card.  Bytes: every K/V row of the valid
// positions must be read once, 2 * hd * 2 bytes per token and KV head in
// bf16, against ~4 * G * hd operations, far below the tensor cores'
// ~295 operations per byte.  So the work is to keep enough blocks and
// bytes in flight, to read each K/V row once per tile of query rows
// rather than once per row, and to keep the products off the critical
// path.  At decode the context of one request is short next to the
// card, so what is left is latency: each block's chain of index reads,
// copies and products (PERF.md gives the measured split).
//
// Layout.  Query tiles come from the indices alone: a tile is a run of
// at most M = 64 / G (rounded down) consecutive packed rows with one
// req_rows value that does not cross a multiple of M (row t heads a tile
// when t % M == 0 or req_rows[t-1] != req_rows[t]), so a tile holds at
// most 64 query rows (token x query head of one KV head).  G = H / KV
// is any 1..64 (a row's token and head are found by division); when it
// does not divide 64 (3, 6, 12) the tile's rows from M * G to 63 are
// zeros that are never written.  A decode singleton is its own
// tile; a prefill chunk's rows share one pass over its K/V, each row with
// its own causal mask; rows of one request need not be contiguous (they
// only make more tiles).  The grid is (T, KV, splits): splits =
// ceil(nb * bs / kSplit) cuts the table's span into kSplit tokens each
// (flash-decoding), so a long context is spread over many blocks.  The
// grid depends on the shapes alone (no length is read on the host); a
// block whose row heads no tile, or whose split holds no valid position
// of its tile, exits at once.
//
// A block reads the table entries of its split's blocks once into
// shared memory, then stages its K/V rows in tiles of KT tokens by
// 16-byte cp.async through a ring of stages (the next tile loads while
// this one is computed); each thread copies the same (row, 16 bytes)
// slots of every tile, so a tile costs it a table lookup and two copies
// per slot.  A token that is valid for no row of the tile is zero-filled
// (src-size 0) and the table entry of a block that holds no valid token
// is never read: padding entries point at the dump block, which padded
// rows write, and a masked 0 * NaN is still NaN.
//
// The 4 warps split the tile's query rows into 16-row slabs and, when
// there are fewer than 4 slabs, each tile's keys too; each warp keeps an
// online softmax (fp32, in the exp2 domain) and its accumulator in
// registers, in the mma.m16n8 fragment layout, and the warps of one slab
// merge through shared memory at the end.
//   bf16:    Q K^T and P V on mma.sync.m16n8k16 (bf16 in, fp32 out), Q
//            and K by ldmatrix, V by ldmatrix.trans; P is rounded to bf16
//            for P V (the row sums stay fp32).  KT = 64.
//   float32: the same tiling with SIMT FMA products from shared memory,
//            exact float32 (no TF32).  KT = 32.
// Head sizes 32, 64, 80, 96, 128 and 160 are built.  The largest keeps
// 80 accumulator floats and (bf16) 40 Q fragment registers a thread:
// 203 registers in bf16 and 185 in float32, no spills (ptxas, sm_90a),
// and ~87 KB (bf16) or ~128 KB (float32) of shared memory a block.
// A row whose valid positions lie in one split is written by that
// split's block; a row spanning several splits writes an fp32 partial
// (max, sum, unnormalised accumulator) per split, and a second small
// kernel merges them.  Rows with no valid position write zeros.
//
// What a later PR could still do: shorten each block's latency chain
// (its index reads, the query tile's load and the cross-warp merge take
// about as long as four K/V tiles at decode), fold the merge into the
// last split's block (one launch instead of two), choose the split from
// the shapes (a long table beside many rows makes T * KV * splits blocks,
// at most three resident per SM in bf16, most of which only read their
// indices and exit; a block could walk several splits instead), and
// wgmma on 64-row query tiles for long prefill chunks.

#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 64;      // query rows (token x query head) per tile
constexpr int kStages = 2;     // K/V tiles in the copy ring
// context tokens per split (grid.z); paged_attention.plan's SPLIT, which
// sizes the grid and the split scratch, is the same number
constexpr int kSplit = 256;
constexpr int kSmemLimit = 227 * 1024;  // dynamic shared memory per block
constexpr float kLog2e = 1.4426950408889634f;

template <typename T> struct Tile;
// tokens per K/V tile, and the row padding (16 bytes) that keeps
// ldmatrix and the float4 reads free of bank conflicts
template <> struct Tile<bf16> {
  static constexpr int kKeys = 64;
  static constexpr int kPad = 8;
};
template <> struct Tile<float> {
  static constexpr int kKeys = 32;
  static constexpr int kPad = 4;
};

// Shared memory: row metadata (each row's [lo, hi), 8 scalars, a bit per
// key of the split and the split's table entries, at most kSplit + 2),
// then (float32) the query tile, then the stages of K and V tiles.
__host__ __device__ constexpr int meta_bytes() {
  return (4 * (2 * kRows + 8) + 4 * (kSplit / 32) + 4 * (kSplit + 2) +
          127) / 128 * 128;
}
template <typename T, int HD>
__host__ __device__ constexpr int q_bytes() {
  return sizeof(T) == 4 ? kRows * (HD + Tile<T>::kPad) * 4 : 0;
}
template <typename T, int HD>
__host__ __device__ constexpr int kv_bytes() {
  return kStages * 2 * Tile<T>::kKeys * (HD + Tile<T>::kPad) *
         (int)sizeof(T);
}
template <typename T, int HD>
constexpr int smem_bytes() {
  return meta_bytes() + q_bytes<T, HD>() + kv_bytes<T, HD>();
}

template <typename T>
struct Args {
  const T* q;
  const T* k_pool;
  const T* v_pool;
  const int* block_tables;
  const int* req_rows;  // nullptr: row t reads table row t
  const int* q_lens;
  T* out;
  float* part_acc;  // (T, H, splits, hd), rows spanning several splits
  float* part_ml;   // (T, H, splits, 2): running max (log2 domain), sum
  int T_, H, KV, bs, nb, window, n_split;
  int bs_shift;           // log2 of the block size
  float scale_log2;       // 1 / sqrt(hd) * log2(e)
};

// ------------------------------------------------------------ primitives
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared (a shared-space address); !valid: zeros, and
// src is not read
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// d += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ------------------------------------------------- per-chunk products
// One 16-key chunk of one warp's 16-row slab, in the m16n8 C layout:
// lane (g = lane / 4, c = lane % 4) holds rows g and g + 8, keys
// 8 * nt + 2c and 8 * nt + 2c + 1 of the chunk (s[nt][0..1] row g,
// s[nt][2..3] row g + 8); acc[dt] likewise holds dims 8 * dt + 2c, +1.
template <int HD>
struct BF16Ops {
  uint32_t qf[HD / 16][4];  // the slab's Q as mma A fragments

  __device__ void load_q(const bf16* sq, int lane) {
    constexpr int LD = HD + Tile<bf16>::kPad;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      ldsm_x4(qf[ks], sq + (lane % 16) * LD + ks * 16 + (lane / 16) * 8);
  }
  __device__ void scores(float (&s)[2][4], const bf16* sk, int lane) const {
    constexpr int LD = HD + Tile<bf16>::kPad;
    const bf16* row =
        sk + ((lane / 16) * 8 + lane % 8) * LD + ((lane / 8) % 2) * 8;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t b[4];
      ldsm_x4(b, row + ks * 16);
      mma_bf16(s[0], qf[ks], b[0], b[1]);
      mma_bf16(s[1], qf[ks], b[2], b[3]);
    }
  }
  __device__ static void pv(float (&acc)[HD / 8][4], const float (&p)[2][4],
                            const bf16* sv, int lane) {
    constexpr int LD = HD + Tile<bf16>::kPad;
    const uint32_t a[4] = {pack_bf16(p[0][0], p[0][1]),
                           pack_bf16(p[0][2], p[0][3]),
                           pack_bf16(p[1][0], p[1][1]),
                           pack_bf16(p[1][2], p[1][3])};
    const bf16* row =
        sv + (((lane / 8) % 2) * 8 + lane % 8) * LD + (lane / 16) * 8;
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, row + dp * 16);
      mma_bf16(acc[2 * dp], a, b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
    }
  }
};

__device__ __forceinline__ float dot4(float4 x, float4 k, float acc) {
  return fmaf(x.x, k.x, fmaf(x.y, k.y, fmaf(x.z, k.z, fmaf(x.w, k.w, acc))));
}

template <int HD>
struct F32Ops {
  const float* sq;  // the slab's Q rows in shared memory

  __device__ void load_q(const float* q, int) { sq = q; }
  __device__ void scores(float (&s)[2][4], const float* sk, int lane) const {
    constexpr int LD = HD + Tile<float>::kPad;
    const int g = lane / 4, c = lane % 4;
    const float* qa = sq + g * LD;
    const float* qb = qa + 8 * LD;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 xa = *reinterpret_cast<const float4*>(qa + d);
      const float4 xb = *reinterpret_cast<const float4*>(qb + d);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 k = *reinterpret_cast<const float4*>(
              sk + (nt * 8 + 2 * c + e) * LD + d);
          s[nt][e] = dot4(xa, k, s[nt][e]);
          s[nt][2 + e] = dot4(xb, k, s[nt][2 + e]);
        }
    }
  }
  __device__ static void pv(float (&acc)[HD / 8][4], const float (&p)[2][4],
                            const float* sv, int lane) {
    constexpr int LD = HD + Tile<float>::kPad;
    const int c = lane % 4;
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      // the lane of this quad that holds key kk's probabilities
      const int src = (lane & ~3) | ((kk & 7) >> 1);
      const float pa = __shfl_sync(0xffffffffu, p[kk >> 3][kk & 1], src);
      const float pb = __shfl_sync(0xffffffffu, p[kk >> 3][2 + (kk & 1)], src);
      const float* vr = sv + kk * LD + 2 * c;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        const float2 v = *reinterpret_cast<const float2*>(vr + dt * 8);
        acc[dt][0] = fmaf(pa, v.x, acc[dt][0]);
        acc[dt][1] = fmaf(pa, v.y, acc[dt][1]);
        acc[dt][2] = fmaf(pb, v.x, acc[dt][2]);
        acc[dt][3] = fmaf(pb, v.y, acc[dt][3]);
      }
    }
  }
};

template <typename T, int HD> struct OpsOf;
template <int HD> struct OpsOf<bf16, HD> { using type = BF16Ops<HD>; };
template <int HD> struct OpsOf<float, HD> { using type = F32Ops<HD>; };

// ------------------------------------------------------------ main kernel
// One block per (packed row t, KV head, context split).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_attention_tile_kernel(const Args<T> a) {
  constexpr int KT = Tile<T>::kKeys, NS = kStages;
  constexpr int LD = HD + Tile<T>::kPad;
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int CPR = HD / EPC;        // copies per row
  constexpr int RS = HD + 8;            // merge scratch row (floats): the
  constexpr int SCR = 16 * RS + 32;     // padding spreads the float2 rows
  static_assert(4 * SCR * 4 <= kv_bytes<T, HD>(), "merge scratch");
  static_assert(kRows * CPR % kThreads == 0 && KT * CPR % kThreads == 0,
                "whole copy rounds");
  static_assert(2 * KT >= kRows || sizeof(T) == 4,
                "bf16 Q staging fits one stage");
  static_assert(HD % 16 == 0, "head size: whole 16-wide mma k steps");
  using Ops = typename OpsOf<T, HD>::type;

  extern __shared__ __align__(16) unsigned char smem[];
  int* s_lo = reinterpret_cast<int*>(smem);  // per tile row: valid keys
  int* s_hi = s_lo + kRows;                  // [lo, hi); hi == 0: none
  int* s_misc = s_hi + kRows;  // rows, tile lo, tile hi, any empty, request
  unsigned* s_valid = reinterpret_cast<unsigned*>(s_misc + 8);
  int* s_tab = reinterpret_cast<int*>(s_valid + kSplit / 32);
  T* s_q = reinterpret_cast<T*>(smem + meta_bytes());
  T* s_kv = reinterpret_cast<T*>(smem + meta_bytes() + q_bytes<T, HD>());

  const int t0 = blockIdx.x, kv = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.H / a.KV, M = kRows / G;
  const int* rr = a.req_rows;

  // ---- the tile: rows t0 .. t0 + m - 1, and each row's valid keys.  The
  // predecessor's row, the rows that may share the tile and their lengths
  // are read at once: one memory latency.
  const int span = a.nb * a.bs;
  const int lim = rr != nullptr ? min(M - t0 % M, a.T_ - t0) : 1;
  const int req = tid < lim ? (rr != nullptr ? rr[t0 + tid] : t0) : -1;
  const int ql = tid < lim ? a.q_lens[t0 + tid] : 0;
  const int prev = rr != nullptr && t0 % M != 0 ? rr[t0 - 1] : -1;
  if (tid == 0) {
    s_misc[0] = lim;
    s_misc[1] = INT_MAX;
    s_misc[2] = 0;
    s_misc[3] = 0;
    s_misc[4] = req;
  }
  __syncthreads();
  const int req0 = s_misc[4];
  if (prev == req0) return;  // row t0 heads no tile
  if (tid > 0 && tid < lim && req != req0) atomicMin(&s_misc[0], tid);
  __syncthreads();
  const int m = s_misc[0];
  if (tid < m) {
    int hi = min(ql, span);
    int lo = a.window > 0 ? max(0, ql - a.window) : 0;
    if (hi <= lo) {
      lo = hi = 0;
      s_misc[3] = 1;
    }
    s_lo[tid] = lo;
    s_hi[tid] = hi;
    if (hi > 0) {
      atomicMin(&s_misc[1], lo);
      atomicMax(&s_misc[2], hi);
    }
  }
  __syncthreads();
  const size_t row_stride = (size_t)a.H * HD;  // one packed row of q/out
  T* out0 = a.out + (size_t)t0 * row_stride + (size_t)kv * G * HD;
  if (z == 0 && s_misc[3])  // rows with no valid key write zeros
    for (int e = tid; e < m * G * HD; e += kThreads) {
      const int r = e / (G * HD);
      if (s_hi[r] == 0)
        out0[(size_t)r * row_stride + (e - r * G * HD)] = from_f32<T>(0.f);
    }
  const int s0 = max(s_misc[1], z * kSplit);
  const int s1 = min(s_misc[2], (z + 1) * kSplit);
  if (s0 >= s1) return;

  // ---- the query tile: m * G rows, zero-filled to 64; bf16 stages it in
  // the ring's last stage, which its first use overwrites after the load
  const int rq = m * G;
  T* sq = sizeof(T) == 2 ? s_kv + (NS - 1) * 2 * KT * LD : s_q;
  const unsigned sq_u = smem_u32(sq);
#pragma unroll
  for (int i = 0; i < kRows * CPR / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int qr = c / CPR, part = c - qr * CPR;
    const bool ok = qr < rq;
    const int qt = qr / G;  // the row's token in the tile, and its head
    const T* src = a.q + (size_t)(t0 + qt) * row_stride +
                   (kv * G + qr - qt * G) * HD + part * EPC;
    cp_async16(sq_u + (qr * LD + part * EPC) * (int)sizeof(T), ok ? src : a.q,
               ok);
  }
  cp_async_commit();

  // ---- which keys of this split some row of the tile may read, and the
  // table entries of the blocks that hold them (read once, here, while
  // the query tile is in flight; the others are never read)
  for (int i = tid; i < kSplit; i += kThreads) {
    const int j = z * kSplit + i;
    bool ok = j >= s0 && j < s1;
    if (ok && a.window > 0) {
      ok = false;
      for (int r = 0; r < m; ++r) ok |= s_lo[r] <= j && j < s_hi[r];
    }
    const unsigned bits = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) s_valid[i >> 5] = bits;
  }
  const int* table = a.block_tables + (size_t)req0 * a.nb;
  const int tb0 = s0 >> a.bs_shift;
  for (int e = tid; e <= ((s1 - 1) >> a.bs_shift) - tb0; e += kThreads) {
    const int k0 = max(s0, (tb0 + e) << a.bs_shift);
    const int k1 = min(s1, (tb0 + e + 1) << a.bs_shift);
    bool need = a.window <= 0;  // no window: every key of [s0, s1) is valid
    for (int r = 0; r < m && !need; ++r) need = s_lo[r] < k1 && k0 < s_hi[r];
    s_tab[e] = need ? table[tb0 + e] : 0;
  }

  // each thread copies the same (row, 16 bytes) slots of every tile, so
  // the per-tile work is a table lookup and two copies per slot
  const int kt0 = s0 / KT * KT;
  const int ntiles = (s1 - kt0 + KT - 1) / KT;
  const T* kbase = a.k_pool + (size_t)kv * HD;
  const T* vbase = a.v_pool + (size_t)kv * HD;
  const size_t pool_row = (size_t)a.KV * HD;  // one token of the pool
  const unsigned skv_u = smem_u32(s_kv);
  auto load_tile = [&](int it) {
    const int j0 = kt0 + it * KT;
    // no window and the tile inside [s0, s1): every key is valid
    const bool all = a.window <= 0 && j0 >= s0 && j0 + KT <= s1;
    const unsigned sk = skv_u + (it % NS) * 2 * KT * LD * (int)sizeof(T);
#pragma unroll
    for (int i = 0; i < KT * CPR / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int jj = c / CPR, part = c - jj * CPR;
      const int j = j0 + jj, iv = j - z * kSplit;
      const bool ok = all || ((s_valid[iv >> 5] >> (iv & 31)) & 1u);
      const int row =
          ok ? (s_tab[(j >> a.bs_shift) - tb0] << a.bs_shift) + (j & (a.bs - 1))
             : 0;
      const size_t off = (size_t)row * pool_row + part * EPC;
      const unsigned d = sk + (jj * LD + part * EPC) * (int)sizeof(T);
      cp_async16(d, kbase + off, ok);
      cp_async16(d + KT * LD * (int)sizeof(T), vbase + off, ok);
    }
  };
  __syncthreads();  // s_valid, s_tab
  for (int it = 0; it < NS - 1; ++it) {
    if (it < ntiles) load_tile(it);
    cp_async_commit();
  }

  // ---- warp roles: slab ms of the query rows, key group kg of each tile
  const int wm = rq > 32 ? 4 : rq > 16 ? 2 : 1;
  const int wn = 4 / wm;
  const int ms = warp / wn, kg = warp % wn;
  const int g = lane / 4, c4 = lane % 4;
  const int qa = ms * 16 + g, qb = qa + 8;
  const int lo_a = qa < rq ? s_lo[qa / G] : 0;
  const int hi_a = qa < rq ? s_hi[qa / G] : 0;
  const int lo_b = qb < rq ? s_lo[qb / G] : 0;
  const int hi_b = qb < rq ? s_hi[qb / G] : 0;

  Ops ops;
  float acc[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  cp_async_wait<NS - 1>();  // the query tile has landed
  __syncthreads();
  ops.load_q(sq + ms * 16 * LD, lane);
  __syncthreads();  // bf16: the staging stage is free for its tile

  for (int it = 0; it < ntiles; ++it) {
    if (it + NS - 1 < ntiles) load_tile(it + NS - 1);
    cp_async_commit();
    cp_async_wait<NS - 1>();  // tile it has landed
    __syncthreads();
    const T* sk = s_kv + (it % NS) * 2 * KT * LD;
    const T* sv = sk + KT * LD;
    const int j0 = kt0 + it * KT;
    for (int kc = kg; kc < KT / 16; kc += wn) {
      const int jb = j0 + kc * 16 + 2 * c4;
      bool va[2][2], vb[2][2], any = false;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = jb + nt * 8 + e;
          va[nt][e] = lo_a <= j && j < hi_a;
          vb[nt][e] = lo_b <= j && j < hi_b;
          any |= va[nt][e] | vb[nt][e];
        }
      if (!__any_sync(0xffffffffu, any)) continue;
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      ops.scores(s, sk + kc * 16 * LD, lane);
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[nt][e] = va[nt][e] ? s[nt][e] * a.scale_log2 : -INFINITY;
          s[nt][2 + e] = vb[nt][e] ? s[nt][2 + e] * a.scale_log2 : -INFINITY;
          mx_a = fmaxf(mx_a, s[nt][e]);
          mx_b = fmaxf(mx_b, s[nt][2 + e]);
        }
      const float mn_a = fmaxf(m_a, quad_max(mx_a));
      const float mn_b = fmaxf(m_b, quad_max(mx_b));
      const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
      const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
      const float corr_a = exp2f(m_a - base_a), corr_b = exp2f(m_b - base_b);
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[nt][e] = exp2f(s[nt][e] - base_a);
          s[nt][2 + e] = exp2f(s[nt][2 + e] - base_b);
          sum_a += s[nt][e];
          sum_b += s[nt][2 + e];
        }
      l_a = l_a * corr_a + quad_sum(sum_a);
      l_b = l_b * corr_b + quad_sum(sum_b);
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        acc[dt][0] *= corr_a;
        acc[dt][1] *= corr_a;
        acc[dt][2] *= corr_b;
        acc[dt][3] *= corr_b;
      }
      Ops::pv(acc, s, sv + kc * 16 * LD, lane);
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }

  // ---- merge the key groups of each slab through shared memory
  float* scr = reinterpret_cast<float*>(s_kv);
  if (kg > 0) {
    float* w = scr + warp * SCR;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      store2(w + g * RS + dt * 8 + 2 * c4, acc[dt][0], acc[dt][1]);
      store2(w + (g + 8) * RS + dt * 8 + 2 * c4, acc[dt][2], acc[dt][3]);
    }
    if (c4 == 0) {
      w[16 * RS + g] = m_a;
      w[16 * RS + g + 8] = m_b;
      w[16 * RS + 16 + g] = l_a;
      w[16 * RS + 24 + g] = l_b;
    }
  }
  __syncthreads();
  if (kg > 0) return;
  for (int o = 1; o < wn; ++o) {
    const float* w = scr + (warp + o) * SCR;
    const float mo_a = w[16 * RS + g], mo_b = w[16 * RS + g + 8];
    const float mn_a = fmaxf(m_a, mo_a), mn_b = fmaxf(m_b, mo_b);
    const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float ca = exp2f(m_a - base_a), cb = exp2f(mo_a - base_a);
    const float da = exp2f(m_b - base_b), db = exp2f(mo_b - base_b);
    l_a = l_a * ca + w[16 * RS + 16 + g] * cb;
    l_b = l_b * da + w[16 * RS + 24 + g] * db;
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      const float2 xa =
          *reinterpret_cast<const float2*>(w + g * RS + dt * 8 + 2 * c4);
      const float2 xb =
          *reinterpret_cast<const float2*>(w + (g + 8) * RS + dt * 8 + 2 * c4);
      acc[dt][0] = acc[dt][0] * ca + xa.x * cb;
      acc[dt][1] = acc[dt][1] * ca + xa.y * cb;
      acc[dt][2] = acc[dt][2] * da + xb.x * db;
      acc[dt][3] = acc[dt][3] * da + xb.y * db;
    }
  }

  // ---- write: the row itself when this split is its only one, else
  // this split's partial for the merge kernel
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qr = half ? qb : qa;
    const int hi = half ? hi_b : hi_a, lo = half ? lo_b : lo_a;
    if (qr >= rq || hi == 0) continue;
    const int zlo = lo / kSplit, zhi = (hi - 1) / kSplit;
    if (z < zlo || z > zhi) continue;
    const int t = t0 + qr / G, h = kv * G + qr % G;
    const size_t th = (size_t)t * a.H + h;
    const float l = half ? l_b : l_a, mx = half ? m_b : m_a;
    if (zlo == zhi) {
      const float inv = 1.f / l;
      T* o = a.out + th * HD + 2 * c4;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt)
        store2(o + dt * 8, acc[dt][2 * half] * inv,
               acc[dt][2 * half + 1] * inv);
    } else {
      const size_t ps = th * a.n_split + z;
      float* o = a.part_acc + ps * HD + 2 * c4;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt)
        store2(o + dt * 8, acc[dt][2 * half], acc[dt][2 * half + 1]);
      if (c4 == 0) store2(a.part_ml + ps * 2, mx, l);
    }
  }
}

// ------------------------------------------------------------ merge kernel
// One block per (packed row, query head): combines the row's per-split
// partials when its valid keys span more than one split, a thread per
// output element.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_merge_kernel(const Args<T> a, int hd) {
  __shared__ float s_mx, s_inv;
  const int t = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int ql = a.q_lens[t];
  const int hi = min(ql, a.nb * a.bs);
  const int lo = a.window > 0 ? max(0, ql - a.window) : 0;
  if (hi <= lo) return;
  const int zlo = lo / kSplit, zhi = (hi - 1) / kSplit;
  if (zlo == zhi) return;
  const size_t th = (size_t)t * a.H + h;
  const float* ml = a.part_ml + th * a.n_split * 2;
  const float* acc = a.part_acc + th * a.n_split * hd;
  if (tid < 32) {
    float mx = -INFINITY;
    for (int z = zlo + tid; z <= zhi; z += 32) mx = fmaxf(mx, ml[2 * z]);
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float l = 0.f;
    for (int z = zlo + tid; z <= zhi; z += 32)
      l += exp2f(ml[2 * z] - mx) * ml[2 * z + 1];
    l = warp_sum(l);
    if (tid == 0) {
      s_mx = mx;
      s_inv = 1.f / l;
    }
  }
  __syncthreads();
  const float mx = s_mx;
  for (int d = tid; d < hd; d += kThreads) {
    float o = 0.f;
#pragma unroll 4
    for (int z = zlo; z <= zhi; ++z)
      o = fmaf(exp2f(ml[2 * z] - mx), acc[(size_t)z * hd + d], o);
    a.out[th * hd + d] = from_f32<T>(o * s_inv);
  }
}

template <typename T, int HD>
cudaError_t launch_hd(const Args<T>& a, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T, HD>();
  static_assert(smem <= kSmemLimit, "tile exceeds the shared memory");
  if constexpr (smem > 48 * 1024) {  // above the default: set it once
    static const cudaError_t set = cudaFuncSetAttribute(
        paged_attention_tile_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (set != cudaSuccess) return set;
  }
  dim3 grid(a.T_, a.KV, a.n_split);
  paged_attention_tile_kernel<T, HD><<<grid, kThreads, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return err;
  paged_attention_merge_kernel<T><<<dim3(a.T_, a.H), kThreads, 0, stream>>>(
      a, HD);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* block_tables, const int* req_rows,
                   const int* q_lens, void* out, void* part_acc,
                   void* part_ml, int T_, int H, int KV, int hd, int bs,
                   int nb, int window, float scale, cudaStream_t stream) {
  if (KV <= 0 || H % KV != 0 || H / KV > kRows || bs <= 0 ||
      (bs & (bs - 1)) != 0 || nb <= 0)
    return cudaErrorInvalidValue;
  Args<T> a;
  a.q = static_cast<const T*>(q);
  a.k_pool = static_cast<const T*>(k_pool);
  a.v_pool = static_cast<const T*>(v_pool);
  a.block_tables = block_tables;
  a.req_rows = req_rows;
  a.q_lens = q_lens;
  a.out = static_cast<T*>(out);
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.T_ = T_;
  a.H = H;
  a.KV = KV;
  a.bs = bs;
  a.nb = nb;
  a.window = window;
  a.n_split = (nb * bs + kSplit - 1) / kSplit;
  a.bs_shift = __builtin_ctz(bs);
  a.scale_log2 = scale * kLog2e;
  switch (hd) {
    case 32: return launch_hd<T, 32>(a, stream);
    case 64: return launch_hd<T, 64>(a, stream);
    case 80: return launch_hd<T, 80>(a, stream);
    case 96: return launch_hd<T, 96>(a, stream);
    case 128: return launch_hd<T, 128>(a, stream);
    case 160: return launch_hd<T, 160>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename... A>
int dispatch(int is_bf16, A... args) {
  if (is_bf16) return launch<bf16>(args...);
  return launch<float>(args...);
}

}  // namespace
}  // namespace repro_torch

// q (T, H, hd), pools (NB, bs, KV, hd), block_tables (R, nb), req_rows
// and q_lens (T,) int32 -> out (T, H, hd).  part_acc (T, H, splits, hd)
// and part_ml (T, H, splits, 2) float32 scratch, splits = ceil(nb * bs /
// 256) (unused when it is 1).
extern "C" int ragged_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* req_rows, const void* q_lens,
    void* out, void* part_acc, void* part_ml, int T, int H, int KV, int hd,
    int bs, int nb, int window, float scale, int is_bf16, void* stream) {
  return repro_torch::dispatch(
      is_bf16, q, k_pool, v_pool, static_cast<const int*>(block_tables),
      static_cast<const int*>(req_rows), static_cast<const int*>(q_lens), out,
      part_acc, part_ml, T, H, KV, hd, bs, nb, window, scale,
      static_cast<cudaStream_t>(stream));
}

// q (B, H, hd), pools (NB, bs, KV, hd), block_tables (B, nb) and
// lengths (B,) int32 -> out (B, H, hd): row b of the table is sequence
// b's, its causal length lengths[b]; rows with length 0 write zeros.
extern "C" int paged_attention(const void* q, const void* k_pool,
                               const void* v_pool, const void* block_tables,
                               const void* lengths, void* out, void* part_acc,
                               void* part_ml, int B, int H, int KV, int hd,
                               int bs, int nb, int window, float scale,
                               int is_bf16, void* stream) {
  return repro_torch::dispatch(
      is_bf16, q, k_pool, v_pool, static_cast<const int*>(block_tables),
      static_cast<const int*>(nullptr), static_cast<const int*>(lengths), out,
      part_acc, part_ml, B, H, KV, hd, bs, nb, window, scale,
      static_cast<cudaStream_t>(stream));
}
