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
// Query tiles come from the indices alone: a tile is a run of at most
// M = 64 / G (rounded down) consecutive packed rows with one req_rows
// value that does not cross a multiple of M (row t heads a tile when
// t % M == 0 or req_rows[t-1] != req_rows[t]), so a tile holds at most
// 64 query rows (token x query head of one KV head).  G = H / KV is any
// 1..64 (a row's token and head are found by division); when it does
// not divide 64 (3, 6, 12) the tile's rows from M * G to 63 are zeros
// that are never written.  A decode singleton is its own tile; a
// prefill chunk's rows share one pass over its K/V, each row with its
// own causal mask; rows of one request need not be contiguous (they only
// make more tiles).
//
// The launch: a work list built on the device.  Two kernels run on a
// grid that depends on the shapes alone (no length is read on the host,
// nothing syncs), so a step can be captured in a CUDA graph:
//   paged_attention_tile_kernel_plan, one block, reads req_rows, q_lens
//     and the window and writes the list of work items: one per (tile
//     that holds a valid key, KV head, piece of the tile's key range).
//     A tile's keys [lo, hi) are the union of its rows' valid positions.
//     The range is cut into pieces of `chunk` keys, chosen from the
//     call's valid keys: chunk >= KV * sum(hi - lo) / (2 * kGrid), so a
//     piece holds at most half of one block's share of the call, and a
//     range is cut only where the list would otherwise hold too few
//     items for the card's blocks, or one item longer than a block's
//     share (and past kItemKeys keys, which sizes the shared table).  A
//     tile of r query rows takes pieces of at least 16 r keys, so that
//     its partials stay small beside the K/V its pieces read.
//     Rows with no valid key and padded rows get no item.
//   paged_attention_tile_kernel, kGrid = 132 SMs x 2 blocks, persistent,
//     launched while the planner runs (programmatic dependent launch):
//     each block first writes zeros to the rows with no valid key (a run
//     of rows a block), waits for the planner, then takes items by
//     an atomic counter until it is empty.  An uncut item writes its
//     rows; a cut one writes an fp32 partial (max, sum, unnormalised
//     accumulator) per row, and the block that finishes a cut tile's
//     last piece (a counter per tile and KV head) merges its pieces in
//     the order of their keys and writes the rows.
// So no block is launched only to exit: the old grid of one block per
// (packed row, KV head, 256-token split) launched 262,144 blocks a layer
// at granite's serving bucket (T 1,024, a 512-block table), nearly all
// of which read two indices and left.  The list's capacity and the
// partial scratch come from the shapes (paged_attention.plan).  The
// planner also adds to a device counter of the wrapper's (items, cut
// items, blocks launched, blocks of the old grid), read off the step.
//
// An item reads the table entries of its key range once into shared
// memory, then stages its K/V rows in tiles of KT tokens by 16-byte
// cp.async through a ring of stages (the next tile loads while this one
// is computed); each thread copies the same (row, 16 bytes) slots of
// every tile, so a tile costs it a table lookup and two copies per
// slot.  A token that is valid for no row of the tile is zero-filled
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
// Head sizes 32, 64, 80, 96, 128 and 160 are built, each with ~90 KB
// (bf16) or ~130 KB (float32) of shared memory a block at hd 160.
//
// What a later PR could still do: wgmma on 64-row query tiles for long
// prefill chunks (a 64-token chunk at G = 4 makes four tiles that each
// read the chunk's whole context), a deeper copy ring or TMA, and a
// shorter latency chain per item at decode (the item's index reads, the
// query tile's load and the cross-warp merge take about as long as four
// K/V tiles there); the planner's one block could be folded into the
// previous layer's tail, since every layer of a step plans the same list.

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
// the tile kernel's grid: 132 SMs, 2 blocks each (paged_attention.GRID)
constexpr int kGrid = 132 * 2;
constexpr int kPlanThreads = 1024;  // the planner's one block
// the most keys one item reads (paged_attention.ITEM_KEYS), and the most
// table blocks it spans (ITEM_BLOCKS): at block size bs an item reads at
// most min(kItemKeys, kItemBlocks * bs) keys
constexpr int kItemKeys = 8192;
constexpr int kItemBlocks = 512;
constexpr int kMinCut = 128;  // the fewest keys of a cut piece (MIN_CUT)
constexpr int kCutAlign = 64;  // a piece's length is a multiple of this
// a cut tile's pieces hold at least this many keys per query row of the
// tile: a piece's partials (4 bytes a row and dimension, written and read
// once) stay within 1/8 of the K/V bytes it reads
constexpr int kRowKeys = 16;
constexpr int kOldSplit = 256;  // the old grid's split, for its count
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
// key of the item and the item's table entries), then (float32) the
// query tile, then the stages of K and V tiles.
__host__ __device__ constexpr int meta_bytes() {
  return (4 * (2 * kRows + 8) + 4 * (kItemKeys / 32) +
          4 * (kItemBlocks + 2) + 127) / 128 * 128;
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

// One work item, two int4 of the list: (first row, rows | KV head << 8,
// first key, end key), (piece, pieces, first partial row or -1, the cut
// tile's counter or -1).
struct Work {
  int* hdr;     // [0] items, [1] next item to take, [2] chunk, [3] tiles
  int4* tiles;  // the planner's tiles: (first row, rows, lo, hi)
  int4* items;  // 2 per item
  int* done;    // per cut tile and KV head: pieces finished
};
__host__ __device__ inline Work work_at(int* base, int T_, int items) {
  Work w;
  w.hdr = base;
  w.tiles = reinterpret_cast<int4*>(base + 8);
  w.items = reinterpret_cast<int4*>(base + 8 + 4 * T_);
  w.done = base + 8 + 4 * T_ + 8 * items;
  return w;
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
  float* part_acc;  // (rows, hd): cut items' partial rows
  float* part_ml;   // (rows, 2): running max (log2 domain), sum
  Work work;
  int T_, H, KV, bs, nb, window;
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

// ------------------------------------------------------------ the planner
struct PlanArgs {
  const int* req_rows;  // nullptr: row t is its own request
  const int* q_lens;
  Work work;
  unsigned long long* counts;  // items, cut items, blocks, old grid's blocks
  unsigned long long old_blocks;
  int T_, KV, G, span, window;
  int cap;   // the most keys of one item
  int grid;  // the tile kernel's blocks
};

// exclusive prefix sum of v over the planner's block, and its total
__device__ int block_scan(int v, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = s_warp[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  const int ex = x - v + (warp > 0 ? s_warp[warp - 1] : 0);
  total = s_warp[kPlanThreads / 32 - 1];
  __syncthreads();
  return ex;
}

__device__ long long block_sum(long long v, long long* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  long long total = 0;
  for (int w = 0; w < kPlanThreads / 32; ++w) total += s_warp[w];
  __syncthreads();
  return total;
}

// One block of kPlanThreads.  Pass 1 finds the tiles (kPlanThreads / M
// whole tiles of rows at a time) with their key ranges and the call's
// valid keys; pass 2 cuts each tile's range into pieces of `chunk` keys
// and writes one item per (piece, KV head), a tile's pieces in the
// order of their keys, the KV heads of a piece next to each other.
__global__ void __launch_bounds__(kPlanThreads)
paged_attention_tile_kernel_plan(const PlanArgs p) {
  __shared__ int s_a[kPlanThreads], s_b[kPlanThreads], s_c[kPlanThreads],
      s_d[kPlanThreads], s_np[kPlanThreads], s_off[kPlanThreads],
      s_row[kPlanThreads], s_cut[kPlanThreads], s_len[kPlanThreads];
  __shared__ int s_warp[32];
  __shared__ long long s_sum[32];
  // the tile kernel may start now: it waits (griddepcontrol.wait) for
  // this grid to finish before it reads the list
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int tid = threadIdx.x;
  const int M = kRows / p.G;
  const int C = kPlanThreads / M * M;
  const int* rr = p.req_rows;

  // ---- pass 1: tiles, each with the union [lo, hi) of its rows' keys
  int n_tiles = 0;
  long long keys = 0;
  for (int base = 0; base < p.T_; base += C) {
    const int t = base + tid;
    const bool in = tid < C && t < p.T_;
    int r = -1, lo = 0, hi = 0;
    if (in) {
      r = rr != nullptr ? rr[t] : t;
      const int ql = p.q_lens[t];
      hi = min(ql, p.span);
      lo = p.window > 0 ? max(0, ql - p.window) : 0;
      if (hi <= lo) lo = hi = 0;
    }
    s_a[tid] = r;
    s_b[tid] = lo;
    s_c[tid] = hi;
    __syncthreads();
    int m = 0, tlo = INT_MAX, thi = 0;
    // base is a multiple of M, so the first row of a pass heads a tile
    if (in && (t % M == 0 || s_a[tid - 1] != r)) {
      const int end = min(min(C, p.T_ - base), tid + M - t % M);
      for (m = 1; tid + m < end && s_a[tid + m] == r; ++m) {
      }
      for (int i = tid; i < tid + m; ++i)
        if (s_c[i] > 0) {
          tlo = min(tlo, s_b[i]);
          thi = max(thi, s_c[i]);
        }
    }
    int n;
    const int at = block_scan(thi > 0, s_warp, n);
    if (thi > 0) p.work.tiles[n_tiles + at] = make_int4(t, m, tlo, thi);
    keys += block_sum(thi > 0 ? thi - tlo : 0, s_sum);
    n_tiles += n;
  }

  // ---- the cut: a piece holds at most half of one block's share of the
  // call's keys (whole kCutAlign runs, at least kMinCut), and at most cap;
  // a tile of many query rows takes longer pieces (kRowKeys)
  long long share = (keys * p.KV + 2 * p.grid - 1) / (2 * p.grid);
  share = max(share, (long long)kMinCut);
  share = (share + kCutAlign - 1) / kCutAlign * kCutAlign;
  const int chunk = (int)min(share, (long long)p.cap);

  // ---- pass 2: the items
  int n_pieces = 0, n_cut = 0, n_rows = 0;
  long long cut_pieces = 0;
  for (int base = 0; base < n_tiles; base += kPlanThreads) {
    const int j = base + tid;
    int4 tl = make_int4(0, 0, 0, 0);
    if (j < n_tiles) tl = p.work.tiles[j];
    const int rq = tl.y * p.G;
    // the tile's piece: the call's chunk, and kRowKeys keys a query row
    const int len = min(p.cap, max(chunk, (rq * kRowKeys + kCutAlign - 1) /
                                              kCutAlign * kCutAlign));
    const int np = j < n_tiles ? (tl.w - tl.z + len - 1) / len : 0;
    const bool cut = np > 1;
    int tp, tc, tr;
    const int off = block_scan(np, s_warp, tp);
    const int coff = block_scan(cut, s_warp, tc);
    const int roff = block_scan(cut ? np * p.KV * rq : 0, s_warp, tr);
    cut_pieces += block_sum(cut ? np : 0, s_sum);
    s_a[tid] = tl.x;
    s_b[tid] = tl.y;
    s_c[tid] = tl.z;
    s_d[tid] = tl.w;
    s_np[tid] = np;
    s_len[tid] = len;
    s_off[tid] = off;
    s_row[tid] = cut ? n_rows + roff : -1;
    s_cut[tid] = cut ? n_cut + coff : -1;
    if (cut)
      for (int kv = 0; kv < p.KV; ++kv)
        p.work.done[(n_cut + coff) * p.KV + kv] = 0;
    __syncthreads();
    const int nt = min(kPlanThreads, n_tiles - base);
    for (int it = tid; it < tp * p.KV; it += kPlanThreads) {
      const int piece = it / p.KV, kv = it - piece * p.KV;
      int lo = 0, hi = nt - 1;  // the last tile whose first piece <= piece
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (s_off[mid] <= piece) lo = mid;
        else hi = mid - 1;
      }
      const int i = piece - s_off[lo];
      const int k0 = s_c[lo] + i * s_len[lo];
      const int item = (n_pieces + piece) * p.KV + kv;
      p.work.items[2 * item] = make_int4(s_a[lo], s_b[lo] | kv << 8, k0,
                                         min(s_d[lo], k0 + s_len[lo]));
      p.work.items[2 * item + 1] = make_int4(
          i, s_np[lo],
          s_row[lo] < 0 ? -1 : s_row[lo] + (i * p.KV + kv) * s_b[lo] * p.G,
          s_cut[lo] < 0 ? -1 : s_cut[lo] * p.KV + kv);
    }
    n_pieces += tp;
    n_cut += tc;
    n_rows += tr;
    __syncthreads();
  }
  if (tid == 0) {
    p.work.hdr[0] = n_pieces * p.KV;
    p.work.hdr[1] = 0;
    p.work.hdr[2] = chunk;
    p.work.hdr[3] = n_tiles;
    atomicAdd(&p.counts[0], (unsigned long long)n_pieces * p.KV);
    atomicAdd(&p.counts[1], (unsigned long long)cut_pieces * p.KV);
    atomicAdd(&p.counts[2], (unsigned long long)p.grid + 1);
    atomicAdd(&p.counts[3], p.old_blocks);
  }
}

// ------------------------------------------------------------ tile kernel
// kGrid persistent blocks: zeros for the rows with no valid key, then
// items from the list until it is empty.
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
  static_assert(kThreads <= kItemBlocks + 2, "zero flags fit the table");
  using Ops = typename OpsOf<T, HD>::type;

  extern __shared__ __align__(16) unsigned char smem[];
  int* s_lo = reinterpret_cast<int*>(smem);  // per tile row: valid keys
  int* s_hi = s_lo + kRows;                  // [lo, hi); hi == 0: none
  int* s_misc = s_hi + kRows;  // the next item, whether this piece is last
  unsigned* s_valid = reinterpret_cast<unsigned*>(s_misc + 8);
  int* s_tab = reinterpret_cast<int*>(s_valid + kItemKeys / 32);
  T* s_q = reinterpret_cast<T*>(smem + meta_bytes());
  T* s_kv = reinterpret_cast<T*>(smem + meta_bytes() + q_bytes<T, HD>());

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.H / a.KV;
  const int* rr = a.req_rows;
  const int span = a.nb * a.bs;
  const size_t row_stride = (size_t)a.H * HD;  // one packed row of q/out

  // ---- rows with no valid key write zeros: a run of rows a block
  {
    const int per = (a.T_ + gridDim.x - 1) / gridDim.x;
    const int r0 = blockIdx.x * per, r1 = min(a.T_, r0 + per);
    const int vec = (int)(row_stride * sizeof(T) / 16);
    uint4* out16 = reinterpret_cast<uint4*>(a.out);
    for (int b = r0; b < r1; b += kThreads) {
      const int t = b + tid;
      bool empty = false;
      if (t < r1) {
        const int ql = a.q_lens[t];
        empty = min(ql, span) <= (a.window > 0 ? max(0, ql - a.window) : 0);
      }
      s_tab[tid] = empty;
      __syncthreads();
      const int n = min(kThreads, r1 - b);
      for (int e = tid; e < n * vec; e += kThreads) {
        const int i = e / vec;
        if (s_tab[i])
          out16[(size_t)(b + i) * vec + (e - i * vec)] = make_uint4(0, 0, 0, 0);
      }
      __syncthreads();
    }
  }

  // the planner's list: launched while the planner ran, the block waits
  // for it here (programmatic dependent launch)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int n_items = a.work.hdr[0];
  if (tid == 0) s_misc[0] = atomicAdd(&a.work.hdr[1], 1);
  __syncthreads();
  for (int cur = s_misc[0]; cur < n_items; cur = s_misc[0]) {
    int nxt = 0;  // the next item, taken while this one runs
    if (tid == 0) nxt = atomicAdd(&a.work.hdr[1], 1);
    const int4 ia = a.work.items[2 * cur], ib = a.work.items[2 * cur + 1];
    const int t0 = ia.x, m = ia.y & 0xff, kv = ia.y >> 8;
    const int s0 = ia.z, s1 = ia.w;  // the item's keys
    const int np = ib.y;             // the tile's pieces (1: not cut)

    // ---- the tile's rows t0 .. t0 + m - 1 and each row's valid keys
    if (tid < m) {
      const int ql = a.q_lens[t0 + tid];
      int hi = min(ql, span);
      int lo = a.window > 0 ? max(0, ql - a.window) : 0;
      if (hi <= lo) lo = hi = 0;
      s_lo[tid] = lo;
      s_hi[tid] = hi;
    }
    const int req0 = rr != nullptr ? rr[t0] : t0;

    // ---- the query tile: m * G rows, zero-filled to 64; bf16 stages it
    // in the ring's last stage, which its first use overwrites after the
    // load
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
      cp_async16(sq_u + (qr * LD + part * EPC) * (int)sizeof(T),
                 ok ? src : a.q, ok);
    }
    cp_async_commit();
    __syncthreads();  // s_lo, s_hi

    // ---- which keys of the item some row of the tile may read (with a
    // window), and the table entries of the blocks that hold them (read
    // once, here, while the query tile is in flight; the others are
    // never read)
    const int nk32 = (s1 - s0 + 31) / 32 * 32;
    if (a.window > 0)
      for (int b = 0; b < nk32; b += kThreads) {
        const int i = b + tid;
        const int j = s0 + i;
        bool ok = false;
        if (j < s1)
          for (int r = 0; r < m; ++r) ok |= s_lo[r] <= j && j < s_hi[r];
        const unsigned bits = __ballot_sync(0xffffffffu, ok);
        if (lane == 0 && i < nk32) s_valid[i >> 5] = bits;
      }
    const int* table = a.block_tables + (size_t)req0 * a.nb;
    const int tb0 = s0 >> a.bs_shift;
    for (int e = tid; e <= ((s1 - 1) >> a.bs_shift) - tb0; e += kThreads) {
      const int k0 = max(s0, (tb0 + e) << a.bs_shift);
      const int k1 = min(s1, (tb0 + e + 1) << a.bs_shift);
      bool need = a.window <= 0;  // no window: every key of [s0, s1) is valid
      for (int r = 0; r < m && !need; ++r)
        need = s_lo[r] < k1 && k0 < s_hi[r];
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
        const int j = j0 + jj, iv = j - s0;
        const bool ok =
            all || (j >= s0 && j < s1 &&
                    (a.window <= 0 || ((s_valid[iv >> 5] >> (iv & 31)) & 1u)));
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
            va[nt][e] = lo_a <= j && j < hi_a && j >= s0 && j < s1;
            vb[nt][e] = lo_b <= j && j < hi_b && j >= s0 && j < s1;
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
    if (kg == 0) {
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
          const float2 xb = *reinterpret_cast<const float2*>(
              w + (g + 8) * RS + dt * 8 + 2 * c4);
          acc[dt][0] = acc[dt][0] * ca + xa.x * cb;
          acc[dt][1] = acc[dt][1] * ca + xa.y * cb;
          acc[dt][2] = acc[dt][2] * da + xb.x * db;
          acc[dt][3] = acc[dt][3] * da + xb.y * db;
        }
      }

      // ---- write: the rows themselves when the tile is not cut, else
      // this piece's partial rows for the merge
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int qr = half ? qb : qa;
        const int hi = half ? hi_b : hi_a;
        if (qr >= rq || hi == 0) continue;
        const float l = half ? l_b : l_a, mx = half ? m_b : m_a;
        if (np == 1) {
          const size_t th = (size_t)(t0 + qr / G) * a.H + kv * G + qr % G;
          const float inv = 1.f / l;
          T* o = a.out + th * HD + 2 * c4;
#pragma unroll
          for (int dt = 0; dt < HD / 8; ++dt)
            store2(o + dt * 8, acc[dt][2 * half] * inv,
                   acc[dt][2 * half + 1] * inv);
        } else {
          const size_t row = (size_t)ib.z + qr;
          float* o = a.part_acc + row * HD + 2 * c4;
#pragma unroll
          for (int dt = 0; dt < HD / 8; ++dt)
            store2(o + dt * 8, acc[dt][2 * half], acc[dt][2 * half + 1]);
          if (c4 == 0) store2(a.part_ml + row * 2, mx, l);
        }
      }
    }

    // ---- a cut tile: the block that finishes its last piece merges the
    // pieces' partials, in the order of their keys: a thread a row for
    // the max and sum, then each thread 8 float4 units (row, 4 dims) at a
    // time, their reads of a piece in flight together
    if (np > 1) {
      __threadfence();
      __syncthreads();
      if (tid == 0) s_misc[1] = atomicAdd(&a.work.done[ib.w], 1) == np - 1;
      __syncthreads();
      if (s_misc[1]) {
        __threadfence();
        const int stride = a.KV * rq;  // partial rows between two pieces
        const size_t first = (size_t)ib.z - (size_t)ib.x * stride;
        float* s_mx = scr;  // per row: the pieces' max, then 1 / sum
        float* s_inv = scr + kRows;
        if (tid < rq) {
          float mx = -INFINITY, l = 0.f;
          if (s_hi[tid / G] > 0) {
            const float2* ml = reinterpret_cast<const float2*>(a.part_ml);
#pragma unroll 4
            for (int i = 0; i < np; ++i)
              mx = fmaxf(mx, __ldcg(ml + first + (size_t)i * stride + tid).x);
#pragma unroll 4
            for (int i = 0; i < np; ++i) {
              const float2 v = __ldcg(ml + first + (size_t)i * stride + tid);
              l += exp2f(v.x - mx) * v.y;
            }
          }
          s_mx[tid] = mx;
          s_inv[tid] = 1.f / l;
        }
        __syncthreads();
        constexpr int HU = HD / 4;  // units a row
        constexpr int kBatch = 8;
        for (int u0 = tid; u0 < rq * HU; u0 += kBatch * kThreads) {
          float4 o[kBatch];
#pragma unroll
          for (int j = 0; j < kBatch; ++j)
            o[j] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
          for (int i = 0; i < np; ++i) {
            const size_t base = first + (size_t)i * stride;
#pragma unroll
            for (int j = 0; j < kBatch; ++j) {
              const int u = u0 + j * kThreads, r = u / HU;
              if (u < rq * HU && s_hi[r / G] > 0) {
                const float w =
                    exp2f(__ldcg(a.part_ml + (base + r) * 2) - s_mx[r]);
                const float4 x = __ldcg(
                    reinterpret_cast<const float4*>(a.part_acc +
                                                    (base + r) * HD) +
                    (u - r * HU));
                o[j].x = fmaf(w, x.x, o[j].x);
                o[j].y = fmaf(w, x.y, o[j].y);
                o[j].z = fmaf(w, x.z, o[j].z);
                o[j].w = fmaf(w, x.w, o[j].w);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            const int u = u0 + j * kThreads, r = u / HU;
            if (u < rq * HU && s_hi[r / G] > 0) {
              const float inv = s_inv[r];
              T* dst = a.out +
                       ((size_t)(t0 + r / G) * a.H + kv * G + r % G) * HD +
                       4 * (u - r * HU);
              store2(dst, o[j].x * inv, o[j].y * inv);
              store2(dst + 2, o[j].z * inv, o[j].w * inv);
            }
          }
        }
      }
    }
    __syncthreads();
    if (tid == 0) s_misc[0] = nxt;
    __syncthreads();
  }
}

template <typename T, int HD>
cudaError_t launch_hd(const Args<T>& a, const PlanArgs& p,
                      cudaStream_t stream) {
  constexpr int smem = smem_bytes<T, HD>();
  static_assert(smem <= kSmemLimit, "tile exceeds the shared memory");
  if constexpr (smem > 48 * 1024) {  // above the default: set it once
    static const cudaError_t set = cudaFuncSetAttribute(
        paged_attention_tile_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (set != cudaSuccess) return set;
  }
  paged_attention_tile_kernel_plan<<<1, kPlanThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the tile kernel starts while the planner runs (its zeros do not need
  // the list): programmatic dependent launch
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, paged_attention_tile_kernel<T, HD>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* block_tables, const int* req_rows,
                   const int* q_lens, void* out, void* work, void* part_acc,
                   void* part_ml, void* counts, int T_, int H, int KV,
                   int hd, int bs, int nb, int window, float scale, int grid,
                   int items, cudaStream_t stream) {
  if (KV <= 0 || H % KV != 0 || H / KV > kRows || bs <= 0 ||
      (bs & (bs - 1)) != 0 || nb <= 0 || grid <= 0 || grid > kGrid ||
      items <= 0)
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
  a.work = work_at(static_cast<int*>(work), T_, items);
  a.T_ = T_;
  a.H = H;
  a.KV = KV;
  a.bs = bs;
  a.nb = nb;
  a.window = window;
  a.bs_shift = __builtin_ctz(bs);
  a.scale_log2 = scale * kLog2e;
  PlanArgs p;
  p.req_rows = req_rows;
  p.q_lens = q_lens;
  p.work = a.work;
  p.counts = static_cast<unsigned long long*>(counts);
  const unsigned long long splits = (nb * bs + kOldSplit - 1) / kOldSplit;
  p.old_blocks = (unsigned long long)T_ * KV * splits +
                 (splits > 1 ? (unsigned long long)T_ * H : 0);
  p.T_ = T_;
  p.KV = KV;
  p.G = H / KV;
  p.span = nb * bs;
  p.window = window;
  p.cap = kItemKeys < kItemBlocks * bs ? kItemKeys : kItemBlocks * bs;
  p.grid = grid;
  switch (hd) {
    case 32: return launch_hd<T, 32>(a, p, stream);
    case 64: return launch_hd<T, 64>(a, p, stream);
    case 80: return launch_hd<T, 80>(a, p, stream);
    case 96: return launch_hd<T, 96>(a, p, stream);
    case 128: return launch_hd<T, 128>(a, p, stream);
    case 160: return launch_hd<T, 160>(a, p, stream);
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
// and q_lens (T,) int32 -> out (T, H, hd).  work: int32 scratch of
// 8 + 4 T + 8 items + KV T (the work list of at most `items` items);
// part_acc (rows, hd) and part_ml (rows, 2) float32 scratch of the cut
// items; counts: 4 uint64 the planner adds to; grid: the tile kernel's
// blocks (paged_attention.plan gives all of these from the shapes).
extern "C" int ragged_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* req_rows, const void* q_lens,
    void* out, void* work, void* part_acc, void* part_ml, void* counts,
    int T, int H, int KV, int hd, int bs, int nb, int window, float scale,
    int grid, int items, int is_bf16, void* stream) {
  return repro_torch::dispatch(
      is_bf16, q, k_pool, v_pool, static_cast<const int*>(block_tables),
      static_cast<const int*>(req_rows), static_cast<const int*>(q_lens), out,
      work, part_acc, part_ml, counts, T, H, KV, hd, bs, nb, window, scale,
      grid, items, static_cast<cudaStream_t>(stream));
}

// q (B, H, hd), pools (NB, bs, KV, hd), block_tables (B, nb) and
// lengths (B,) int32 -> out (B, H, hd): row b of the table is sequence
// b's, its causal length lengths[b]; rows with length 0 write zeros.
// The scratch and counts as for ragged_paged_attention.
extern "C" int paged_attention(const void* q, const void* k_pool,
                               const void* v_pool, const void* block_tables,
                               const void* lengths, void* out, void* work,
                               void* part_acc, void* part_ml, void* counts,
                               int B, int H, int KV, int hd, int bs, int nb,
                               int window, float scale, int grid, int items,
                               int is_bf16, void* stream) {
  return repro_torch::dispatch(
      is_bf16, q, k_pool, v_pool, static_cast<const int*>(block_tables),
      static_cast<const int*>(nullptr), static_cast<const int*>(lengths), out,
      work, part_acc, part_ml, counts, B, H, KV, hd, bs, nb, window, scale,
      grid, items, static_cast<cudaStream_t>(stream));
}
