// Ragged grouped-LoRA delta (SGMV) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ragged_lora.py::ragged_grouped_lora
// (body _ragged_lora_kernel, padding wrapper ragged_grouped_lora_padded):
//
//   delta[t] = (x[t] @ A[s_t]) @ B[s_t]  if s_t > 0 and s_t in active_slots
//            = 0 (exactly)               otherwise
//
// for up to three (A, B) pairs that share x and the slot list (the Q, K
// and V deltas of one attention layer) in one pair of launches.
//
// What bounds it on this card.  Bytes: each active slot's A (d x r) and
// B (r x out) read once, x read once and the delta written once, against
// 2 r (d + out) operations per adapted row -- far below the tensor
// cores' ~295 operations per byte.  A serving step (T <= 128) moves a
// few MB, so what sets the time is latency: how many blocks are in
// flight, and how long each one's chain of copies is.
//
// Design.  Two kernels, launched back to back on the caller's stream.
//   shrink  grid (token tiles, d splits, pairs).  A block owns a tile of
//           kRows = 16 packed rows (the mma M) and a split of d (128 to
//           512 columns, chosen from the shapes by ragged_lora.plan so
//           that a decode step still makes tens of blocks).  It keeps the
//           tile's x split in shared memory and, for each active slot
//           that some row of the tile is on (a ballot over the tile's
//           adapter_idx), streams A[s]'s rows of the split through a
//           two-stage cp.async ring: A is read once per (token tile,
//           slot), not once per token.  Rows on other slots enter the
//           product as zeros, as the TPU kernel's mask does.  The fp32
//           partial x . A of the split goes to the scratch (splits, T,
//           pairs * r).
//   expand  grid (output tiles of kOutTile columns over all pairs, token
//           tiles).  The prologue sums the tile's split partials in split
//           order (deterministic, no atomics) and rounds them once to x's
//           dtype, the TPU kernel's xa.astype(x.dtype); then, for each
//           active slot the tile uses, B[s]'s columns of the tile stream
//           through a two-stage ring and the delta accumulates in fp32,
//           rounded once at the end.  A tile none of whose rows is on an
//           active slot writes zeros and reads nothing else.
// bf16 runs both products on mma.sync.m16n8k16 (fp32 accumulators,
// operands by ldmatrix); float32 uses the same fragment layout with SIMT
// FMAs, exact float32 (no TF32).  Rank 8 is padded to 16 with zeros in
// shared memory.  Both kernels mask their own edges, so T and the output
// widths need no padding.  Slot 0, slots not in the list and rows past T
// are never read.

#include "async_mma.cuh"

namespace repro_torch {
namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;       // 4 warps
constexpr int kRows = 16;           // packed rows per token tile (mma M)
constexpr int kOutTile = 128;       // expand: output columns per block
constexpr int kMaxPairs = 3;        // (A, B) pairs per launch: Q, K and V
constexpr int kStageBytes = 16384;  // shrink: bytes of A per ring stage
constexpr int kSplitStep = 64;      // the d split is a multiple of this ...
constexpr int kMaxSplit = 512;      // ... and at most this
// dynamic shared memory per block: the card's 227 KB less room for the
// kernels' static tile lists
constexpr int kSmemLimit = 226 * 1024;

// row padding of the shared tiles, 16 bytes: keeps ldmatrix and the
// float2 reads free of bank conflicts
template <typename T> struct Pad;
template <> struct Pad<bf16> { static constexpr int v = 8; };
template <> struct Pad<float> { static constexpr int v = 4; };

template <typename T>
struct Pair {
  const T* a;   // (n_slots, d, r)
  const T* b;   // (n_slots, r, out_dim)
  T* out;       // (T, out_dim)
  int out_dim;
  int tile0;    // its first output tile (expand's blockIdx.x)
};

template <typename T>
struct Args {
  Pair<T> pair[kMaxPairs];
  const T* x;              // (T, d)
  const int* adapter_idx;  // (T,)
  const int* active;       // (K,)
  float* part;             // (n_split, T, n_pairs * r) fp32 scratch
  int T_, d, r, n_slots, K, n_pairs, split, n_split;
};

// rank columns in shared memory: rank 8 padded to one 16-wide mma k/n step
__host__ __device__ constexpr int rank_cols(int r) { return r < 16 ? 16 : r; }

template <typename T>
__device__ __forceinline__ Pair<T> pair_of(const Args<T>& a, int p) {
  return p == 0 ? a.pair[0] : p == 1 ? a.pair[1] : a.pair[2];
}

// The active slots that some row of the tile [t0, t0 + kRows) is on, in
// list order, each once (rows past T are on none).  Fills s_idx with the
// tile's rows' slots and s_slot with the slots; returns their count.
// Every thread calls it; it ends with a barrier.
__device__ int tile_slots(const int* __restrict__ idx,
                          const int* __restrict__ active, int t0, int T_,
                          int K, int n_slots, int* s_idx, int* s_slot,
                          int* s_n) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < 32) {
    const int mine = lane < kRows && t0 + lane < T_ ? idx[t0 + lane] : 0;
    if (lane < kRows) s_idx[lane] = mine;
    int n = 0;
    for (int i = 0; i < K; ++i) {
      const int s = active[i];          // the same for the whole warp
      if (s <= 0 || s >= n_slots) continue;
      if (__ballot_sync(0xffffffffu, lane < kRows && mine == s) == 0u)
        continue;
      bool seen = false;
      for (int j = 0; j < n; ++j) seen |= s_slot[j] == s;
      if (seen) continue;
      if (lane == 0) s_slot[n] = s;
      __syncwarp();
      ++n;
    }
    if (lane == 0) *s_n = n;
  }
  __syncthreads();
  return *s_n;
}

// ------------------------------------------------ one 16-deep k step
// The m16n8 C layout: lane (g = lane / 4, c = lane % 4) holds rows g and
// g + 8, columns 8 * nt + 2c and + 1 of each 8-column tile nt.  on_a /
// on_b: rows g / g + 8 are on the slot (else they enter as zeros).
// x is [row][k] (leading dimension ldx), w is [k][col] (ldw); the warp
// adds x . w to its NG 16-column groups of w, the group j at column
// cols[j] (acc[j][0] its first 8 columns, acc[j][1] the next 8).
template <int NG>
__device__ __forceinline__ void kstep(float (&acc)[NG][2][4], const bf16* x,
                                      int ldx, const bf16* w, int ldw,
                                      const int (&cols)[NG], bool on_a,
                                      bool on_b, int lane) {
  uint32_t af[4];
  ldsm_x4(af, x + (lane % 16) * ldx + (lane / 16) * 8);
  if (!on_a) af[0] = af[2] = 0u;
  if (!on_b) af[1] = af[3] = 0u;
  const bf16* row =
      w + (((lane / 8) % 2) * 8 + lane % 8) * ldw + (lane / 16) * 8;
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    uint32_t b[4];
    ldsm_x4_t(b, row + cols[j]);
    mma_bf16(acc[j][0], af, b[0], b[1]);
    mma_bf16(acc[j][1], af, b[2], b[3]);
  }
}

template <int NG>
__device__ __forceinline__ void kstep(float (&acc)[NG][2][4], const float* x,
                                      int ldx, const float* w, int ldw,
                                      const int (&cols)[NG], bool on_a,
                                      bool on_b, int lane) {
  const int g = lane >> 2, c = lane & 3;
  const float* xa = x + g * ldx;
  const float* xb = xa + 8 * ldx;
#pragma unroll 4
  for (int kk = 0; kk < 16; ++kk) {
    const float va = on_a ? xa[kk] : 0.f;
    const float vb = on_b ? xb[kk] : 0.f;
    const float* wr = w + kk * ldw + 2 * c;
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v = *reinterpret_cast<const float2*>(wr + cols[j] + 8 * h);
        acc[j][h][0] = fmaf(va, v.x, acc[j][h][0]);
        acc[j][h][1] = fmaf(va, v.y, acc[j][h][1]);
        acc[j][h][2] = fmaf(vb, v.x, acc[j][h][2]);
        acc[j][h][3] = fmaf(vb, v.y, acc[j][h][3]);
      }
  }
}

// ------------------------------------------------------------- shrink
// Grid (token tiles, splits, pairs).  The 4 warps split the rank's
// 16-column groups (wn = min(4, groups) ways, NJ groups each) and, when
// there are fewer than 4 groups, the k steps of each chunk (wk = 4 / wn
// ways); the k groups meet in shared memory at the end, in fixed order.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
lora_shrink_kernel(const Args<T> a) {
  constexpr int PAD = Pad<T>::v, EPC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_idx[kRows], s_slot[kRows], s_n;
  const int t0 = blockIdx.x * kRows, z = blockIdx.y;
  const int n = tile_slots(a.adapter_idx, a.active, t0, a.T_, a.K,
                           a.n_slots, s_idx, s_slot, &s_n);
  if (n == 0) return;  // the expand writes this tile's zeros
  const Pair<T> p = pair_of(a, blockIdx.z);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = a.r, RN = rank_cols(r);
  const int k0 = z * a.split, kn = min(a.split, a.d - k0);
  const int KC = min(a.split, kStageBytes / (RN * (int)sizeof(T)));
  const int n_chunk = (kn + KC - 1) / KC;
  const int LDX = a.split + PAD, LDA = RN + PAD;
  T* sx = reinterpret_cast<T*>(smem);  // kRows x LDX: x's split of the tile
  T* sa = sx + kRows * LDX;            // 2 stages of KC x LDA: A's rows
  const unsigned sx_u = smem_u32(sx), sa_u = smem_u32(sa);

  // x once, zeros past T and past d
  const int xcpr = a.split / EPC;  // 16-byte copies per row
  for (int c = tid; c < kRows * xcpr; c += kThreads) {
    const int row = c / xcpr, col = (c - row * xcpr) * EPC;
    const bool ok = t0 + row < a.T_ && col < kn;
    const T* src = a.x + (size_t)(t0 + row) * a.d + k0 + col;
    cp_async16(sx_u + (row * LDX + col) * (int)sizeof(T), ok ? src : a.x,
               ok);
  }
  // item it: slot it / n_chunk, chunk it % n_chunk of the split; rows
  // past the split and columns past r are zeros
  const int acpr = RN / EPC;
  auto load = [&](int it) {
    const int s = s_slot[it / n_chunk];
    const int kc0 = (it % n_chunk) * KC;
    const unsigned dst = sa_u + (it & 1) * KC * LDA * (int)sizeof(T);
    for (int c = tid; c < KC * acpr; c += kThreads) {
      const int row = c / acpr, col = (c - row * acpr) * EPC;
      const bool ok = kc0 + row < kn && col < r;
      const T* src = p.a + ((size_t)s * a.d + k0 + kc0 + row) * r + col;
      cp_async16(dst + (row * LDA + col) * (int)sizeof(T), ok ? src : p.a,
                 ok);
    }
  };
  load(0);
  cp_async_commit();

  const int groups = RN / 16;
  const int wn = min(4, groups), wk = 4 / wn;
  const int wcol = warp % wn, wkg = warp / wn;
  int cols[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) cols[j] = (wcol + wn * j) * 16;
  float acc[NJ][2][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      acc[j][h][0] = acc[j][h][1] = acc[j][h][2] = acc[j][h][3] = 0.f;
  const int g = lane >> 2, c4 = lane & 3;

  const int items = n * n_chunk;
  for (int it = 0; it < items; ++it) {
    if (it + 1 < items) load(it + 1);
    cp_async_commit();
    cp_async_wait<1>();  // item it (and x) has landed
    __syncthreads();
    const int s = s_slot[it / n_chunk];
    const bool on_a = s_idx[g] == s, on_b = s_idx[g + 8] == s;
    const int kc0 = (it % n_chunk) * KC;
    const int steps = (min(KC, kn - kc0) + 15) / 16;
    const T* st = sa + (it & 1) * KC * LDA;
    for (int ks = wkg; ks < steps; ks += wk)
      kstep<NJ>(acc, sx + kc0 + ks * 16, LDX, st + ks * 16 * LDA, LDA, cols,
                on_a, on_b, lane);
    __syncthreads();  // the stage is consumed before it is refilled
  }

  // the k groups of each column group meet in shared memory (the x tile
  // and the ring are free now), added in group order
  if (wk > 1) {
    float* red = reinterpret_cast<float*>(smem);
    constexpr int kPer = NJ * 8 * 32;  // floats per warp
    if (wkg > 0) {
      float* w = red + ((wkg - 1) * wn + wcol) * kPer;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) w[((j * 2 + h) * 4 + e) * 32 + lane] =
              acc[j][h][e];
    }
    __syncthreads();
    if (wkg > 0) return;
    for (int o = 1; o < wk; ++o) {
      const float* w = red + ((o - 1) * wn + wcol) * kPer;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[j][h][e] += w[((j * 2 + h) * 4 + e) * 32 + lane];
    }
  }

  const int pstride = a.n_pairs * r;
  float* dst = a.part + ((size_t)z * a.T_ + t0) * pstride + blockIdx.z * r;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = cols[j] + 8 * h + 2 * c4;
      if (col >= r) continue;
      if (t0 + g < a.T_)
        store2(dst + (size_t)g * pstride + col, acc[j][h][0], acc[j][h][1]);
      if (t0 + g + 8 < a.T_)
        store2(dst + (size_t)(g + 8) * pstride + col, acc[j][h][2],
               acc[j][h][3]);
    }
}

// ------------------------------------------------------------- expand
// Grid (output tiles of all pairs, token tiles); warp w owns the tile's
// columns 32 w .. 32 w + 31 (four 8-column mma tiles).  n_stages is 2,
// or 1 when two stages of B would not fit in shared memory (float32 at
// rank 256).
template <typename T>
__global__ void __launch_bounds__(kThreads)
lora_expand_kernel(const Args<T> a, int n_stages) {
  constexpr int PAD = Pad<T>::v, EPC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_idx[kRows], s_slot[kRows], s_n;
  const int bx = blockIdx.x, t0 = blockIdx.y * kRows;
  int pi = 0;
  while (pi + 1 < a.n_pairs && bx >= pair_of(a, pi + 1).tile0) ++pi;
  const Pair<T> p = pair_of(a, pi);
  const int o0 = (bx - p.tile0) * kOutTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = tile_slots(a.adapter_idx, a.active, t0, a.T_, a.K,
                           a.n_slots, s_idx, s_slot, &s_n);
  if (n == 0) {  // no row of the tile is on an active slot
    for (int e = tid; e < kRows * kOutTile / 2; e += kThreads) {
      const int row = e / (kOutTile / 2), col = o0 + (e % (kOutTile / 2)) * 2;
      if (t0 + row < a.T_ && col < p.out_dim)
        store2(p.out + (size_t)(t0 + row) * p.out_dim + col, 0.f, 0.f);
    }
    return;
  }
  const int r = a.r, RN = rank_cols(r);
  const int LDXA = RN + PAD, LDB = kOutTile + PAD;
  T* sxa = reinterpret_cast<T*>(smem);  // kRows x LDXA: x . A, rounded
  T* sb = sxa + kRows * LDXA;           // n_stages x RN x LDB: B's columns
  const unsigned sb_u = smem_u32(sb);
  constexpr int bcpr = kOutTile / EPC;  // 16-byte copies per row of B
  auto load = [&](int i) {
    const int s = s_slot[i];
    const unsigned dst = sb_u + (i % n_stages) * RN * LDB * (int)sizeof(T);
    for (int c = tid; c < RN * bcpr; c += kThreads) {
      const int k = c / bcpr, col = (c - k * bcpr) * EPC;
      const bool ok = k < r && o0 + col < p.out_dim;
      const T* src = p.b + ((size_t)s * r + k) * p.out_dim + o0 + col;
      cp_async16(dst + (k * LDB + col) * (int)sizeof(T), ok ? src : p.b, ok);
    }
  };
  load(0);
  cp_async_commit();

  // x . A of the tile: the split partials summed in split order and
  // rounded once; rows on no active slot of the tile are zeros, unread
  const size_t pstride = (size_t)a.n_pairs * r;
  const size_t zstride = (size_t)a.T_ * pstride;
  for (int e = tid; e < kRows * RN; e += kThreads) {
    const int row = e / RN, k = e - row * RN;
    const int s = s_idx[row];
    bool on = false;
    for (int i = 0; i < n; ++i) on |= s_slot[i] == s;
    float v = 0.f;
    if (on && k < r) {
      const float* src = a.part + (size_t)(t0 + row) * pstride + pi * r + k;
      for (int zz = 0; zz < a.n_split; ++zz) v += src[zz * zstride];
    }
    sxa[row * LDXA + k] = from_f32<T>(v);
  }

  const int g = lane >> 2, c4 = lane & 3;
  const int cols[2] = {warp * 32, warp * 32 + 16};
  float acc[2][2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      acc[j][h][0] = acc[j][h][1] = acc[j][h][2] = acc[j][h][3] = 0.f;
  for (int i = 0; i < n; ++i) {
    if (n_stages == 2 && i + 1 < n) load(i + 1);
    cp_async_commit();
    if (n_stages == 2)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // B of slot i has landed (and, at i = 0, x . A)
    const int s = s_slot[i];
    const bool on_a = s_idx[g] == s, on_b = s_idx[g + 8] == s;
    const T* st = sb + (i % n_stages) * RN * LDB;
    for (int ks = 0; ks < RN / 16; ++ks)
      kstep<2>(acc, sxa + ks * 16, LDXA, st + ks * 16 * LDB, LDB, cols, on_a,
               on_b, lane);
    __syncthreads();  // the stage is consumed before it is refilled
    if (n_stages == 1 && i + 1 < n) load(i + 1);
  }

#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = o0 + cols[j] + 8 * h + 2 * c4;
      if (col >= p.out_dim) continue;
      if (t0 + g < a.T_)
        store2(p.out + (size_t)(t0 + g) * p.out_dim + col, acc[j][h][0],
               acc[j][h][1]);
      if (t0 + g + 8 < a.T_)
        store2(p.out + (size_t)(t0 + g + 8) * p.out_dim + col, acc[j][h][2],
               acc[j][h][3]);
    }
}

// ------------------------------------------------------------- launch
template <typename K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemLimit);
}

template <typename T, int NJ>
cudaError_t launch_shrink(const Args<T>& a, int tiles, cudaStream_t st) {
  static const cudaError_t set = allow_smem(lora_shrink_kernel<T, NJ>);
  if (set != cudaSuccess) return set;
  const int RN = rank_cols(a.r);
  const int fit = kStageBytes / (RN * (int)sizeof(T));
  const int KC = a.split < fit ? a.split : fit;
  const size_t tiles_bytes =
      sizeof(T) * ((size_t)kRows * (a.split + Pad<T>::v) +
                   2 * (size_t)KC * (RN + Pad<T>::v));
  const size_t red_bytes = sizeof(float) * 3 * NJ * 8 * 32;
  const size_t smem = tiles_bytes > red_bytes ? tiles_bytes : red_bytes;
  lora_shrink_kernel<T, NJ>
      <<<dim3(tiles, a.n_split, a.n_pairs), kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args<T>& a, int tiles, int out_tiles,
                   cudaStream_t st) {
  const int r = a.r;
  if (r < 8 || r > 256 || (r & (r - 1)) != 0 || a.d % 8 != 0 ||
      a.n_pairs < 1 || a.n_pairs > kMaxPairs || a.split % kSplitStep != 0 ||
      a.split <= 0 || a.split > kMaxSplit)
    return cudaErrorInvalidValue;
  for (int i = 0; i < a.n_pairs; ++i)
    if (a.pair[i].out_dim <= 0 || a.pair[i].out_dim % 8 != 0)
      return cudaErrorInvalidValue;
  const int RN = rank_cols(r);
  cudaError_t err;
  switch (RN >= 64 ? RN / 64 : 1) {  // 16-column groups per warp
    case 1: err = launch_shrink<T, 1>(a, tiles, st); break;
    case 2: err = launch_shrink<T, 2>(a, tiles, st); break;
    default: err = launch_shrink<T, 4>(a, tiles, st); break;
  }
  if (err != cudaSuccess) return err;
  static const cudaError_t set = allow_smem(lora_expand_kernel<T>);
  if (set != cudaSuccess) return set;
  const size_t xa_bytes = sizeof(T) * kRows * (RN + Pad<T>::v);
  const size_t stage = sizeof(T) * (size_t)RN * (kOutTile + Pad<T>::v);
  const int n_stages = xa_bytes + 2 * stage <= (size_t)kSmemLimit ? 2 : 1;
  lora_expand_kernel<T><<<dim3(out_tiles, tiles), kThreads,
                          xa_bytes + n_stages * stage, st>>>(a, n_stages);
  return cudaGetLastError();
}

template <typename T>
int run(const void* x, const void* const (&ab)[2 * kMaxPairs],
        void* const (&out)[kMaxPairs], const int (&out_dim)[kMaxPairs],
        const int (&tile0)[kMaxPairs], int n_pairs, const void* adapter_idx,
        const void* active, void* part, int T_, int d, int r, int n_slots,
        int K, int split, int n_split, int tiles, int out_tiles,
        cudaStream_t st) {
  Args<T> a;
  for (int i = 0; i < kMaxPairs; ++i) {
    a.pair[i].a = static_cast<const T*>(ab[2 * i]);
    a.pair[i].b = static_cast<const T*>(ab[2 * i + 1]);
    a.pair[i].out = static_cast<T*>(out[i]);
    a.pair[i].out_dim = out_dim[i];
    a.pair[i].tile0 = tile0[i];
  }
  a.x = static_cast<const T*>(x);
  a.adapter_idx = static_cast<const int*>(adapter_idx);
  a.active = static_cast<const int*>(active);
  a.part = static_cast<float*>(part);
  a.T_ = T_;
  a.d = d;
  a.r = r;
  a.n_slots = n_slots;
  a.K = K;
  a.n_pairs = n_pairs;
  a.split = split;
  a.n_split = n_split;
  return launch<T>(a, tiles, out_tiles, st);
}

}  // namespace
}  // namespace repro_torch

// x (T, d); pair i: a_i (n_slots, d, r), b_i (n_slots, r, out_dim_i) ->
// out_i (T, out_dim_i), for i < n_pairs (1 to 3; the rest may be null);
// adapter_idx (T,) and active_slots (K,) int32; part: fp32 scratch
// (n_split, T, n_pairs * r).  r a power of two from 8 to 256; d and
// every out_dim multiples of 8.  The launch, all from ragged_lora.plan:
// split, d columns per shrink block (a multiple of 64, at most 512);
// shrink grid (tiles, n_split, n_pairs); expand grid (out_tiles, tiles),
// pair i's output tiles starting at tile0_i.
extern "C" int ragged_grouped_lora(
    const void* x, const void* a0, const void* b0, void* out0,
    const void* a1, const void* b1, void* out1, const void* a2,
    const void* b2, void* out2, const void* adapter_idx,
    const void* active_slots, void* part, int T, int d, int r, int out_dim0,
    int out_dim1, int out_dim2, int n_pairs, int n_slots, int K, int split,
    int n_split, int tiles, int out_tiles, int tile0_0, int tile0_1,
    int tile0_2, int is_bf16, void* stream) {
  const void* const ab[6] = {a0, b0, a1, b1, a2, b2};
  void* const out[3] = {out0, out1, out2};
  const int dims[3] = {out_dim0, out_dim1, out_dim2};
  const int tile0[3] = {tile0_0, tile0_1, tile0_2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return repro_torch::run<__nv_bfloat16>(
        x, ab, out, dims, tile0, n_pairs, adapter_idx, active_slots, part, T,
        d, r, n_slots, K, split, n_split, tiles, out_tiles, s);
  return repro_torch::run<float>(x, ab, out, dims, tile0, n_pairs,
                                 adapter_idx, active_slots, part, T, d, r,
                                 n_slots, K, split, n_split, tiles,
                                 out_tiles, s);
}
