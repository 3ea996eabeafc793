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
// y is written at every packed position; the post-token state only at
// the positions the caller keeps, out_rows (M,): row m of the states
// output is the state after token out_rows[m] (repeats allowed).  The
// runner keeps each request's last token (the live pool) and the
// block-boundary tokens (the prefix cache's snapshots); the TPU kernel
// writes every position and leaves the gathers to the caller.  All
// float32, one rounding per output.
//
// What bounds it on this card.  Bytes: the init rows the segment starts
// read and the M state rows written (H x N x P x 4 B each: 2.6 MB at
// mamba2's H 80, N 128, P 64) and the inputs once (x, B, C: ~2.6 MB per
// 64 tokens).  The token loop is sequential per block, so the latency of
// one token's step, not the bytes, sets the time (PERF.md gives the
// measured split).
//
// Design.  The TPU kernel's sequential chunk grid axis becomes a loop
// over the packed tokens inside each block.  Grid (H, ceil(P / 32)): a
// block owns one head and 32 columns of P, four warps of 8 columns.
// Lane (ng, pc) = (lane / 2, lane % 2) owns four columns (a float4) and
// the N/16 state rows of row group ng in registers, so each B_t and C_t
// value read from shared memory feeds four columns, and y_t's sum over n
// stays inside the warp: a reduce-scatter of the four column sums over
// the 16 row groups (five shuffles).  The token loop has no barrier.
// The inputs (B_t and C_t rows of the head, the block's x columns, dA,
// dt, the segment starts and slots) are staged by cp.async in chunks of
// kChunk tokens through a ring of three stages, one chunk ahead, with one
// __syncthreads per chunk; y is gathered in shared memory and each warp
// writes its columns of the chunk at once.  With each chunk, warp 0
// lists the out_rows entries that name one of its tokens (a ballot over
// out_rows, staged once per block), and at such a token each lane writes
// its share of the state to each listed row.  Tokens run in runs
// between segment starts, four at a time; at a run's first token the
// entry row of the segment start that ends the run is loaded into
// registers, so it arrives while the run is computed.  T needs no
// padding to a chunk multiple, and init rows that no segment start
// names are never read.
//
// What the card showed (PERF.md): the token loop is bound by each warp's
// own instruction issue and the per-chunk copies, not by the bytes; the
// chunked SSD form on tensor cores would cut the sequential work per
// token (ROADMAP B').

#include "async_mma.cuh"

namespace repro_torch {
namespace {

using namespace sm90;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroupBits = 4;
constexpr int kGroups = 1 << kGroupBits;          // row groups of a warp
constexpr int kGroupLanes = 32 / kGroups;         // lanes of a row group
constexpr int kLaneCols = 4;      // P columns per lane (a float4)
constexpr int kCols = kGroupLanes * kLaneCols;    // P columns per warp
constexpr int kBlockCols = kWarps * kCols;        // P columns per block
constexpr int kChunk = 16;       // tokens per staged chunk
constexpr int kStages = 3;       // chunks in the ring
constexpr int kUnroll = 4;       // tokens per step of the token loop
constexpr unsigned kUnrollMask = (1u << kUnroll) - 1u;
constexpr int kSmemLimit = 227 * 1024;
static_assert(kChunk <= 16, "a list entry keeps the token in 4 bits");

struct Args {
  const float* x;          // (T, H, P)
  const float* B;          // (T, H, N)
  const float* C;          // (T, H, N)
  const float* dA;         // (T, H)
  const float* dt;         // (T, H)
  const int* seg_starts;   // (T,)
  const int* slot_rows;    // (T,)
  const int* out_rows;     // (M,)
  const float* init;       // (S, H, N, P)
  float* y;                // (T, H, P)
  float* states;           // (M, H, N, P)
  int T, H, N, P, M;
};

// Shared memory (in 4-byte words): out_rows (M, rounded up to 4), each
// stage's list length and token mask (8), then per stage B and C (kChunk
// x N each), x and y (kChunk x kBlockCols each), dA and dt (kChunk each),
// starts and slots (kChunk + 1 each: the next chunk's first token too,
// rounded up to 4) and the chunk's list of (out row, token) entries (M,
// rounded up to 4).
__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }
__host__ __device__ constexpr int stage_words(int N, int M) {
  return 2 * kChunk * N + 2 * kChunk * kBlockCols + 2 * kChunk +
         2 * round4(kChunk + 1) + round4(M);
}
__host__ __device__ constexpr int smem_words(int N, int M) {
  return round4(M) + 8 + kStages * stage_words(N, M);
}

struct Stage {
  float *b, *c, *x, *y, *da, *dt;
  int *start, *slot, *list;
  __device__ Stage(int* base, int N) {
    b = reinterpret_cast<float*>(base);
    c = b + kChunk * N;
    x = c + kChunk * N;
    y = x + kChunk * kBlockCols;
    da = y + kChunk * kBlockCols;
    dt = da + kChunk;
    start = reinterpret_cast<int*>(dt + kChunk);
    slot = start + round4(kChunk + 1);
    list = slot + round4(kChunk + 1);
  }
};

using Rows = float4;  // one state row of a lane: its kLaneCols columns

// NR rows of the lane's columns, P apart
template <int NR>
__device__ __forceinline__ void load_rows(Rows (&dst)[NR],
                                          const float* __restrict__ src,
                                          int P) {
#pragma unroll
  for (int i = 0; i < NR; ++i)
    dst[i] = __ldg(reinterpret_cast<const float4*>(src + (size_t)i * P));
}

__device__ __forceinline__ void update(Rows& s, float& y0, float& y1,
                                       float& y2, float& y3, float decay,
                                       float bdt, float c, const Rows& x) {
  s.x = decay * s.x + bdt * x.x;
  s.y = decay * s.y + bdt * x.y;
  s.z = decay * s.z + bdt * x.z;
  s.w = decay * s.w + bdt * x.w;
  y0 = fmaf(c, s.x, y0);
  y1 = fmaf(c, s.y, y1);
  y2 = fmaf(c, s.z, y2);
  y3 = fmaf(c, s.w, y3);
}

// One token's update of this lane's NR state rows (b, c: the token's B
// and C at those rows, x its x at the lane's columns); returns the
// lane's share of y at its columns, the sum over its rows
template <int NR>
__device__ __forceinline__ Rows token_step(Rows (&s)[NR], const float* b_rows,
                                           const float* c_rows, float decay,
                                           float dt, const Rows x) {
  float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
  if constexpr (NR % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NR; i += 4) {
      const float4 b = *reinterpret_cast<const float4*>(b_rows + i);
      const float4 c = *reinterpret_cast<const float4*>(c_rows + i);
      update(s[i], y0, y1, y2, y3, decay, b.x * dt, c.x, x);
      update(s[i + 1], y0, y1, y2, y3, decay, b.y * dt, c.y, x);
      update(s[i + 2], y0, y1, y2, y3, decay, b.z * dt, c.z, x);
      update(s[i + 3], y0, y1, y2, y3, decay, b.w * dt, c.w, x);
    }
  } else if constexpr (NR % 2 == 0) {
#pragma unroll
    for (int i = 0; i < NR; i += 2) {
      const float2 b = *reinterpret_cast<const float2*>(b_rows + i);
      const float2 c = *reinterpret_cast<const float2*>(c_rows + i);
      update(s[i], y0, y1, y2, y3, decay, b.x * dt, c.x, x);
      update(s[i + 1], y0, y1, y2, y3, decay, b.y * dt, c.y, x);
    }
  } else {
#pragma unroll
    for (int i = 0; i < NR; ++i)
      update(s[i], y0, y1, y2, y3, decay, b_rows[i] * dt, c_rows[i], x);
  }
  return make_float4(y0, y1, y2, y3);
}

// lane (ng, pc) = (lane / kGroupLanes, lane % kGroupLanes) of warp w
// holds the columns w * kCols + 4 pc .. + 3 of the block and the NR =
// N / kGroups state rows ng * NR ..
template <int NR>
__global__ void __launch_bounds__(kThreads)
ragged_ssd_scan_kernel(const Args a) {
  constexpr int N = kGroups * NR;
  extern __shared__ __align__(16) int smem[];
  const int M = a.M;
  int* s_out = smem;                    // out_rows
  int* s_count = s_out + round4(M);     // list length per stage
  int* s_keep = s_count + 4;            // tokens with a list entry
  int* ring = s_keep + 4;
  const int h = blockIdx.x, p0 = blockIdx.y * kBlockCols;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ng = lane / kGroupLanes, pc = lane % kGroupLanes;
  const int wcol = warp * kCols + pc * kLaneCols;  // in the block
  const int col = p0 + wcol;               // this lane's first P column
  const bool live = col < a.P;             // (P is a multiple of 8)
  const int n0 = ng * NR;                  // its first state row
  const int n_chunks = (a.T + kChunk - 1) / kChunk;
  const size_t hstride = (size_t)N * a.P;        // one head's state
  const size_t rstride = (size_t)a.H * hstride;  // one state row (S or M)

  // stage chunk c: B and C rows, x's block columns, dA, dt, and the
  // starts and slots of its tokens and the next one; tokens past T are
  // zeros and never read
  auto stage = [&](int c) {
    Stage st(ring + (c % kStages) * stage_words(N, M), N);
    const int t0 = c * kChunk;
    constexpr int bcpr = N / 4;  // 16-byte copies per B or C row
    for (int e = tid; e < kChunk * bcpr; e += kThreads) {
      const int tt = e / bcpr, part = (e - tt * bcpr) * 4;
      const bool ok = t0 + tt < a.T;
      const size_t off = ((size_t)(t0 + tt) * a.H + h) * N + part;
      cp_async16(smem_u32(st.b + tt * N + part), ok ? a.B + off : a.B, ok);
      cp_async16(smem_u32(st.c + tt * N + part), ok ? a.C + off : a.C, ok);
    }
    for (int e = tid; e < kChunk * (kBlockCols / 4); e += kThreads) {
      const int tt = e / (kBlockCols / 4), part = (e % (kBlockCols / 4)) * 4;
      const bool ok = t0 + tt < a.T && p0 + part < a.P;
      const float* src =
          a.x + ((size_t)(t0 + tt) * a.H + h) * a.P + p0 + part;
      cp_async16(smem_u32(st.x + tt * kBlockCols + part), ok ? src : a.x,
                 ok);
    }
    if (tid <= kChunk) {
      const int t = t0 + tid;
      const bool ok = t < a.T;
      const size_t th = (size_t)t * a.H + h;
      if (tid < kChunk) {
        cp_async4(smem_u32(st.da + tid), ok ? a.dA + th : a.dA, ok);
        cp_async4(smem_u32(st.dt + tid), ok ? a.dt + th : a.dt, ok);
      }
      cp_async4(smem_u32(st.start + tid), ok ? a.seg_starts + t : a.seg_starts,
                ok);
      cp_async4(smem_u32(st.slot + tid), ok ? a.slot_rows + t : a.slot_rows,
                ok);
    }
  };
  // warp 0: the out_rows entries naming a token of chunk c, as
  // (m << 4 | token in chunk), in m order, and the mask of those tokens
  auto list = [&](int c) {
    Stage st(ring + (c % kStages) * stage_words(N, M), N);
    const int t0 = c * kChunk;
    int n = 0;
    unsigned keep = 0u;
    for (int base = 0; base < M; base += 32) {
      const int m = base + lane;
      const int t = m < M ? s_out[m] : -1;
      const bool hit = t >= t0 && t < t0 + kChunk;
      const unsigned bits = __ballot_sync(0xffffffffu, hit);
      if (hit) st.list[n + __popc(bits & ((1u << lane) - 1u))] =
          (m << 4) | (t - t0);
      keep |= __reduce_or_sync(0xffffffffu, hit ? 1u << (t - t0) : 0u);
      n += __popc(bits);
    }
    if (lane == 0) {
      s_count[c % kStages] = n;
      s_keep[c % kStages] = (int)keep;
    }
  };

  for (int m = tid; m < M; m += kThreads)
    cp_async4(smem_u32(s_out + m), a.out_rows + m, true);
  if (n_chunks > 0) stage(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // out_rows and chunk 0 have landed
  if (warp == 0 && n_chunks > 0) list(0);
  // an out_rows entry outside [0, T) names no token: its row is zeros
  if (live)
    for (int m = 0; m < M; ++m) {
      if (s_out[m] >= 0 && s_out[m] < a.T) continue;
      float* dst = a.states + (size_t)m * rstride + h * hstride +
                   (size_t)n0 * a.P + col;
#pragma unroll
      for (int i = 0; i < NR; ++i)
        *reinterpret_cast<float4*>(dst + (size_t)i * a.P) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }

  // the state, and the entry of the next segment start, loaded at the
  // beginning of the run of tokens before it
  Rows s[NR], nx[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) s[i] = nx[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  // this lane's share of init_states[slot] for head h
  const float* entry = a.init + h * hstride + (size_t)n0 * a.P + col;
  if (a.T > 0 && live && a.seg_starts[0])
    load_rows(nx, entry + (size_t)a.slot_rows[0] * rstride, a.P);

  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) stage(c + 1);
    cp_async_commit();
    if (warp == 0 && c + 1 < n_chunks) list(c + 1);
    cp_async_wait<1>();
    __syncthreads();  // chunk c and its list are visible
    const Stage st(ring + (c % kStages) * stage_words(N, M), N);
    const int n_list = s_count[c % kStages];
    const unsigned keep = (unsigned)s_keep[c % kStages];
    const int t0 = c * kChunk;
    const int tn = min(kChunk, a.T - t0);
    // the chunk's per-token scalars, lane tt holding token tt's (bit
    // kChunk of starts: the next chunk's first token)
    const float dec_l = expf(st.da[lane % kChunk]);
    const float dt_l = st.dt[lane % kChunk];
    const int slot_l = st.slot[min(lane, kChunk)];
    const unsigned starts = __ballot_sync(
        0xffffffffu, lane <= kChunk && st.start[min(lane, kChunk)]);

    auto step = [&](int tt) {  // token tt's share of y
      return token_step<NR>(
          s, st.b + tt * N + n0, st.c + tt * N + n0,
          __shfl_sync(0xffffffffu, dec_l, tt),
          __shfl_sync(0xffffffffu, dt_l, tt),
          *reinterpret_cast<const float4*>(st.x + tt * kBlockCols + wcol));
    };
    // y: the sum of the lanes' shares over the row groups, kept for the
    // chunk.  A reduce-scatter: the top group bit halves the four
    // columns, the next halves them again, the other bits add up; lane
    // (ng, pc) ends with column 2 b1 + b2 of its four.
    const int b1 = (ng >> (kGroupBits - 1)) & 1;
    const int b2 = (ng >> (kGroupBits - 2)) & 1;
    auto finish = [&](int tt, Rows yv) {
      const float h0 = (b1 ? yv.z : yv.x) + __shfl_xor_sync(
          0xffffffffu, b1 ? yv.x : yv.z, kGroupLanes << (kGroupBits - 1));
      const float h1 = (b1 ? yv.w : yv.y) + __shfl_xor_sync(
          0xffffffffu, b1 ? yv.y : yv.w, kGroupLanes << (kGroupBits - 1));
      float r = (b2 ? h1 : h0) + __shfl_xor_sync(
          0xffffffffu, b2 ? h0 : h1, kGroupLanes << (kGroupBits - 2));
#pragma unroll
      for (int o = kGroupLanes; o < kGroupLanes << (kGroupBits - 2); o <<= 1)
        r += __shfl_xor_sync(0xffffffffu, r, o);
      if ((ng & ((1 << (kGroupBits - 2)) - 1)) == 0)
        st.y[tt * kBlockCols + wcol + 2 * b1 + b2] = r;
    };
    auto kept = [&](int tt) {  // the state after token tt, where kept
      if (!((keep >> tt) & 1u) || !live) return;
      for (int j = 0; j < n_list; ++j) {
        const int e = st.list[j];
        if ((e & 15) != tt) continue;
        float* dst = a.states + (size_t)(e >> 4) * rstride + h * hstride +
                     (size_t)n0 * a.P + col;
#pragma unroll
        for (int i = 0; i < NR; ++i)
          *reinterpret_cast<float4*>(dst + (size_t)i * a.P) = s[i];
      }
    };

    // runs of tokens without a segment start after their first
    for (int tt = 0; tt < tn;) {
      if ((starts >> tt) & 1u) {
#pragma unroll
        for (int i = 0; i < NR; ++i) s[i] = nx[i];
      }
      const unsigned later = (starts & ((1u << kChunk) - 1u)) >> (tt + 1);
      const int end = later ? tt + __ffs(later) : tn;
      // the run ends at a segment start (in this chunk, or the next
      // chunk's first token): its entry loads while the run is computed
      const int nslot = __shfl_sync(0xffffffffu, slot_l, end);
      if ((end < tn || ((starts >> kChunk) & 1u)) && live)
        load_rows(nx, entry + (size_t)nslot * rstride, a.P);
      while (tt < end) {
        if (tt + kUnroll <= end && !((keep >> tt) & kUnrollMask)) {
          // kUnroll tokens, none kept: their y sums overlap the next
          // tokens' updates
          Rows yu[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) yu[u] = step(tt + u);
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) finish(tt + u, yu[u]);
          tt += kUnroll;
        } else {
          finish(tt, step(tt));
          kept(tt);
          ++tt;
        }
      }
    }
    // the chunk's y: each warp writes its own columns
    __syncwarp();
    constexpr int kQuads = kCols / 4;  // float4s per token of a warp
    for (int e = lane; e < tn * kQuads; e += 32) {
      const int tt = e / kQuads, cw = warp * kCols + (e % kQuads) * 4;
      if (p0 + cw < a.P)
        *reinterpret_cast<float4*>(
            a.y + ((size_t)(t0 + tt) * a.H + h) * a.P + p0 + cw) =
            *reinterpret_cast<const float4*>(st.y + tt * kBlockCols + cw);
    }
  }
}

template <int NR>
cudaError_t launch_nr(const Args& a, dim3 grid, cudaStream_t stream) {
  static const cudaError_t set = cudaFuncSetAttribute(
      ragged_ssd_scan_kernel<NR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemLimit);
  if (set != cudaSuccess) return set;
  const size_t smem = 4 * (size_t)smem_words(kGroups * NR, a.M);
  if (smem > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  ragged_ssd_scan_kernel<NR><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// x (T,H,P), B/C (T,H,N), dA/dt (T,H), seg_starts/slot_rows (T,) int32,
// init_states (S,H,N,P), out_rows (M,) int32 -> y (T,H,P), states
// (M,H,N,P); all float32 (a row whose out_rows entry is outside [0, T)
// is zeros).  N one of 16, 32, 64 and 128, P a multiple of 8; grid
// (grid_h, grid_p) = (H, ceil(P / 32)), all from ssd_chunk.ragged_plan.
extern "C" int ragged_ssd_chunk_scan(const void* x, const void* B,
                                     const void* C, const void* dA,
                                     const void* dt, const void* seg_starts,
                                     const void* slot_rows,
                                     const void* init_states,
                                     const void* out_rows, void* y,
                                     void* states, int T, int H, int N, int P,
                                     int M, int grid_h, int grid_p,
                                     void* stream) {
  using namespace repro_torch;
  if (P % 8 != 0 || P <= 0 || H <= 0 || M < 0) return cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const float*>(x);
  a.B = static_cast<const float*>(B);
  a.C = static_cast<const float*>(C);
  a.dA = static_cast<const float*>(dA);
  a.dt = static_cast<const float*>(dt);
  a.seg_starts = static_cast<const int*>(seg_starts);
  a.slot_rows = static_cast<const int*>(slot_rows);
  a.out_rows = static_cast<const int*>(out_rows);
  a.init = static_cast<const float*>(init_states);
  a.y = static_cast<float*>(y);
  a.states = static_cast<float*>(states);
  a.T = T;
  a.H = H;
  a.N = N;
  a.P = P;
  a.M = M;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_h, grid_p);
  switch (N) {  // rows per lane: N / kGroups
    case 16: return launch_nr<1>(a, grid, s);
    case 32: return launch_nr<2>(a, grid, s);
    case 64: return launch_nr<4>(a, grid, s);
    case 128: return launch_nr<8>(a, grid, s);
    default: return cudaErrorInvalidValue;
  }
}
