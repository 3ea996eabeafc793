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
// skipped whatever A[0] holds, as are indices outside [1, n).  Products
// accumulate in fp32; the output is rounded once, to x's type.
//
// What bounds it on this card (NVIDIA H100 SXM data sheet: 989 TFLOP/s
// bf16, 165 TFLOP/s float32 as three TF32 products, 3.35 TB/s).  At
// granite-3.2-8b's fused Q/K/V (d 4096, out 6144): in bf16 at T = 512 the
// operations (26 GFLOP against 63 MB of unique bytes), at T = 128 the
// bytes (the 50 MB of W); in float32 at T = 128 the operations.
//
// Design: up to four kernels on the caller's stream, launched from
// alora_qkv.plan.
//   shrink  grid (64-row token tiles, d splits, adapters 1..n-1): a block
//           whose tile has rows on its adapter loads the tile's x split
//           and the adapter's A rows of the split once (cp.async, one
//           wait); each warp multiplies its 16 rows on tensor cores
//           (mma.sync: bf16, or 3xTF32 for float32), rows of other
//           adapters entering as zeros.  A[i] is read once per (token
//           tile, adapter), not once per token.  The fp32 partial of the
//           split goes to a scratch (splits, T, rp), rp = r rounded up to
//           16, zero past r.
//   xa      sums the shrink's splits in split order and rounds once to
//           x's type: xa (T, rp), for the rows on an adapter.
//   tile    grid (token tiles of BM = 64 or 128 rows, output tiles of BN
//           columns, d splits).  One producer warp keeps a ring of
//           shared-memory stages full with TMA tile loads
//           (cp.async.bulk.tensor, 128-byte swizzle, one mbarrier per
//           stage for "full" and one for "empty"); one consumer warpgroup
//           per 64 rows multiplies.  bf16: wgmma.mma_async m64nBNk16, x
//           K-major and W MN-major (the B operand's transpose bit), fp32
//           accumulators in registers, one stage's wgmma in flight while
//           the next is issued.  float32: mma.sync m16n8k8 in 3xTF32 on
//           the same stages (TF32 wgmma cannot take an MN-major B).
//           After the d loop the adapters the tile's rows use (listed
//           from its adapter_idx by ballots) add their delta into the
//           same accumulators as extra k steps: B[i]'s rows arrive by TMA
//           through the same ring, and the A operand -- xa's rows of
//           adapter i, other rows zero -- is built in registers (wgmma
//           takes A from registers).  A tile no adapted row reaches does
//           no delta work.  TMA fills the edges past T, d and out with
//           zeros, and the epilogue masks its stores: nothing needs
//           padding.
//   reduce  when the plan splits d (bf16 at T <= 128: the bytes of W
//           bound the product, so the split puts at least 132 blocks on
//           the stream of W; float32 there, as far as whole waves
//           allow), the tile writes fp32 partials and this pass sums them
//           in split order and rounds once.  Only split 0 adds the delta.
// The xa, tile and reduce kernels are launched as programmatic dependents
// (griddepcontrol): each may start while the one before it drains, and
// waits for that one's results only where it reads them -- the tile's d
// loop needs nothing of the shrink.
// The tensor maps are encoded on the host per call (they hold the base
// pointers), through cuTensorMapEncodeTiled reached by
// cudaGetDriverEntryPoint, so the library needs no -lcuda.

#include <cuda.h>  // CUtensorMap and its enums (the driver entry is looked up)

#include "async_mma.cuh"

namespace repro_torch {
namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;
constexpr int kRowBytes = 128;     // a swizzled shared row: the TMA box's width
constexpr int kShrinkRows = 64;    // the shrink's token tile: 16 rows a warp
constexpr int kShrinkThreads = 128;
constexpr int kProducer = 32;      // the tile kernel's TMA warp
constexpr int kReduceThreads = 256;

template <typename T>
__host__ __device__ constexpr int row_elems() {
  return kRowBytes / static_cast<int>(sizeof(T));
}

// ------------------------------------------------------- adapter lists
// The adapters of the packed rows [m0, m0 + ROWS) (rows past T are on
// none): fills s_idx with each row's index and s_list with the distinct
// ones in [1, n) in order of their first row (none when !want), returns
// their count.  One warp calls it: a ballot per adapter found.
template <int ROWS>
__device__ int tile_adapters(const int* __restrict__ idx, int m0, int T_,
                             int n, bool want, int* s_idx, int* s_list) {
  const int lane = threadIdx.x & 31;
  int v[ROWS / 32];
#pragma unroll
  for (int i = 0; i < ROWS / 32; ++i) {
    const int row = lane + 32 * i, t = m0 + row;
    const int vi = t < T_ ? idx[t] : 0;
    s_idx[row] = vi;
    v[i] = want && vi >= 1 && vi < n ? vi : 0;
  }
  int nl = 0;
  for (;;) {
    int pick = 0;
#pragma unroll
    for (int i = 0; i < ROWS / 32; ++i) {
      const unsigned m = __ballot_sync(0xffffffffu, v[i] != 0);
      if (pick == 0 && m) pick = __shfl_sync(0xffffffffu, v[i], __ffs(m) - 1);
    }
    if (pick == 0) break;
    if (lane == 0) s_list[nl] = pick;
    ++nl;
#pragma unroll
    for (int i = 0; i < ROWS / 32; ++i)
      if (v[i] == pick) v[i] = 0;
  }
  return nl;
}

// ---------------------------------------------------------------- shrink
// row padding (elements) of the shrink's shared tiles: ldmatrix and the
// TF32 fragment loads stay free of bank conflicts
template <typename T> struct Pad;
template <> struct Pad<bf16> { static constexpr int x = 8, a = 8; };
template <> struct Pad<float> { static constexpr int x = 4, a = 8; };

template <typename T>
__host__ __device__ constexpr int shrink_smem(int kc, int rp) {
  return (kShrinkRows * (kc + Pad<T>::x) + kc * (rp + Pad<T>::a)) *
         static_cast<int>(sizeof(T));
}

// Grid (token tiles of kShrinkRows, d splits, adapters 1..n-1).  A block
// whose tile has rows on its adapter `slot` loads the tile's x split and
// A[slot]'s rows of it once (cp.async, one wait); warp w multiplies rows
// 16 w .. + 15 (rows of other adapters enter as zeros), 64 rank columns
// at a time, and stores the rows on `slot` of the fp32 partial
// part[split] (T x rp; columns past r are zeros).
template <typename T>
__global__ void __launch_bounds__(kShrinkThreads)
alora_shrink_kernel(const T* __restrict__ x, const T* __restrict__ a_stack,
                    const int* __restrict__ adapter_idx,
                    float* __restrict__ part, int T_, int d, int r, int rp,
                    int kc) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_idx[kShrinkRows];
  const int t0 = blockIdx.x * kShrinkRows, z = blockIdx.y;
  const int slot = blockIdx.z + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  pdl_launch_dependents();  // the xa pass may start launching
  if (tid < kShrinkRows)
    s_idx[tid] = t0 + tid < T_ ? adapter_idx[t0 + tid] : 0;
  if (!__syncthreads_or(tid < kShrinkRows && s_idx[tid] == slot)) return;
  const int k0 = z * kc, kn = min(kc, d - k0);
  const int ldx = kc + Pad<T>::x, lda = rp + Pad<T>::a;
  T* sx = reinterpret_cast<T*>(smem);  // kShrinkRows x ldx
  T* sa = sx + kShrinkRows * ldx;      // kc x lda

  // x's split of the tile and A[slot]'s rows of it; zeros past T, past d
  // and past r
  const int xc = kc / EPC;
  for (int e = tid; e < kShrinkRows * xc; e += kShrinkThreads) {
    const int row = e / xc, col = (e - row * xc) * EPC;
    const bool ok = t0 + row < T_ && col < kn;
    cp_async16(smem_u32(sx + row * ldx + col),
               ok ? x + (size_t)(t0 + row) * d + k0 + col : x, ok);
  }
  const T* a = a_stack + ((size_t)slot * d + k0) * r;
  if ((r * (int)sizeof(T)) % 16 == 0) {
    const int ac = rp / EPC;
    for (int e = tid; e < kc * ac; e += kShrinkThreads) {
      const int row = e / ac, col = (e - row * ac) * EPC;
      const bool ok = row < kn && col < r;
      cp_async16(smem_u32(sa + row * lda + col),
                 ok ? a + (size_t)row * r + col : a_stack, ok);
    }
  } else {  // rows not 16-byte aligned: element by element
    for (int e = tid; e < kc * rp; e += kShrinkThreads) {
      const int row = e / rp, col = e - row * rp;
      sa[row * lda + col] =
          row < kn && col < r ? a[(size_t)row * r + col] : from_f32<T>(0.f);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int g = lane >> 2, c4 = lane & 3;
  const int wr = warp * 16;  // the warp's first row in the tile
  const bool on0 = s_idx[wr + g] == slot, on1 = s_idx[wr + g + 8] == slot;
  if (!__any_sync(0xffffffffu, on0 || on1)) return;
  const int groups = rp / 16;
  for (int rc = 0; rc < groups; rc += 4) {  // 64 rank columns
    float acc[4][2][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        acc[q][h][0] = acc[q][h][1] = acc[q][h][2] = acc[q][h][3] = 0.f;
    for (int k = 0; k < kn; k += 16) {
      if constexpr (sizeof(T) == 2) {
        uint32_t af[4];
        ldsm_x4(af, sx + (wr + lane % 16) * ldx + (lane / 16) * 8 + k);
        if (!on0) af[0] = af[2] = 0u;
        if (!on1) af[1] = af[3] = 0u;
        const T* brow =
            sa + (k + ((lane / 8) % 2) * 8 + lane % 8) * lda + (lane / 16) * 8;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (rc + q >= groups) continue;
          uint32_t b[4];
          ldsm_x4_t(b, brow + (rc + q) * 16);
          mma_bf16(acc[q][0], af, b[0], b[1]);
          mma_bf16(acc[q][1], af, b[2], b[3]);
        }
      } else {
#pragma unroll
        for (int h8 = 0; h8 < 2; ++h8) {
          const float* x0 = sx + (wr + g) * ldx + k + 8 * h8 + c4;
          const float* x1 = x0 + 8 * ldx;
          const Tf32 af[4] = {split_tf32(on0 ? x0[0] : 0.f),
                              split_tf32(on1 ? x1[0] : 0.f),
                              split_tf32(on0 ? x0[4] : 0.f),
                              split_tf32(on1 ? x1[4] : 0.f)};
          const float* b0 = sa + (k + 8 * h8 + c4) * lda + g;
          const float* b1 = b0 + 4 * lda;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (rc + q >= groups) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int col = (rc + q) * 16 + 8 * h;
              mma_3xtf32(acc[q][h], af, split_tf32(b0[col]),
                         split_tf32(b1[col]));
            }
          }
        }
      }
    }
    float* dst = part + ((size_t)z * T_ + t0 + wr) * rp;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (rc + q >= groups) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = (rc + q) * 16 + 8 * h + 2 * c4;
        if (on0) store2(dst + g * rp + col, acc[q][h][0], acc[q][h][1]);
        if (on1) store2(dst + (g + 8) * rp + col, acc[q][h][2], acc[q][h][3]);
      }
    }
  }
}

// xa[t] = round(sum of the shrink's splits, in split order) for the rows
// on an adapter in [1, n); the tile kernel reads no other row
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
alora_xa_kernel(const float* __restrict__ part,
                const int* __restrict__ adapter_idx, T* __restrict__ xa,
                int T_, int n, int rp, int splits) {
  const int pairs = rp / 2;
  const size_t step = (size_t)T_ * rp;
  pdl_launch_dependents();  // the tile kernel may start its d loop
  pdl_wait();               // the shrink's partials are written
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
       i < (long)T_ * pairs; i += (long)gridDim.x * blockDim.x) {
    const int t = (int)(i / pairs), c = (int)(i - (long)t * pairs) * 2;
    const int v = adapter_idx[t];
    if (v < 1 || v >= n) continue;
    const float* p = part + (size_t)t * rp + c;
    float2 s = *reinterpret_cast<const float2*>(p);
    for (int z = 1; z < splits; ++z) {
      const float2 u = *reinterpret_cast<const float2*>(p + z * step);
      s.x += u.x;
      s.y += u.y;
    }
    store2(xa + (size_t)t * rp + c, s.x, s.y);
  }
}

// ------------------------------------------------------------------ tile
struct TileArgs {
  const int* adapter_idx;  // (T,)
  const void* xa;          // (T, rp) of the type: round(x @ A[idx_t])
  void* out;               // (T, out) of the type, or fp32 (split, T, out)
  int T_, out_dim, n, rp, ksteps, split, stages;
};

__host__ __device__ constexpr int tile_smem(int bm, int bn, int stages) {
  return 1024 + stages * (bm + bn) * kRowBytes + stages * 16 + bm * 8 + 16;
}

// a float32 of a TMA tile in the 128-byte swizzle: row `r` of 128 bytes,
// column `c` < 32; the tile starts on a 1024-byte boundary
__device__ __forceinline__ float ld_sw(const unsigned char* tile, int r,
                                       int c) {
  return *reinterpret_cast<const float*>(
      tile + r * kRowBytes + ((((c >> 2) ^ (r & 7))) << 4) + ((c & 3) << 2));
}

template <int BN>
__device__ __forceinline__ void wgmma_ss(float (&d)[BN / 2], uint64_t da,
                                         uint64_t db);
template <int BN>
__device__ __forceinline__ void wgmma_rs(float (&d)[BN / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_ss<192>(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Grid (token tiles of BM rows, output tiles of BN columns, d splits).
// Threads: BM / 64 consumer warpgroups, then the producer warp.  Two
// bf16 blocks of 128-column tiles share an SM (the d-split grids of
// T <= 128 hold more blocks than SMs; float32's operand splits need more
// registers than two blocks leave).
template <typename T, int BM, int BN>
__global__ void __launch_bounds__(BM * 2 + kProducer,
                                  sizeof(T) == 2 && BN == 128 ? 2 : 1)
alora_tile_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_w,
                  const __grid_constant__ CUtensorMap tm_b,
                  const TileArgs a) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int EPB = row_elems<T>();     // elements per swizzled row: BK
  constexpr int NBOX = BN / EPB;          // W boxes (EPB columns) a stage
  constexpr int BOX = EPB * kRowBytes;    // bytes of one: EPB k rows
  constexpr int STAGE_A = BM * kRowBytes;
  constexpr int STAGE = STAGE_A + BN * kRowBytes;
  constexpr int CONSUMERS = BM * 2;       // 128 threads per 64 rows
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int stages = a.stages;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + stages * STAGE);
  uint64_t* empty = full + stages;
  int* s_idx = reinterpret_cast<int*>(empty + stages);
  int* s_list = s_idx + BM;
  int* s_nlist = s_list + BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, sp = blockIdx.z;
  const int ks0 = (int)((long)sp * a.ksteps / a.split);
  const int nk = (int)((long)(sp + 1) * a.ksteps / a.split) - ks0;
  const int rb = min(EPB, a.rp);          // rank rows a delta step
  const int per = (a.rp + EPB - 1) / EPB; // delta steps an adapter

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // item it < nk: the d step ks0 + it (x's and W's tiles); past that,
  // delta step (it - nk) % per of the adapter s_list[(it - nk) / per]
  // (B[slot]'s rank rows; rows past r arrive as zeros)
  auto issue = [&](int it) {
    const int s = it % stages;
    unsigned char* sa = base + s * STAGE;
    unsigned char* sb = sa + STAGE_A;
    if (it < nk) {
      const int k = (ks0 + it) * EPB;
      mbar_expect_tx(&full[s], STAGE);
      tma_load_2d(sa, &tm_x, &full[s], k, m0);
#pragma unroll
      for (int j = 0; j < NBOX; ++j)
        tma_load_2d(sb + j * BOX, &tm_w, &full[s], n0 + j * EPB, k);
    } else {
      const int e = it - nk;
      mbar_expect_tx(&full[s], NBOX * rb * kRowBytes);
#pragma unroll
      for (int j = 0; j < NBOX; ++j)
        tma_load_3d(sb + j * BOX, &tm_b, &full[s], n0 + j * EPB,
                    (e % per) * EPB, s_list[e / per]);
    }
  };
  const int first = min(stages, nk);
  if (tid == CONSUMERS)  // the d loop's first stages go out at once
    for (int it = 0; it < first; ++it) issue(it);
  if (warp == 0) {
    // the tile's rows' adapters, and the list of those it adds (split 0
    // only: it adds the delta)
    const int nl = tile_adapters<BM>(a.adapter_idx, m0, a.T_, a.n, sp == 0,
                                     s_idx, s_list);
    if (lane == 0) *s_nlist = nl;
  }
  __syncthreads();
  const int items = nk + *s_nlist * per;

  if (tid >= CONSUMERS) {  // the producer warp: one lane issues
    if (tid == CONSUMERS)
      for (int it = first; it < items; ++it) {
        if (it >= stages)
          mbar_wait(&empty[it % stages], ((it / stages) - 1) & 1);
        issue(it);
      }
    return;
  }

  const int g = lane >> 2, c4 = lane & 3;
  if constexpr (kBf16) {
    // warpgroup wg owns rows 64 wg ..; its warp (warp & 3) rows 16 (warp
    // & 3) + g and + 8 of the m64nBN accumulator: acc[4 j + e] is column
    // 8 j + 2 c4 + (e & 1), row + 8 (e >> 1)
    const int wg = warp >> 2;
    const int row = wg * 64 + (warp & 3) * 16 + g;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    const bf16* xa = static_cast<const bf16*>(a.xa);
    // one item's wgmma stay in flight while the next is issued; its stage
    // is released once they have completed
    for (int it = 0; it < items; ++it) {
      const int s = it % stages;
      const unsigned char* sa = base + s * STAGE;
      const unsigned char* sb = sa + STAGE_A;
      if (it < nk) {
        mbar_wait(&full[s], (it / stages) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < EPB / 16; ++kk)
          wgmma_ss<BN>(acc,
                       gmma_desc(sa + wg * 64 * kRowBytes + kk * 32, 16,
                                 1024),
                       gmma_desc(sb + kk * 16 * kRowBytes, BOX, 1024));
        wgmma_commit();
      } else {
        // the A operand comes from registers: no wgmma may still read
        // the previous item's
        wgmma_wait<0>();
        fence_regs(acc);
        if (it == nk) pdl_wait();  // xa is written
        const int e = it - nk, slot = s_list[e / per], kb = e % per;
        const int nq = min(EPB, a.rp - kb * EPB) / 16;
        const bool on0 = s_idx[row] == slot, on1 = s_idx[row + 8] == slot;
        const bf16* x0 = xa + (size_t)(m0 + row) * a.rp + kb * EPB + 2 * c4;
        const bf16* x1 = x0 + 8 * a.rp;
        uint32_t af[EPB / 16][4];
#pragma unroll
        for (int q = 0; q < EPB / 16; ++q) {
          af[q][0] = af[q][1] = af[q][2] = af[q][3] = 0u;
          if (q >= nq) continue;
          if (on0) {
            af[q][0] = *reinterpret_cast<const uint32_t*>(x0 + 16 * q);
            af[q][2] = *reinterpret_cast<const uint32_t*>(x0 + 16 * q + 8);
          }
          if (on1) {
            af[q][1] = *reinterpret_cast<const uint32_t*>(x1 + 16 * q);
            af[q][3] = *reinterpret_cast<const uint32_t*>(x1 + 16 * q + 8);
          }
        }
        mbar_wait(&full[s], (it / stages) & 1);
        wgmma_fence();
#pragma unroll
        for (int q = 0; q < EPB / 16; ++q)
          if (q < nq)
            wgmma_rs<BN>(acc, af[q],
                         gmma_desc(sb + q * 16 * kRowBytes, BOX, 1024));
        wgmma_commit();
      }
      wgmma_wait<1>();
      fence_regs(acc);
      if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % stages]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    // the grid completes after the kernels it overlapped (a tile with no
    // delta has not waited yet); the sum of the d splits may launch
    pdl_wait();
    pdl_launch_dependents();
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * c4;
      if (col >= a.out_dim) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = m0 + row + 8 * h;
        if (t >= a.T_) continue;
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (a.split == 1)
          store2(static_cast<T*>(a.out) + (size_t)t * a.out_dim + col, v0,
                 v1);
        else
          store2(static_cast<float*>(a.out) +
                     ((size_t)sp * a.T_ + t) * a.out_dim + col,
                 v0, v1);
      }
    }
  } else {
    // float32: warp (wm, wn) owns rows 32 wm .. + 31 and columns 64 wn ..
    // + 63 of the tile, as 2 x 8 m16n8 tiles in 3xTF32
    const int wm = warp >> 1, wn = warp & 1;
    const float* xa = static_cast<const float*>(a.xa);
    float acc[2][8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
    // one 8-deep k step at k rows k0 .. of the stage's B tile
    auto mma_step = [&](const unsigned char* sb, int k0,
                        const Tf32 (&af)[2][4]) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = wn * 64 + 8 * j + g;
        const unsigned char* box = sb + (n >> 5) * BOX;
        const Tf32 b0 = split_tf32(ld_sw(box, k0 + c4, n & 31));
        const Tf32 b1 = split_tf32(ld_sw(box, k0 + c4 + 4, n & 31));
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_3xtf32(acc[i][j], af[i], b0, b1);
      }
    };
    for (int it = 0; it < items; ++it) {
      const int s = it % stages;
      const unsigned char* sa = base + s * STAGE;
      const unsigned char* sb = sa + STAGE_A;
      mbar_wait(&full[s], (it / stages) & 1);
      if (it < nk) {
#pragma unroll
        for (int kq = 0; kq < EPB / 8; ++kq) {
          Tf32 af[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = wm * 32 + 16 * i + g, c = 8 * kq + c4;
            af[i][0] = split_tf32(ld_sw(sa, r, c));
            af[i][1] = split_tf32(ld_sw(sa, r + 8, c));
            af[i][2] = split_tf32(ld_sw(sa, r, c + 4));
            af[i][3] = split_tf32(ld_sw(sa, r + 8, c + 4));
          }
          mma_step(sb, 8 * kq, af);
        }
      } else {
        if (it == nk) pdl_wait();  // xa is written
        const int e = it - nk, slot = s_list[e / per], kb = e % per;
        const int nq = min(EPB, a.rp - kb * EPB) / 8;
        for (int kq = 0; kq < nq; ++kq) {
          Tf32 af[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = wm * 32 + 16 * i + g;
            const int c = kb * EPB + 8 * kq + c4;
            const bool on0 = s_idx[r] == slot, on1 = s_idx[r + 8] == slot;
            const float* x0 = xa + (size_t)(m0 + r) * a.rp + c;
            const float* x1 = x0 + 8 * a.rp;
            const float v[4] = {on0 ? x0[0] : 0.f, on1 ? x1[0] : 0.f,
                                on0 ? x0[4] : 0.f, on1 ? x1[4] : 0.f};
#pragma unroll
            for (int q = 0; q < 4; ++q) af[i][q] = split_tf32(v[q]);
          }
          mma_step(sb, 8 * kq, af);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    // the grid completes after the kernels it overlapped (a tile with no
    // delta has not waited yet); the sum of the d splits may launch
    pdl_wait();
    pdl_launch_dependents();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + wn * 64 + 8 * j + 2 * c4;
        if (col >= a.out_dim) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = m0 + wm * 32 + 16 * i + g + 8 * h;
          if (t >= a.T_) continue;
          float* dst = a.split == 1
                           ? static_cast<float*>(a.out) + (size_t)t * a.out_dim
                           : static_cast<float*>(a.out) +
                                 ((size_t)sp * a.T_ + t) * a.out_dim;
          store2(dst + col, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      }
  }
}

// out = round(sum of the tile's d-split partials, in split order)
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
alora_reduce_kernel(const float* __restrict__ part, T* __restrict__ out,
                    long n4, int split) {
  const float4* p = reinterpret_cast<const float4*>(part);
  pdl_wait();  // the tile kernel's partials are written
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n4;
       i += (long)gridDim.x * blockDim.x) {
    float4 v = p[i];
    for (int s = 1; s < split; ++s) {
      const float4 u = p[s * n4 + i];
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    store2(out + 4 * i, v.x, v.y);
    store2(out + 4 * i + 2, v.z, v.w);
  }
}

// ------------------------------------------------------------------ host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major tensor of `rank` dims (innermost first), 128-byte swizzled
// boxes; elements past its edges read as zeros
bool encode(CUtensorMap* map, EncodeTiled fn, bool bf, int rank,
            const void* ptr, const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box) {
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map,
            bf ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
               : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            rank, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a launch on `s`; with `pdl`, the kernel may start while the stream's
// previous kernel runs (it waits with griddepcontrol.wait before reading
// that kernel's results)
template <typename... Params, typename... Args>
cudaError_t launch_ex(void (*kernel)(Params...), dim3 grid, dim3 block,
                      size_t smem, cudaStream_t s, bool pdl, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T, int BM, int BN>
cudaError_t launch_tile(const CUtensorMap& tx, const CUtensorMap& tw,
                        const CUtensorMap& tb, const TileArgs& a, int split,
                        cudaStream_t s) {
  const int smem = tile_smem(BM, BN, a.stages);
  cudaError_t err = cudaFuncSetAttribute(
      alora_tile_kernel<T, BM, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.T_ + BM - 1) / BM, (a.out_dim + BN - 1) / BN, split);
  // after the shrink (n > 1) the d loop overlaps it and the xa pass
  return launch_ex(alora_tile_kernel<T, BM, BN>, grid,
                   dim3(BM * 2 + kProducer), smem, s, a.n > 1, tx, tw, tb,
                   a);
}

template <typename T>
cudaError_t run(const void* x, const void* w, const void* a_stack,
                const void* b_stack, const int* idx, float* xa_part, void* xa,
                float* tile_part, void* out, int T_, int d, int out_dim,
                int n, int r, int rp, int bm, int bn, int stages, int split,
                int ksteps, int xa_split, int xa_kc, int xa_blocks,
                int reduce_blocks, cudaStream_t s) {
  constexpr bool bf = sizeof(T) == 2;
  constexpr int EPB = row_elems<T>();
  if (n > 1) {
    const int smem = shrink_smem<T>(xa_kc, rp);
    cudaError_t err = cudaFuncSetAttribute(
        alora_shrink_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    dim3 grid((T_ + kShrinkRows - 1) / kShrinkRows, xa_split, n - 1);
    alora_shrink_kernel<T><<<grid, kShrinkThreads, smem, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(a_stack), idx,
        xa_part, T_, d, r, rp, xa_kc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = launch_ex(alora_xa_kernel<T>, dim3(xa_blocks),
                    dim3(kReduceThreads), 0, s, true,
                    static_cast<const float*>(xa_part), idx,
                    static_cast<T*>(xa), T_, n, rp, xa_split);
    if (err != cudaSuccess) return err;
  }
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t es = sizeof(T);
  CUtensorMap tx, tw, tb;
  const cuuint64_t dx[2] = {(cuuint64_t)d, (cuuint64_t)T_};
  const cuuint64_t sx[1] = {d * es};
  const cuuint32_t bx[2] = {(cuuint32_t)EPB, (cuuint32_t)bm};
  const cuuint64_t dw[2] = {(cuuint64_t)out_dim, (cuuint64_t)d};
  const cuuint64_t sw[1] = {out_dim * es};
  const cuuint32_t bw[2] = {(cuuint32_t)EPB, (cuuint32_t)EPB};
  const cuuint64_t db[3] = {(cuuint64_t)out_dim, (cuuint64_t)r,
                            (cuuint64_t)n};
  const cuuint64_t sb[2] = {out_dim * es, (cuuint64_t)r * out_dim * es};
  const cuuint32_t bb[3] = {(cuuint32_t)EPB, (cuuint32_t)min(EPB, rp), 1};
  if (!encode(&tx, fn, bf, 2, x, dx, sx, bx) ||
      !encode(&tw, fn, bf, 2, w, dw, sw, bw) ||
      !encode(&tb, fn, bf, 3, b_stack, db, sb, bb))
    return cudaErrorInvalidValue;
  const TileArgs a{idx,     xa,  split == 1 ? out : tile_part,
                   T_,      out_dim, n, rp, ksteps, split, stages};
  cudaError_t err = cudaErrorInvalidValue;
  if (bm == 64 && bn == 128)
    err = launch_tile<T, 64, 128>(tx, tw, tb, a, split, s);
  else if (bm == 128 && bn == 128)
    err = launch_tile<T, 128, 128>(tx, tw, tb, a, split, s);
  else if constexpr (bf) {
    if (bm == 128 && bn == 192)
      err = launch_tile<T, 128, 192>(tx, tw, tb, a, split, s);
  }
  if (err != cudaSuccess || split == 1) return err;
  const long n4 = (long)T_ * out_dim / 4;
  return launch_ex(alora_reduce_kernel<T>, dim3(reduce_blocks),
                   dim3(kReduceThreads), 0, s, true,
                   static_cast<const float*>(tile_part), static_cast<T*>(out),
                   n4, split);
}

}  // namespace
}  // namespace repro_torch

// x (T, d), w (d, out), a_stack (n, d, r), b_stack (n, r, out) of one
// type (float32 or bf16), adapter_idx (T,) int32 -> out (T, out).  The
// launch (rp, bm, bn, stages, split, ksteps, the shrink's xa_split, xa_kc
// and xa_blocks, reduce_blocks) is alora_qkv.plan's; the scratches are
// the wrapper's: xa_part fp32 (xa_split, T, rp) and xa (T, rp) of the type
// (unused when n == 1), tile_part fp32 (split, T, out) (unused when
// split == 1).  d and out multiples of 8, 1 <= r <= 256, every pointer
// 16-byte aligned (the wrapper checks).
extern "C" int alora_qkv(const void* x, const void* w, const void* a_stack,
                         const void* b_stack, const void* adapter_idx,
                         void* xa_part, void* xa, void* tile_part, void* out,
                         int T, int d, int out_dim, int n, int r, int rp,
                         int bm, int bn, int stages, int split, int ksteps,
                         int xa_split, int xa_kc, int xa_blocks,
                         int reduce_blocks, int is_bf16, void* stream) {
  using namespace repro_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* idx = static_cast<const int*>(adapter_idx);
  float* xp = static_cast<float*>(xa_part);
  float* tp = static_cast<float*>(tile_part);
  if (is_bf16)
    return run<bf16>(x, w, a_stack, b_stack, idx, xp, xa, tp, out, T, d,
                     out_dim, n, r, rp, bm, bn, stages, split, ksteps,
                     xa_split, xa_kc, xa_blocks, reduce_blocks, s);
  return run<float>(x, w, a_stack, b_stack, idx, xp, xa, tp, out, T, d,
                    out_dim, n, r, rp, bm, bn, stages, split, ksteps,
                    xa_split, xa_kc, xa_blocks, reduce_blocks, s);
}
