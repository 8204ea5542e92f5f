// Fused dual-compact influence update for Hopper (sm_90a), hand-written CUDA.
//
// Replaces the TPU kernel src/repro/kernels/compact_fused.py::fused_update_pallas
// (body _fused_kernel).  For example b and compact row r < count_new[b]:
//
//   out[b,r,c] = hp[b,r] * ( sum_{l < count_prev[b]}
//                  J[b, idx_new[b,r], idx_prev[b,l]] * vals[b,l,c] + mbar[b,r,c] )
//
// and rows r >= count_new[b] are written as exact zeros.  idx_prev == -1 is a
// dead slot (a zero column of the gathered J tile).  The carry type T (vals,
// out) is float or __nv_bfloat16 and is converted only through the
// intrinsics, once on read and once on write.
//
// Two branches, chosen by the capacity K and the carry's type alone:
//
// The CUDA cores (K <= 256, and a bf16 carry at every K):
// fused_update_kernel<T, warps, rows>.
//   * at the paper's width (B=32, n=16, K=16, Pc_pad=256): launch latency.
//     A launch moves about 1.6 MB; the chain of dependent memory round trips
//     in a CTA sets its time.  At K = 64 (the token LM) the same;
//   * one CTA per (row tile, 128 compact columns, example b); each thread
//     holds kR rows x 4 adjacent columns of f32 accumulators, a warp kR rows.
//     Above K = 16 a warp takes 8 rows and a CTA 4 or 8 warps (32 or 64
//     rows): four l steps cost four conflict-free 128-bit shared reads of
//     vals and eight broadcast 128-bit reads of J for 128 FMAs.  At K <= 16
//     (the paper's width) a CTA takes 8 warps of 2 rows, so that its short
//     product is spread over all four schedulers of an SM instead of one
//     warp each;
//   * launch bounds of 3 CTAs an SM (80 registers);
//   * ragged counts: a CTA whose row tile starts at or past count_new[b]
//     writes zeros and returns; a warp whose rows all lie past it skips the
//     gather and the FMAs (warp-uniform) and writes zeros; the l loop ends
//     at count_prev[b], rounded up to 4 with zero J entries;
//   * grid.x walks the row tiles fastest, so the CTAs that read one vals
//     tile run together and meet it in L2;
//   * previous rows in chunks of 32 through a cp.async ring of up to 3
//     stages: the vals chunk by 16-byte copies, and the J chunk [rows][32 l]
//     gathered through the indices by 4-byte copies (each warp its own
//     rows, lane l reading J row idx_new[r] at column idx_prev[l], the
//     sentinels zero-filled); one barrier a chunk;
//   * two dependent round trips at small shapes: the counts, both index
//     rows (idx_prev into shared memory), hp, the first vals chunk and, for
//     K <= 64, the CTA's M-bar rows are issued together at the start; the J
//     gather waits only for the indices.  Above K = 64 the epilogue reads
//     M-bar itself.  A CTA past the first row tile could be dead, so it
//     waits for the counts before it loads anything.
//   On dense counts at n = 256 it ran at the rate of the f32 SIMT GEMM that
//   cuBLAS picks for the same product (torch.baddbmm).
//
// The tensor cores (an f32 carry at 256 < K <= 4096): fused_update_kernel_tc.
//   At n = 1,024 (B=8, K 512 or 1,024, Pc_pad 120,064) the f32 FMA bound of
//   the CUDA cores lies 7x above the bytes bound, so the product moves to
//   the tensor cores, in 3xTF32 to hold the f32 tolerance: each operand x
//   split into hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), and each
//   k-step of 8 previous rows three wgmma products, V_lo J_hi + V_hi J_lo +
//   V_hi J_hi (lo J_lo dropped: below 2^-22 of the product).
//   * orientation: out^T[c, r] = sum_l V[l, c] J-hat[r, l], the compact
//     columns on wgmma's M side (V, the A operand: TF32 wgmma reads only
//     K-major tiles from shared memory, and V's rows run along the columns,
//     so V goes through registers) and the new rows on its N side (J-hat, B,
//     128-byte-swizzled K-major tiles of [128 rows][32 l]);
//   * one CTA per (128 new rows, 128 compact columns, example b), two
//     warpgroups of 64 columns; m64n128k8 (m64n64k8 where 64 rows or fewer
//     of the tile are live);
//   * the tensor core's f32 adds truncate: over K = 1,024 previous rows (384
//     products into one register) that biased the result by 7e-6 of its
//     scale on an H100.  So each chunk's 4 k-steps run into registers of their own,
//     started afresh, and the CUDA cores add them to the total, rounded, at
//     the chunk's end: 3.5e-7 of the scale at K = 1,024, no bias to speak of;
//   * the next chunk's J-hat entries are gathered into registers (a warp 16
//     rows, a lane a previous row) while this chunk's first k-step runs and
//     split into their hi and lo tiles while its last one runs; the V slab
//     ([32 l][128 columns], rows padded to 136 floats so that the A
//     fragments' reads hit 32 banks) comes by cp.async two chunks ahead;
//   * the epilogue stages the total through shared memory and writes
//     hp * (acc + mbar) by whole rows; a tile whose rows all lie past
//     count_new[b] writes zeros and does no product; the l loop ends at
//     count_prev[b] rounded up to 8, with zero J-hat beyond;
//   * deterministic: no atomics and no split of the sum, and each output's
//     arithmetic (the chunks, the order of the products, the rounded adds)
//     depends on its own operands and count_prev[b] alone, never on B, Pc
//     or the place of its column in a tile: a launch on a rank's column
//     shard equals those columns of the whole launch bit for bit.
//   On an H100 at n = 1,024 it runs at about a third of the 3xTF32 peak:
//   the warps that gather J-hat also issue the wgmmas, and the gather does
//   not overlap the products.
// Both take their arguments packed in one buffer and launch through the
// driver API (driver_launch.cuh).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "driver_launch.cuh"

namespace {

constexpr int kCols = 128;     // compact columns per CTA, 4 per lane
constexpr int kChunk = 32;     // previous rows per ring stage, one per lane
constexpr int kStages = 3;     // depth of the ring
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// four adjacent carry values, widened to f32 / narrowed from f32
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &x.x, 4);
  memcpy(&hi, &x.y, 4);
  const float2 a = __bfloat1622float2(lo);
  const float2 c = __bfloat1622float2(hi);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = c.x;
  v[3] = c.y;
}
__device__ __forceinline__ void store4(float* p, const float* y) {
  *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* y) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(y[2], y[3]);
  uint2 x;
  memcpy(&x.x, &lo, 4);
  memcpy(&x.y, &hi, 4);
  *reinterpret_cast<uint2*>(p) = x;
}

// Ring stages: no more than K has chunks (a run of at most that many stages
// never wraps the ring), which keeps the footprint small at small K.
__host__ __device__ inline int ring_slots(int K) {
  const int chunks = (K + kChunk - 1) / kChunk;
  return chunks < kStages ? chunks : kStages;
}

// M-bar goes through shared memory, fetched at the start, where K has at
// most two chunks (a launch-bound size); above, the epilogue reads it.
__host__ __device__ inline bool stage_mbar(int K) { return K <= 2 * kChunk; }

// shared memory: [rows] hp, [rows] J-hat row indices, [ceil4(K)] idx_prev,
// [rows][128] M-bar where staged, then ring_slots x ([32][128] vals +
// [rows][32] J)
__host__ __device__ inline size_t smem_bytes(size_t rows, int K, size_t carry_bytes) {
  return rows * 8 + static_cast<size_t>((K + 3) & ~3) * 4 +
         (stage_mbar(K) ? rows * kCols * 4 : 0) +
         static_cast<size_t>(ring_slots(K)) * (kChunk * kCols * carry_bytes + rows * kChunk * 4);
}

template <typename T, int kWarps, int kR>
__global__ void __launch_bounds__(kWarps * 32, 3)
fused_update_kernel(const float* __restrict__ J, const T* __restrict__ vals,
                    const float* __restrict__ mbar, const float* __restrict__ hp,
                    const int* __restrict__ idx_new, const int* __restrict__ idx_prev,
                    const int* __restrict__ count_new, const int* __restrict__ count_prev,
                    T* __restrict__ out, int n, int K, int Pc, int row_tiles) {
  constexpr int kThreads = kWarps * 32;
  constexpr int kRows = kWarps * kR;                     // new rows of the CTA
  constexpr int kVCopies = kCols * sizeof(T) / 16;       // 16-byte copies a vals row
  constexpr int kVCols = 16 / sizeof(T);                 // columns a copy
  constexpr int kStageBytes = kChunk * kCols * sizeof(T) + kRows * kChunk * 4;

  extern __shared__ __align__(16) unsigned char smem[];
  float* hp_s = reinterpret_cast<float*>(smem);          // [kRows]
  int* jrow_s = reinterpret_cast<int*>(hp_s + kRows);    // [kRows] J-hat row, -1 dead
  int* idx_s = jrow_s + kRows;                           // [ceil4(K)] idx_prev[b]
  float* mbar_s = reinterpret_cast<float*>(idx_s + ((K + 3) & ~3));  // [kRows][kCols]
  const bool staged = stage_mbar(K);
  unsigned char* ring = reinterpret_cast<unsigned char*>(mbar_s + (staged ? kRows * kCols : 0));

  const int t = threadIdx.x;
  const int warp = t / 32;
  const int lane = t % 32;
  const int rt = blockIdx.x % row_tiles;                 // row tiles fastest
  const int ct = blockIdx.x / row_tiles;
  const int b = blockIdx.y;
  const int row0 = rt * kRows;
  const int wrow = kR * warp;                            // the warp's first row in the CTA
  const int col = ct * kCols + 4 * lane;                 // this thread's 4 columns
  const bool col_ok = col < Pc;                          // Pc % 8 == 0: all 4 or none
  const size_t base = static_cast<size_t>(b) * K * Pc;
  const float* Jb = J + static_cast<size_t>(b) * n * n;

  // a dead tile or warp: its rows written as exact zeros
  auto zero_rows = [&]() {
    if (!col_ok) return;
    const float y[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < kR && row0 + wrow + i < K; ++i) {
      store4(out + base + static_cast<size_t>(row0 + wrow + i) * Pc + col, y);
    }
  };

  // previous rows l < lim of chunk c copied into its stage, the rest up to
  // the next multiple of 4 (which the l loop reads) zero-filled
  auto load_vals = [&](int c, int lim) {
    T* V = reinterpret_cast<T*>(ring + (c % kStages) * kStageBytes);
    const int lread = (lim + 3) & ~3;
    for (int e = t; e < kChunk * kVCopies; e += kThreads) {
      const int ll = e / kVCopies;
      const int q = e % kVCopies;
      const int l = c * kChunk + ll;
      const int cc = ct * kCols + q * kVCols;
      if (l < lread && cc < Pc) {
        const bool ok = l < lim;
        cp_async16(V + ll * kCols + q * kVCols,
                   ok ? vals + base + static_cast<size_t>(l) * Pc + cc : vals, ok ? 16 : 0);
      }
    }
  };

  // 1st round trip: the counts, then (without waiting for them where the
  // tile is the example's first) everything that needs no index
  const int cn_raw = count_new[b];
  const int cp_raw = count_prev[b];
  int cn = K;
  int cp = K;
  if (rt > 0) {  // the tile may be dead: wait for the counts
    cn = clampi(cn_raw, 0, K);
    cp = clampi(cp_raw, 0, K);
    if (row0 >= cn) {
      zero_rows();
      return;
    }
  }
  int jrow = 0;
  if (t < kRows && row0 + t < K) {
    jrow = idx_new[static_cast<size_t>(b) * K + row0 + t];
    cp_async4(hp_s + t, hp + static_cast<size_t>(b) * K + row0 + t, 4);
  }
  for (int l = t; l < cp; l += kThreads) {
    cp_async4(idx_s + l, idx_prev + static_cast<size_t>(b) * K + l, 4);
  }
  cp_async_commit();  // the indices and hp: waited for first
  if (staged && col_ok) {
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int r = row0 + wrow + i;
      if (r < cn) {
        cp_async16(mbar_s + (wrow + i) * kCols + 4 * lane,
                   mbar + base + static_cast<size_t>(r) * Pc + col, 16);
      }
    }
  }
  load_vals(0, cp);
  cp_async_commit();  // M-bar and vals chunk 0: waited for with J chunk 0
  cn = clampi(cn_raw, 0, K);
  cp = clampi(cp_raw, 0, K);
  if (t < kRows) jrow_s[t] = row0 + t < cn ? clampi(jrow, 0, n - 1) : -1;
  cp_async_wait<1>();
  if (row0 >= cn) {  // the first tile of an example with no live row
    cp_async_wait<0>();
    zero_rows();
    return;
  }
  __syncthreads();  // idx_s, jrow_s, hp_s visible

  // 2nd round trip: J gathered through the indices, chunk by chunk.  Lane l
  // reads the warp's kR J-hat rows at column idx_prev[l], ascending across
  // the warp.
  const bool warp_live = row0 + wrow < cn;  // uniform over the warp
  auto load_j = [&](int c) {
    if (!warp_live) return;
    float* Js = reinterpret_cast<float*>(ring + (c % kStages) * kStageBytes +
                                         kChunk * kCols * sizeof(T));
    const int l = c * kChunk + lane;
    const int jc = l < cp ? idx_s[l] : -1;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int jr = jrow_s[wrow + i];
      const bool ok = jr >= 0 && jc >= 0;
      cp_async4(Js + (wrow + i) * kChunk + lane,
                ok ? Jb + static_cast<size_t>(jr) * n + min(jc, n - 1) : J, ok ? 4 : 0);
    }
  };

  float acc[kR][4];
#pragma unroll
  for (int i = 0; i < kR; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const int chunks = (cp + kChunk - 1) / kChunk;
  if (chunks > 0) load_j(0);
  cp_async_commit();
  if (chunks > 1) {
    load_vals(1, cp);
    load_j(1);
  }
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<1>();  // this thread's copies of chunk c (and M-bar) landed
    __syncthreads();     // everyone's; and chunk c-1's stage is free
    if (c + 2 < chunks) {
      load_vals(c + 2, cp);
      load_j(c + 2);
    }
    cp_async_commit();
    if (!warp_live) continue;
    const unsigned char* stage = ring + (c % kStages) * kStageBytes;
    const T* V = reinterpret_cast<const T*>(stage) + 4 * lane;
    const float* Jw = reinterpret_cast<const float*>(stage + kChunk * kCols * sizeof(T)) +
                      wrow * kChunk;
    const int quads = (min(kChunk, cp - c * kChunk) + 3) / 4;
    for (int q = 0; q < quads; ++q) {
      float v[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) load4(V + (4 * q + u) * kCols, v[u]);
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const float4 j = *reinterpret_cast<const float4*>(Jw + i * kChunk + 4 * q);
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // l = 4q, 4q+1, 4q+2, 4q+3 in order
          float a = acc[i][k];
          a = fmaf(j.x, v[0][k], a);
          a = fmaf(j.y, v[1][k], a);
          a = fmaf(j.z, v[2][k], a);
          a = fmaf(j.w, v[3][k], a);
          acc[i][k] = a;
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!warp_live) {
    zero_rows();
    return;
  }
  if (!col_ok) return;
  // rows r < cn get hp * (acc + mbar), the rest exact zeros
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = row0 + wrow + i;
    if (r >= K) break;
    float y[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < cn) {
      const float h = hp_s[wrow + i];
      const float4 mb = *reinterpret_cast<const float4*>(
          staged ? mbar_s + (wrow + i) * kCols + 4 * lane
                 : mbar + base + static_cast<size_t>(r) * Pc + col);
      y[0] = h * (acc[i][0] + mb.x);
      y[1] = h * (acc[i][1] + mb.y);
      y[2] = h * (acc[i][2] + mb.z);
      y[3] = h * (acc[i][3] + mb.w);
    }
    store4(out + base + static_cast<size_t>(r) * Pc + col, y);
  }
}

// ---------------------------------------------------------------------------
// The tensor-core branch: an f32 carry at tc::kMinK <= K <= tc::kMaxK
// ---------------------------------------------------------------------------

namespace tc {
constexpr int kRows = 128;                  // new rows a CTA: wgmma's N
constexpr int kCols = 128;                  // compact columns a CTA: 64 a warpgroup (wgmma's M)
constexpr int kThreads = 256;               // two warpgroups
constexpr int kL = 32;                      // previous rows a chunk: 4 k-steps of 8, one swizzled row
constexpr int kStages = 3;                  // V slabs and J-hat tile pairs in the ring
constexpr int kVStride = kCols + 8;         // floats a V slab row: the A reads hit 32 banks
constexpr int kOStride = kCols + 4;         // floats a staged output row: the stores hit 32 banks
constexpr int kTile = kRows * kL * 4;       // bytes of one J-hat tile (hi or lo)
constexpr int kSlab = kL * kVStride * 4;    // bytes of one V slab
constexpr int kMinK = 257;
constexpr int kMaxK = 4096;

// shared memory: 1 KB to align the swizzled tiles, kStages x ([hi, lo] J-hat
// tiles + V slab), [kRows] hp, [kRows] J-hat row indices, [ceil8(K)] idx_prev;
// the epilogue's [kRows][kOStride] staging reuses the ring
__host__ __device__ inline size_t smem_bytes(int K) {
  return 1024 + kStages * static_cast<size_t>(2 * kTile + kSlab) + 2 * kRows * 4 +
         static_cast<size_t>((K + 7) & ~7) * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x = hi + lo + (a residue below 2^-22 |x|): hi is x rounded to TF32 (nearest,
// ties away), lo the remainder, rounded likewise; both in an f32 container
// with the 13 bits the tensor core ignores zero
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  uint32_t h, l;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(h) : "f"(x));
  h &= 0xffffe000u;
  const float rest = x - __uint_as_float(h);  // exact
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(l) : "f"(rest));
  hi = h;
  lo = l & 0xffffe000u;
}

// wgmma descriptor of a K-major tile of 128-byte rows in the 128-byte swizzle,
// 8-row groups 1024 bytes apart (the tile 1024-byte aligned)
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x N] = A[64 x 8] B[8 x N] (+ D where scale_d): A (tf32) from registers,
// B (tf32) a K-major tile in shared memory, D f32 in registers
__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t* a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(float* d, const uint32_t* a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// one k-step of 8 previous rows: V_lo J_hi, V_hi J_lo, V_hi J_hi, in that
// order, the first starting the run afresh where `fresh`; over the first 64
// new rows only where no more are live
__device__ __forceinline__ void mma_step(float (&d)[64], const uint32_t (&a)[8], uint64_t dhi,
                                         uint64_t dlo, bool narrow, int fresh) {
  if (narrow) {
    wgmma_n64(d, a + 4, dhi, !fresh);
    wgmma_n64(d, a, dlo, 1);
    wgmma_n64(d, a, dhi, 1);
  } else {
    wgmma_n128(d, a + 4, dhi, !fresh);
    wgmma_n128(d, a, dlo, 1);
    wgmma_n128(d, a, dhi, 1);
  }
}

}  // namespace tc

// The tensor-core branch: one CTA per (128 new rows, 128 compact columns,
// example b), a warpgroup per 64 columns.  Each example's product is
// out^T[c, r] = sum_l V[l, c] J-hat[r, l]: the compact columns on wgmma's M
// side (V, the A operand, from registers) and the new rows on its N side
// (J-hat, B, K-major in shared memory), in 3xTF32.  A chunk's 4 k-steps
// accumulate in a run of their own (`part`, the tensor core's f32 adds,
// which truncate), added to the total (`acc`) by the CUDA cores' rounded
// adds at the chunk's end.
__global__ void __launch_bounds__(tc::kThreads, 1)
fused_update_kernel_tc(const float* __restrict__ J, const float* __restrict__ vals,
                       const float* __restrict__ mbar, const float* __restrict__ hp,
                       const int* __restrict__ idx_new, const int* __restrict__ idx_prev,
                       const int* __restrict__ count_new, const int* __restrict__ count_prev,
                       float* __restrict__ out, int n, int K, int Pc, int row_tiles) {
  constexpr int kRows = tc::kRows, kCols = tc::kCols, kThreads = tc::kThreads, kL = tc::kL;
  constexpr int kStages = tc::kStages, kVStride = tc::kVStride, kOStride = tc::kOStride;
  constexpr int kTile = tc::kTile;
  using tc::smem_u32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* jt = smem;                                           // [kStages][hi, lo][kRows][kL]
  float* vs = reinterpret_cast<float*>(smem + kStages * 2 * kTile);  // [kStages][kL][kVStride]
  float* hp_s = vs + kStages * kL * kVStride;                         // [kRows]
  int* jrow_s = reinterpret_cast<int*>(hp_s + kRows);                 // [kRows], -1 dead
  int* idx_s = jrow_s + kRows;                                        // [ceil8(K)]
  float* os = reinterpret_cast<float*>(smem);                         // [kRows][kOStride]

  const int t = threadIdx.x;
  const int warp = t / 32;
  const int lane = t % 32;
  const int rt = blockIdx.x % row_tiles;  // row tiles fastest
  const int ct = blockIdx.x / row_tiles;
  const int b = blockIdx.y;
  const int row0 = rt * kRows;
  const int col0 = ct * kCols;
  const int rows = min(kRows, K - row0);  // rows of the tile inside the carry
  const size_t base = static_cast<size_t>(b) * K * Pc;
  const int cn = clampi(count_new[b], 0, K);
  const int cp = clampi(count_prev[b], 0, K);

  if (row0 >= cn) {  // a dead tile: exact zeros
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int e = t; e < rows * (kCols / 4); e += kThreads) {
      const int c = col0 + 4 * (e % (kCols / 4));
      if (c < Pc) {
        *reinterpret_cast<float4*>(out + base + static_cast<size_t>(row0 + e / (kCols / 4)) * Pc +
                                   c) = z;
      }
    }
    return;
  }
  const int live = min(cn - row0, kRows);  // the tile's live rows; the rest are zeros
  const bool narrow = live <= 64;          // N = 64 covers them
  const int lend = (cp + 7) & ~7;          // previous rows read: zero J-hat from cp on
  const int chunks = (cp + kL - 1) / kL;

  // V rows of chunk c below cp copied, the rest of the chunk and columns
  // past Pc zero-filled
  auto load_v = [&](int c) {
    float* V = vs + (c % kStages) * kL * kVStride;
#pragma unroll
    for (int i = 0; i < kL * kCols / 4 / kThreads; ++i) {
      const int e = t + i * kThreads;
      const int ll = e / (kCols / 4);
      const int q = e % (kCols / 4);
      const int l = c * kL + ll;
      const int col = col0 + 4 * q;
      const bool ok = l < cp && col < Pc;
      cp_async16(V + ll * kVStride + 4 * q,
                 ok ? vals + base + static_cast<size_t>(l) * Pc + col : vals, ok ? 16 : 0);
    }
  };
  load_v(0);
  cp_async_commit();
  if (chunks > 1) load_v(1);
  cp_async_commit();
  for (int l = t; l < cp; l += kThreads) idx_s[l] = idx_prev[static_cast<size_t>(b) * K + l];
  if (t < kRows) {
    const bool ok = t < live;
    jrow_s[t] = ok ? clampi(idx_new[static_cast<size_t>(b) * K + row0 + t], 0, n - 1) : -1;
    hp_s[t] = ok ? hp[static_cast<size_t>(b) * K + row0 + t] : 0.f;
  }
  __syncthreads();  // idx_s, jrow_s, hp_s

  // J-hat chunk c: warp w gathers rows 16w..16w+15, lane the chunk's l; split
  // into the hi and lo tiles of stage c % kStages
  const float* Jb = J + static_cast<size_t>(b) * n * n;
  float jv[16];
  auto gather_j = [&](int c) {
    const int l = c * kL + lane;
    const int jc = l < cp ? min(idx_s[l], n - 1) : -1;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int jr = jrow_s[16 * warp + i];
      jv[i] = jr >= 0 && jc >= 0 ? __ldg(Jb + static_cast<size_t>(jr) * n + jc) : 0.f;
    }
  };
  auto store_j = [&](int c) {
    unsigned char* hi = jt + (c % kStages) * 2 * kTile;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int off = (16 * warp + i) * 128 + (((lane >> 2) ^ (i & 7)) << 4) + (lane & 3) * 4;
      uint32_t h, l;
      tc::split_tf32(jv[i], h, l);
      *reinterpret_cast<uint32_t*>(hi + off) = h;
      *reinterpret_cast<uint32_t*>(hi + kTile + off) = l;
    }
  };

  // A fragment of k-step s of chunk c: this thread's columns g, g + 8 of its
  // warp's 16, previous rows tq, tq + 4 of the step's 8; hi in [0, 4), lo in
  // [4, 8)
  const int wg = t / 128;
  const int g = lane / 4;
  const int tq = lane % 4;
  auto load_a = [&](int c, int s, uint32_t (&a)[8]) {
    const float* p = vs + (c % kStages) * kL * kVStride + (8 * s + tq) * kVStride + 64 * wg +
                     16 * (warp % 4) + g;
    const float x[4] = {p[0], p[8], p[4 * kVStride], p[4 * kVStride + 8]};
#pragma unroll
    for (int k = 0; k < 4; ++k) tc::split_tf32(x[k], a[k], a[4 + k]);
  };

  float acc[64];   // the f32 total
  float part[64];  // the chunk's run on the tensor cores
#pragma unroll
  for (int q = 0; q < 64; ++q) acc[q] = part[q] = 0.f;
  uint32_t a[2][8];  // [k-step parity]: a step's registers stay untouched while it runs
  if (chunks > 0) {
    gather_j(0);
    store_j(0);
  }
  tc::fence_proxy_async();
  cp_async_wait<1>();
  __syncthreads();  // J-hat chunk 0 and V chunk 0
  for (int c = 0; c < chunks; ++c) {
    const int steps = min(4, (lend - c * kL) / 8);
    const bool next = c + 1 < chunks;
    const uint64_t dhi = tc::desc_sw128(jt + (c % kStages) * 2 * kTile);
    const uint64_t dlo = dhi + (kTile >> 4);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (s < steps) {
        load_a(c, s, a[s & 1]);
        tc::wgmma_fence();
        tc::mma_step(part, a[s & 1], dhi + 2 * s, dlo + 2 * s, narrow, s == 0);  // +32 bytes a step
        tc::wgmma_commit();
      }
      if (s == 0) {
        if (next) gather_j(c + 1);  // lands while the steps run
        if (c + 2 < chunks) load_v(c + 2);
        cp_async_commit();
      }
      if (s < 3) tc::wgmma_wait<1>();  // step s - 1 done: its registers free
    }
    if (next) {  // into chunk c - 2's tiles, free since the last barrier
      store_j(c + 1);
      tc::fence_proxy_async();
    }
    tc::wgmma_wait<0>();
    tc::fence_regs(part);
#pragma unroll
    for (int q = 0; q < 64; ++q) acc[q] += part[q];
    cp_async_wait<1>();
    __syncthreads();  // J-hat and V of chunk c + 1 visible; chunk c - 1's free
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring free

  // the total staged as [row][column]: element q is column 64 wg + 16 (warp
  // % 4) + g + 8 ((q >> 1) & 1), row 8 (q >> 2) + 2 tq + (q & 1)
#pragma unroll
  for (int q = 0; q < 64; ++q) {
    const int r = 8 * (q >> 2) + 2 * tq + (q & 1);
    const int cc = 64 * wg + 16 * (warp % 4) + g + 8 * ((q >> 1) & 1);
    os[r * kOStride + cc] = acc[q];
  }
  __syncthreads();
  // rows r < cn get hp * (acc + mbar), the rest exact zeros; a warp a row
  const int col = col0 + 4 * lane;
  if (col >= Pc) return;
#pragma unroll 4
  for (int rr = warp; rr < rows; rr += kThreads / 32) {
    const size_t row = base + static_cast<size_t>(row0 + rr) * Pc;
    float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
    if (rr < live) {
      const float hh = hp_s[rr];
      const float4 s4 = *reinterpret_cast<const float4*>(os + rr * kOStride + 4 * lane);
      const float4 mb = *reinterpret_cast<const float4*>(mbar + row + col);
      y.x = hh * (s4.x + mb.x);
      y.y = hh * (s4.y + mb.y);
      y.z = hh * (s4.z + mb.z);
      y.w = hh * (s4.w + mb.w);
    }
    *reinterpret_cast<float4*>(out + row + col) = y;
  }
}

// The launch arguments, packed by the wrapper as 15 64-bit ints in one
// buffer: one ctypes argument to convert instead of 15.
struct FusedArgs {
  unsigned long long J, vals, mbar, hp, idx_new, idx_prev, count_new, count_prev, out, B, n,
      K, Pc, bf16, stream;
};

// One instantiation: the carry type, the warps of a CTA and the rows of a
// warp; or the tensor-core branch.
struct Instance {
  const void* fn;
  int warps;
  int rows;  // of a CTA
  int cols;  // of a CTA
  size_t smem;
  int slot;  // index among the instantiations, for the per-device caches
  int stages;
  bool tensor_cores;
};

constexpr int kKernels = 7;

// An f32 carry at 256 < K <= 4096: the tensor-core branch.  Else K <= 16 (the
// paper's width): 8 warps of 2 rows, so that a CTA's product is spread over
// all 4 schedulers of its SM; else 8-row warps, 4 or 8 of them.
Instance instance(int K, bool bf16) {
  Instance in;
  if (!bf16 && K >= tc::kMinK && K <= tc::kMaxK) {
    in.fn = reinterpret_cast<const void*>(fused_update_kernel_tc);
    in.warps = tc::kThreads / 32;
    in.rows = tc::kRows;
    in.cols = tc::kCols;
    in.smem = tc::smem_bytes(K);
    in.slot = 6;
    in.stages = tc::kStages;
    in.tensor_cores = true;
    return in;
  }
  const int shape = K <= 16 ? 0 : K <= 32 ? 1 : 2;
  static const void* const fns[2][3] = {
      {reinterpret_cast<const void*>(fused_update_kernel<float, 8, 2>),
       reinterpret_cast<const void*>(fused_update_kernel<float, 4, 8>),
       reinterpret_cast<const void*>(fused_update_kernel<float, 8, 8>)},
      {reinterpret_cast<const void*>(fused_update_kernel<__nv_bfloat16, 8, 2>),
       reinterpret_cast<const void*>(fused_update_kernel<__nv_bfloat16, 4, 8>),
       reinterpret_cast<const void*>(fused_update_kernel<__nv_bfloat16, 8, 8>)}};
  in.fn = fns[bf16][shape];
  in.warps = shape == 1 ? 4 : 8;
  in.rows = shape == 0 ? 16 : 8 * in.warps;
  in.cols = kCols;
  in.smem = smem_bytes(in.rows, K, bf16 ? 2 : 4);
  in.slot = shape + (bf16 ? 3 : 0);
  in.stages = ring_slots(K);
  in.tensor_cores = false;
  return in;
}

// Dynamic shared memory past 48 KB is raised once a device and
// instantiation, to the most any call asked for.
int allow_smem(const Instance& in) {
  if (in.smem > kMaxSmem) return -2;
  if (in.smem <= 48 * 1024) return 0;
  static size_t raised[64][kKernels] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (in.smem > raised[dev][in.slot]) {
    e = cudaFuncSetAttribute(in.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(in.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    raised[dev][in.slot] = in.smem;
  }
  return 0;
}

}  // namespace

extern "C" {

// Launches the kernel on the packed arguments (bf16 non-zero for a bf16
// carry) through the driver API (driver_launch.cuh).  Returns 0 when
// launched, the launch's error otherwise; -1 for Pc not a multiple of 8 or
// n < 1, -2 for a grid or shared memory the card cannot take.
int repro_fused_update(const void* packed) {
  FusedArgs a;
  memcpy(&a, packed, sizeof a);
  const int n = static_cast<int>(a.n);
  int K = static_cast<int>(a.K);
  int Pc = static_cast<int>(a.Pc);
  if (Pc % 8 != 0 || n < 1) return -1;
  if (a.B == 0 || K == 0 || Pc == 0) return 0;
  const Instance in = instance(K, a.bf16 != 0);
  int row_tiles = (K + in.rows - 1) / in.rows;
  const long long tiles = static_cast<long long>(row_tiles) * ((Pc + in.cols - 1) / in.cols);
  if (a.B > 65535 || tiles > 0x7fffffffLL) return -2;
  const int err = allow_smem(in);
  if (err != 0) return err;
  static repro::DriverFunction handles[kKernels];
  auto ptr = [](unsigned long long p) { return reinterpret_cast<void*>(static_cast<uintptr_t>(p)); };
  void* J = ptr(a.J);
  void* vals = ptr(a.vals);
  void* mbar = ptr(a.mbar);
  void* hp = ptr(a.hp);
  void* idx_new = ptr(a.idx_new);
  void* idx_prev = ptr(a.idx_prev);
  void* count_new = ptr(a.count_new);
  void* count_prev = ptr(a.count_prev);
  void* out = ptr(a.out);
  int n_arg = n;
  void* params[] = {&J,   &vals,       &mbar,  &hp, &idx_new, &idx_prev, &count_new,
                    &count_prev, &out, &n_arg, &K,  &Pc,      &row_tiles};
  return repro::driver_launch(handles[in.slot], in.fn,
                              dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(a.B)),
                              32 * in.warps, in.smem,
                              reinterpret_cast<cudaStream_t>(static_cast<uintptr_t>(a.stream)),
                              params);
}

// The launch at capacity K and this carry: out = {warps, threads and rows a
// CTA, dynamic shared bytes, registers and spilled bytes a thread, CTAs
// resident on an SM, ring stages, 1 for the tensor-core branch, columns a
// CTA}.  Returns 0, or an error as repro_fused_update.
int repro_fused_geometry(int K, int bf16, long long* out) {
  if (K < 1) return -1;
  const Instance in = instance(K, bf16 != 0);
  int err = allow_smem(in);
  if (err != 0) return err;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, in.fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  int resident = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, in.fn, 32 * in.warps, in.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = in.warps;
  out[1] = 32 * in.warps;
  out[2] = in.rows;
  out[3] = static_cast<long long>(in.smem);
  out[4] = attr.numRegs;
  out[5] = static_cast<long long>(attr.localSizeBytes);
  out[6] = resident;
  out[7] = in.stages;
  out[8] = in.tensor_cores ? 1 : 0;
  out[9] = in.cols;
  return 0;
}

const char* repro_error_string(int err) {
  if (err == -1) return "Pc must be a multiple of 8 and n at least 1";
  if (err == -2) return "grid or shared memory too large (B above 65535, or K too large)";
  return repro::error_string(err);
}

}  // extern "C"
