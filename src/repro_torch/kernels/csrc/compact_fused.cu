// Fused dual-compact influence update for Hopper (sm_90a), hand-written CUDA.
//
// Replaces the TPU kernel src/repro/kernels/compact_fused.py::fused_update_pallas
// (body _fused_kernel).  For example b and compact row r < count_new[b]:
//
//   out[b,r,c] = hp[b,r] * ( sum_{l < count_prev[b]}
//                  J[b, idx_new[b,r], idx_prev[b,l]] * vals[b,l,c] + mbar[b,r,c] )
//
// and rows r >= count_new[b] are written as exact zeros.  idx_prev == -1 is a
// dead slot (a zero column of the gathered J tile).  Accumulation is f32 in
// the order l = 0, 1, ... with fmaf; the carry type T (vals, out) is float or
// __nv_bfloat16 and is converted only through the intrinsics, once on read
// and once on write.
//
// What bounds it on an H100:
//   * at n=256 (B=4, K=256, Pc_pad=20864, ragged counts): operations.  The
//     live rows need 2 FLOP per (new row, previous row, column), 3.9 GFLOP,
//     59 us at the 67 TFLOP/s f32 CUDA-core peak, against 174 MB, 52 us of
//     HBM time;
//   * at the paper's width (B=32, n=16, K=16, Pc_pad=256): launch latency.
//     A launch moves about 1.6 MB; the chain of dependent memory round trips
//     in a CTA sets its time.
// No tensor cores: at n=256 the bytes floor lies within 12 % of the f32 FMA
// bound, and the f32 tolerance would need 3xTF32, three products for one; at
// the paper's width there is no tile for them to fill.
//
// Design (16 rows x 1 column a thread, with J gathered between two
// barriers, spends a third of the issue slots on loads and loop overhead,
// reads each vals tile from L2 once per 16 rows and issues no FMA during
// the gather):
//   * one CTA per (row tile, 128 compact columns, example b); each thread
//     holds kR rows x 4 adjacent columns of f32 accumulators, a warp kR rows.
//     Above K = 16 a warp takes 8 rows and a CTA 4 or 8 warps (32 or 64
//     rows): four l steps cost four conflict-free 128-bit shared reads of
//     vals and eight broadcast 128-bit reads of J for 128 FMAs.  At K <= 16
//     (the paper's width) a CTA takes 8 warps of 2 rows, so that its short
//     product is spread over all four schedulers of an SM instead of one
//     warp each;
//   * launch bounds of 3 CTAs an SM (80 registers): at n=256 the shared
//     memory of 3 CTAs fits, and 24 warps an SM ran faster than 16;
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
//     M-bar itself, which leaves the shared memory for a third CTA an SM.
//     A CTA past the first row tile could be dead, so it waits for the
//     counts before it loads anything;
//   * the host side takes its arguments packed in one buffer and launches
//     through the driver API (driver_launch.cuh).
// At n=256 this reaches 38 % of the FMA bound on an H100.  On dense counts it
// runs at the rate of the f32 SIMT GEMM that cuBLAS picks for the same
// product (torch.baddbmm), and the same loop with no loads at all is not
// much faster: the per-CTA chain (counts, indices, gather, epilogue) and the
// CTA waves, not the memory traffic, hold it there.
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

// The launch arguments, packed by the wrapper as 15 64-bit ints in one
// buffer: one ctypes argument to convert instead of 15.
struct FusedArgs {
  unsigned long long J, vals, mbar, hp, idx_new, idx_prev, count_new, count_prev, out, B, n,
      K, Pc, bf16, stream;
};

// One instantiation: the carry type, the warps of a CTA and the rows of a
// warp.
struct Instance {
  const void* fn;
  int warps;
  int rows;  // of a CTA
  size_t smem;
  int slot;  // index among the instantiations, for the per-device caches
};

constexpr int kKernels = 6;

// K <= 16 (the paper's width): 8 warps of 2 rows, so that a CTA's product is
// spread over all 4 schedulers of its SM; else 8-row warps, 4 or 8 of them.
Instance instance(int K, bool bf16) {
  Instance in;
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
  in.smem = smem_bytes(in.rows, K, bf16 ? 2 : 4);
  in.slot = shape + (bf16 ? 3 : 0);
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
  const long long tiles = static_cast<long long>(row_tiles) * ((Pc + kCols - 1) / kCols);
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
// resident on an SM, ring stages}.  Returns 0, or an
// error as repro_fused_update.
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
  out[7] = ring_slots(K);
  return 0;
}

const char* repro_error_string(int err) {
  if (err == -1) return "Pc must be a multiple of 8 and n at least 1";
  if (err == -2) return "grid or shared memory too large (B above 65535, or K too large)";
  return repro::error_string(err);
}

}  // extern "C"
