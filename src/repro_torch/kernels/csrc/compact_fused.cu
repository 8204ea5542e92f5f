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
// What bounds it on an H100: at the paper's width (n=16, B=32, K=16,
// Pc_pad=256) one launch moves about 1.6 MB — under a microsecond of HBM
// time — so launch overhead sets the pace.  At n=256 (K=256, Pc_pad=20864,
// B=4) the f32 carry alone is 85 MB and the work, 2*count_new*count_prev*Pc
// FLOPs per example, is bound by the CUDA cores' f32 FMA rate or by bytes,
// depending on how ragged the counts are.
//
// Design (simple and right first; no tensor cores, no TMA yet):
//   * one CTA per (block of kRows new rows, tile of kCols compact columns,
//     example b); 128 threads, one column each, kRows f32 accumulators in
//     registers;
//   * ragged row skip: a CTA whose row block starts at or past count_new[b]
//     writes zeros and returns;
//   * ragged previous-row skip: the l loop ends at count_prev[b].  The
//     kRows x count_prev tile of J is gathered through the indices into
//     shared memory, kChunk previous rows at a time;
//   * each l step reads vals[b,l,col], coalesced across the warp, and does
//     kRows FMAs with J values broadcast from shared memory;
//   * blockIdx.x (fastest) walks the row blocks, so the CTAs that re-read
//     one example's vals tile run close in time and find it in L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 128;   // compact columns per CTA, one per thread
constexpr int kRows = 16;    // new rows per CTA, one accumulator each
constexpr int kChunk = 128;  // previous rows staged in shared memory at once

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kCols)
fused_update_kernel(const float* __restrict__ J, const T* __restrict__ vals,
                    const float* __restrict__ mbar,
                    const float* __restrict__ hp,
                    const int* __restrict__ idx_new,
                    const int* __restrict__ idx_prev,
                    const int* __restrict__ count_new,
                    const int* __restrict__ count_prev, T* __restrict__ out,
                    int n, int K, int Pc) {
  __shared__ __align__(16) float Js[kChunk * kRows];  // [l][r], r fastest
  __shared__ int rows_s[kRows];

  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kRows;
  const int col = blockIdx.y * kCols + threadIdx.x;
  const bool col_ok = col < Pc;
  const size_t base = static_cast<size_t>(b) * K * Pc;
  const int cn = min(max(count_new[b], 0), K);

  if (row0 >= cn) {  // ragged row-block skip: every row of the block is dead
    if (col_ok) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (row0 + i < K) {
          out[base + static_cast<size_t>(row0 + i) * Pc + col] = from_f32<T>(0.f);
        }
      }
    }
    return;
  }

  const int cp = min(max(count_prev[b], 0), K);
  const float* Jb = J + static_cast<size_t>(b) * n * n;
  const int* prev_b = idx_prev + static_cast<size_t>(b) * K;
  if (threadIdx.x < kRows) {
    const int r = row0 + threadIdx.x;
    // J-hat row of each live new row (clamped like the TPU kernel); -1 marks
    // a dead row, whose tile entries are zero and whose output is zero
    rows_s[threadIdx.x] =
        r < cn ? min(max(idx_new[static_cast<size_t>(b) * K + r], 0), n - 1) : -1;
  }

  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;

  for (int l0 = 0; l0 < cp; l0 += kChunk) {
    const int len = min(kChunk, cp - l0);
    __syncthreads();  // rows_s written / previous chunk fully consumed
    // gather the kRows x len tile; consecutive threads walk l, so they read
    // one J row at ascending (sorted) column indices
    for (int e = threadIdx.x; e < len * kRows; e += kCols) {
      const int ll = e % len;
      const int r = e / len;
      const int jr = rows_s[r];
      const int jc = prev_b[l0 + ll];
      float v = 0.f;
      if (jr >= 0 && jc >= 0) v = Jb[static_cast<size_t>(jr) * n + min(jc, n - 1)];
      Js[ll * kRows + r] = v;
    }
    __syncthreads();
    if (col_ok) {
      const T* vp = vals + base + static_cast<size_t>(l0) * Pc + col;
#pragma unroll 4
      for (int ll = 0; ll < len; ++ll) {
        const float v = to_f32(vp[static_cast<size_t>(ll) * Pc]);
        const float4* jt = reinterpret_cast<const float4*>(&Js[ll * kRows]);
#pragma unroll
        for (int q = 0; q < kRows / 4; ++q) {
          const float4 j4 = jt[q];
          acc[4 * q + 0] = fmaf(j4.x, v, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(j4.y, v, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(j4.z, v, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(j4.w, v, acc[4 * q + 3]);
        }
      }
    }
  }

  if (!col_ok) return;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = row0 + i;
    if (r < K) {
      const size_t o = base + static_cast<size_t>(r) * Pc + col;
      float y = 0.f;  // rows past count_new: exact zeros
      if (r < cn) y = hp[static_cast<size_t>(b) * K + r] * (acc[i] + mbar[o]);
      out[o] = from_f32<T>(y);
    }
  }
}

template <typename T>
int launch(const void* J, const void* vals, const void* mbar, const void* hp,
           const void* idx_new, const void* idx_prev, const void* count_new,
           const void* count_prev, void* out, int B, int n, int K, int Pc,
           cudaStream_t stream) {
  if (B == 0 || K == 0 || Pc == 0) return 0;
  const dim3 grid((K + kRows - 1) / kRows, (Pc + kCols - 1) / kCols, B);
  fused_update_kernel<T><<<grid, kCols, 0, stream>>>(
      static_cast<const float*>(J), static_cast<const T*>(vals),
      static_cast<const float*>(mbar), static_cast<const float*>(hp),
      static_cast<const int*>(idx_new), static_cast<const int*>(idx_prev),
      static_cast<const int*>(count_new), static_cast<const int*>(count_prev),
      static_cast<T*>(out), n, K, Pc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float carry, 1 = bfloat16 carry.  Returns cudaGetLastError()
// after the launch (0 = launched); -1 for an unknown dtype, -2 for a grid the
// card cannot take.
int repro_fused_update(int dtype, const void* J, const void* vals,
                       const void* mbar, const void* hp, const void* idx_new,
                       const void* idx_prev, const void* count_new,
                       const void* count_prev, void* out, int B, int n, int K,
                       int Pc, void* stream) {
  if ((Pc + kCols - 1) / kCols > 65535 || B > 65535) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(J, vals, mbar, hp, idx_new, idx_prev, count_new,
                         count_prev, out, B, n, K, Pc, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(J, vals, mbar, hp, idx_new, idx_prev,
                                 count_new, count_prev, out, B, n, K, Pc, s);
  return -1;
}

const char* repro_error_string(int err) {
  if (err == -1) return "unknown carry dtype code";
  if (err == -2) return "grid too large (Pc / 128 or B above 65535)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
