// Block-sparse influence update on the dense flat carry, for Hopper (sm_90a),
// hand-written CUDA.
//
// Replaces the TPU kernel src/repro/kernels/influence.py::influence_update_pallas
// (body _kernel).  On operands padded to n % 8 == 0 and P % 128 == 0, for
// example b, row k and column p:
//
//   out[b,k,p] = hp[b,k] * ( sum over live l-blocks lb, l in lb, ascending
//                              J[b,k,l] * M[b,l,p]  +  Mbar[b,k,p] )
//
// Four int32 block masks name the work to skip, as on the TPU:
//   row_mask[b,kb] == 0 or col_mask[pb] == 0  -> the 8 x 128 output block is
//                                                written as exact zeros;
//   prev_mask[b,lb] == 0 or jmask[kb,lb] == 0 -> l-block lb is skipped.
// Accumulation is f32 with fmaf in ascending l.  The carry is f32 only (the
// reference refuses a bf16 dense carry).
//
// What bounds it on an H100: bytes.  An executed block does 2*8*8*128 FLOP
// on the 4 KB of M it reads, 2 FLOP a byte, far below the card's f32 ratio
// (67 TFLOP/s over 3.35 TB/s = 20).  At the spiral width (B=32, n=16,
// P=1024) one launch moves a few MB: launch overhead sets the pace.  At
// n=256, P=20864, B=4 each of M, M-bar and the output is 85 MB.
//
// Design (simple and right first; no tensor cores, no TMA yet):
//   * one CTA per (column block pb of 128, row block kb of 8, example b):
//     grid.x walks column blocks (P/128 can pass 65535), grid.y row blocks,
//     grid.z examples; 128 threads, one column each, 8 f32 accumulators;
//   * a dead row or column block writes zeros and returns;
//   * l-blocks go in chunks of kChunk: the CTA marks the chunk's live blocks
//     in shared memory, stages their 8 x 8 J tiles there (l-major, so one
//     l's 8 row values are two float4 reads), then for each live block reads
//     its 8 rows of M, coalesced across the CTA, and does 64 fmaf;
//   * M-bar is added, the sum scaled by hp and written;
//   * an optional counter: thread 0 adds the CTA's executed l-blocks.
//   The n/8 row-block CTAs of one column block each read that column block
//   of M again; when M passes the 50 MB L2 those re-reads go to HBM.
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 128;  // columns per CTA (bp), one per thread
constexpr int kRows = 8;    // output rows per CTA (bk)
constexpr int kL = 8;       // rows of M per l-block (bl)
constexpr int kChunk = 32;  // l-blocks staged in shared memory at once

__global__ void __launch_bounds__(kCols)
influence_kernel(const float* __restrict__ hp, const float* __restrict__ J,
                 const float* __restrict__ M, const float* __restrict__ Mbar,
                 const int* __restrict__ row_mask,
                 const int* __restrict__ prev_mask,
                 const int* __restrict__ col_mask,
                 const int* __restrict__ jmask, float* __restrict__ out,
                 unsigned long long* __restrict__ block_count, int n, int P) {
  __shared__ __align__(16) float Js[kChunk * kL * kRows];  // [l][r], r fastest
  __shared__ int live_s[kChunk];

  const int pb = blockIdx.x;
  const int kb = blockIdx.y;
  const int b = blockIdx.z;
  const int nb = n / kL;  // l-blocks, and row blocks
  const int col = pb * kCols + threadIdx.x;
  // flattened (b, k) index of the CTA's first output row
  const size_t row0 = static_cast<size_t>(b) * n + static_cast<size_t>(kb) * kRows;

  if (row_mask[static_cast<size_t>(b) * nb + kb] == 0 || col_mask[pb] == 0) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) out[(row0 + r) * P + col] = 0.f;
    return;
  }

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  int executed = 0;
  const float* Jk = J + row0 * n;  // row kb*8 of J[b]
  const float* Mb = M + static_cast<size_t>(b) * n * P + col;

  for (int c0 = 0; c0 < nb; c0 += kChunk) {
    const int len = min(kChunk, nb - c0);
    __syncthreads();  // the previous chunk's tiles are consumed
    if (threadIdx.x < len) {
      const int lb = c0 + threadIdx.x;
      live_s[threadIdx.x] = prev_mask[static_cast<size_t>(b) * nb + lb] != 0 &&
                            jmask[static_cast<size_t>(kb) * nb + lb] != 0;
    }
    __syncthreads();
    // stage the live blocks' tiles; consecutive threads read consecutive
    // columns of one J row
    const int width = len * kL;
    for (int e = threadIdx.x; e < kRows * width; e += kCols) {
      const int r = e / width;
      const int c = e - r * width;
      if (live_s[c / kL]) {
        Js[c * kRows + r] = Jk[static_cast<size_t>(r) * n + c0 * kL + c];
      }
    }
    __syncthreads();
    for (int i = 0; i < len; ++i) {
      if (!live_s[i]) continue;  // uniform across the CTA
      ++executed;
      const float* mp = Mb + static_cast<size_t>((c0 + i) * kL) * P;
      float m[kL];
#pragma unroll
      for (int l = 0; l < kL; ++l) m[l] = mp[static_cast<size_t>(l) * P];
#pragma unroll
      for (int l = 0; l < kL; ++l) {
        const float4* jt = reinterpret_cast<const float4*>(&Js[(i * kL + l) * kRows]);
        const float4 j0 = jt[0];
        const float4 j1 = jt[1];
        acc[0] = fmaf(j0.x, m[l], acc[0]);
        acc[1] = fmaf(j0.y, m[l], acc[1]);
        acc[2] = fmaf(j0.z, m[l], acc[2]);
        acc[3] = fmaf(j0.w, m[l], acc[3]);
        acc[4] = fmaf(j1.x, m[l], acc[4]);
        acc[5] = fmaf(j1.y, m[l], acc[5]);
        acc[6] = fmaf(j1.z, m[l], acc[6]);
        acc[7] = fmaf(j1.w, m[l], acc[7]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const size_t o = (row0 + r) * P + col;
    out[o] = hp[row0 + r] * (acc[r] + Mbar[o]);
  }
  if (block_count != nullptr && threadIdx.x == 0 && executed > 0) {
    atomicAdd(block_count, static_cast<unsigned long long>(executed));
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched); -1 for shapes
// that are not block multiples, -2 for a grid the card cannot take.
int repro_influence_update(const void* hp, const void* J, const void* M,
                           const void* Mbar, const void* row_mask,
                           const void* prev_mask, const void* col_mask,
                           const void* jmask, void* out, void* block_count,
                           int B, int n, int P, void* stream) {
  if (n % kRows != 0 || P % kCols != 0) return -1;
  if (n / kRows > 65535 || B > 65535) return -2;
  if (B == 0 || n == 0 || P == 0) return 0;
  const dim3 grid(P / kCols, n / kRows, B);
  influence_kernel<<<grid, kCols, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hp), static_cast<const float*>(J),
      static_cast<const float*>(M), static_cast<const float*>(Mbar),
      static_cast<const int*>(row_mask), static_cast<const int*>(prev_mask),
      static_cast<const int*>(col_mask), static_cast<const int*>(jmask),
      static_cast<float*>(out),
      static_cast<unsigned long long*>(block_count), n, P);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_error_string(int err) {
  if (err == -1) return "n must be a multiple of 8 and P of 128";
  if (err == -2) return "grid too large (n / 8 or B above 65535)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
