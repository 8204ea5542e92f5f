// Event-driven (activity-sparse) matmul for Hopper (sm_90a), hand-written
// CUDA.
//
// Replaces the TPU kernel src/repro/kernels/event_matmul.py::
// event_matmul_pallas (body _kernel).  On operands padded to n % 8 == 0 and
// m % 128 == 0, for example b and column c in column block mb:
//
//   y[b,c] = sum over lb ascending, with act_mask[b,lb] != 0 and
//            rmask[lb,mb] != 0, of  sum_{l<8} a[b, 8 lb + l] * R[8 lb + l, c]
//
// the paper's forward-pass term: 8-wide blocks of a that are all zero for
// example b (no events) and (8 x 128) blocks of R that the parameter mask
// kills are skipped.  a and R are both f32 or both bf16; the sum is f32
// (fmaf, ascending), the output is R's dtype.
//
// What bounds it on an H100: bytes.  An executed block is 2*8*128 FLOP on
// the 8 x 128 tile of R it reads (4 KB f32), 0.5 FLOP a byte against the
// card's f32 ratio of 20.  At the spiral EGRU's shapes ([32,16] x [16,16],
// padded to 128 columns) one launch moves a few KB: launch overhead is all.
//
// Design (simple and right first):
//   * one CTA of 128 threads per (column block mb, example b), one column a
//     thread: grid.x walks column blocks, grid.y examples;
//   * the CTA walks the l-blocks; both masks are read by every thread (one
//     broadcast load each), so the skip is uniform across the CTA;
//   * an executed block: 8 values of a (broadcast) and 8 coalesced rows of R;
//   * an optional counter: thread 0 adds the CTA's executed blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 128;  // bm: columns per CTA, one per thread
constexpr int kL = 8;       // bl: rows of R per l-block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kCols)
event_matmul_kernel(const T* __restrict__ a, const T* __restrict__ R,
                    const int* __restrict__ act_mask,
                    const int* __restrict__ rmask, T* __restrict__ y,
                    unsigned long long* __restrict__ block_count, int n, int m) {
  const int mb = blockIdx.x;
  const int b = blockIdx.y;
  const int nlb = n / kL;
  const int nmb = m / kCols;
  const int col = mb * kCols + threadIdx.x;
  const T* arow = a + static_cast<size_t>(b) * n;
  const int* act = act_mask + static_cast<size_t>(b) * nlb;

  float acc = 0.f;
  int executed = 0;
  for (int lb = 0; lb < nlb; ++lb) {
    if (act[lb] == 0 || rmask[static_cast<size_t>(lb) * nmb + mb] == 0) continue;
    ++executed;
    const T* rp = R + static_cast<size_t>(lb) * kL * m + col;
    float blk = 0.f;
#pragma unroll
    for (int l = 0; l < kL; ++l) {
      blk = fmaf(to_f32(arow[lb * kL + l]), to_f32(rp[static_cast<size_t>(l) * m]), blk);
    }
    acc += blk;
  }
  y[static_cast<size_t>(b) * m + col] = from_f32<T>(acc);
  if (block_count != nullptr && threadIdx.x == 0 && executed > 0) {
    atomicAdd(block_count, static_cast<unsigned long long>(executed));
  }
}

template <typename T>
int launch(const void* a, const void* R, const void* act_mask,
           const void* rmask, void* y, void* block_count, int B, int n, int m,
           cudaStream_t stream) {
  const dim3 grid(m / kCols, B);
  event_matmul_kernel<T><<<grid, kCols, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(R),
      static_cast<const int*>(act_mask), static_cast<const int*>(rmask),
      static_cast<T*>(y), static_cast<unsigned long long*>(block_count), n, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched); -1 for shapes
// that are not block multiples, -2 for a grid the card cannot take.
int repro_event_matmul(const void* a, const void* R, const void* act_mask,
                       const void* rmask, void* y, void* block_count, int B,
                       int n, int m, int bf16, void* stream) {
  if (n % kL != 0 || m % kCols != 0) return -1;
  if (B > 65535) return -2;
  if (B == 0 || m == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16>(a, R, act_mask, rmask, y, block_count, B, n,
                                 m, s);
  }
  return launch<float>(a, R, act_mask, rmask, y, block_count, B, n, m, s);
}

const char* repro_error_string(int err) {
  if (err == -1) return "n must be a multiple of 8 and m of 128";
  if (err == -2) return "grid too large (B above 65535)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
