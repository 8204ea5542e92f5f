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
// (fmaf, ascending; each block's partial sum added in block order), the
// output is R's dtype.
//
// What bounds it on an H100: bytes.  An executed block is 2*8*128 FLOP on
// the 8 x 128 tile of R it reads (4 KB f32), 0.5 FLOP a byte against the
// card's f32 ratio of 20.  At the spiral EGRU's shapes ([32,16] x [16,16],
// padded to 128 columns) and at B=32, n=256, m=768 the bound is well under a
// microsecond, below one launch's own latency: the host's launch path sets
// the call's time, and on the device the chain of dependent steps of a CTA
// (one barrier and one l-block at a time) sets the kernel's.
//
// Design (an earlier version ran one CTA per (column block, example), so
// every example's CTA read the same R tiles again, with scalar loads):
//   * one CTA per (column block mb, group of up to 8 examples), one warp per
//     example; a thread keeps 4 columns in f32 and casts once on write.  The
//     example groups of one column block are neighbours on grid.x;
//   * the CTA lists the l-blocks whose rmask is live and which some example
//     of the group needs, each with the bit set of warps that need it (a
//     ballot and a prefix count, the masks loaded in one round trip); the
//     skip stays uniform over each warp;
//   * each listed l-block's R tile and the group's 8 values of a go through
//     a kStages-deep cp.async ring in shared memory, 16-byte copies (4 f32
//     or 8 bf16); all the group's warps read the tile, so R crosses from L2
//     once per group and not once per example (a deeper ring measured no
//     faster: the per-l-block barrier chain, not the copies, is the limit);
//   * an optional counter gets the executed (b, lb, mb) blocks;
//   * the host side takes its arguments packed in one buffer and launches
//     through the driver API (driver_launch.cuh).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "driver_launch.cuh"

namespace {

constexpr int kCols = 128;   // bm: columns per CTA, 4 per thread
constexpr int kL = 8;        // bl: rows of R per l-block
constexpr int kMaxWarps = 8; // examples per CTA
constexpr int kStages = 3;   // depth of the R/a ring

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 4 consecutive values from shared memory, widened to f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                     __high2float(hi));
}

// 4 f32 values cast once and written to device memory
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// shared memory: kStages x ([8][128] R + [warps][8] a), then the l-block
// list (nlb ints)
template <typename T>
size_t smem_bytes(int warps, int nlb) {
  return sizeof(T) * static_cast<size_t>(kStages) * (kL * kCols + warps * kL) +
         sizeof(int) * static_cast<size_t>(nlb);
}

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
event_matmul_kernel(const T* __restrict__ a, const T* __restrict__ R,
                    const int* __restrict__ act_mask,
                    const int* __restrict__ rmask, T* __restrict__ y,
                    unsigned long long* __restrict__ block_count, int B, int n,
                    int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int warp_cnt[kMaxWarps];
  constexpr int kVec = 16 / sizeof(T);        // values in a 16-byte copy
  constexpr int kTile = kL * kCols;           // values of one R tile
  T* ring = reinterpret_cast<T*>(smem_raw);

  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nlb = n / kL;
  const int nmb = m / kCols;
  const int groups = (B + warps - 1) / warps;
  const int g = blockIdx.x % groups;
  const int mb = blockIdx.x / groups;
  const int b0 = g * warps;
  const int b = b0 + warp;
  const int stage_len = kTile + warps * kL;  // values of one ring stage
  int* list = reinterpret_cast<int*>(ring + kStages * stage_len);

  // the live l-blocks, ascending, each as (lb << 8) | bits of the warps
  // (examples) that multiply it
  int count = 0;
  int executed = 0;
  for (int r0 = 0; r0 < nlb; r0 += blockDim.x) {
    const int lb = r0 + threadIdx.x;
    // one round trip: each load is predicated on bounds only
    unsigned wm = 0;
    if (lb < nlb) {
      const int rv = rmask[static_cast<size_t>(lb) * nmb + mb];
#pragma unroll
      for (int w = 0; w < kMaxWarps; ++w) {
        if (w < warps && b0 + w < B && act_mask[static_cast<size_t>(b0 + w) * nlb + lb] != 0) {
          wm |= 1u << w;
        }
      }
      if (rv == 0) wm = 0;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, wm != 0);
    if (lane == 0) warp_cnt[warp] = __popc(ballot);
    __syncthreads();
    int off = count;
    int total = 0;
    for (int w = 0; w < warps; ++w) {
      off += w < warp ? warp_cnt[w] : 0;
      total += warp_cnt[w];
    }
    if (wm != 0) list[off + __popc(ballot & ((1u << lane) - 1u))] = (lb << 8) | static_cast<int>(wm);
    executed += __popc(wm);
    count += total;
    __syncthreads();  // the list is complete; warp_cnt may be reused
  }
  if (block_count != nullptr) {
    const int s = __reduce_add_sync(0xffffffffu, executed);
    if (lane == 0 && s > 0) atomicAdd(block_count, static_cast<unsigned long long>(s));
  }

  auto load_stage = [&](int i) {
    const int lb = list[i] >> 8;
    T* Rs = ring + (i % kStages) * stage_len;
    T* as = Rs + kTile;
    constexpr int row_chunks = kCols / kVec;
    for (int c = threadIdx.x; c < kL * row_chunks; c += blockDim.x) {
      const int r = c / row_chunks;
      const int q = c % row_chunks;
      cp_async16(Rs + r * kCols + q * kVec,
                 R + static_cast<size_t>(lb * kL + r) * m + mb * kCols + q * kVec);
    }
    constexpr int a_chunks = kL / kVec;       // 2 (f32) or 1 (bf16)
    for (int c = threadIdx.x; c < warps * a_chunks; c += blockDim.x) {
      const int w = c / a_chunks;
      const int q = c % a_chunks;
      if (b0 + w < B) {
        cp_async16(as + w * kL + q * kVec,
                   a + static_cast<size_t>(b0 + w) * n + lb * kL + q * kVec);
      }
    }
  };

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < count) load_stage(i);
    cp_async_commit();
  }
  for (int i = 0; i < count; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of entry i landed
    __syncthreads();               // everyone's; and entry i-1's stage is free
    if (i + kStages - 1 < count) load_stage(i + kStages - 1);
    cp_async_commit();
    if (!((list[i] >> warp) & 1)) continue;  // uniform over the warp
    const T* Rs = ring + (i % kStages) * stage_len;
    const T* as = Rs + kTile + warp * kL;
    float blk[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int l = 0; l < kL; ++l) {
      const float al = to_f32(as[l]);
      const float4 r = load4(Rs + l * kCols + 4 * lane);
      blk[0] = fmaf(al, r.x, blk[0]);
      blk[1] = fmaf(al, r.y, blk[1]);
      blk[2] = fmaf(al, r.z, blk[2]);
      blk[3] = fmaf(al, r.w, blk[3]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] += blk[c];
  }
  cp_async_wait<0>();
  if (b < B) store4(y + static_cast<size_t>(b) * m + mb * kCols + 4 * lane, acc);
}

template <typename T>
int launch(const void* a, const void* R, const void* act_mask,
           const void* rmask, void* y, void* block_count, int B, int n, int m,
           cudaStream_t stream) {
  const int warps = B < kMaxWarps ? B : kMaxWarps;
  const long long groups = (B + warps - 1) / warps;
  const long long tiles = groups * (m / kCols);
  const size_t smem = smem_bytes<T>(warps, n / kL);
  if (tiles > 0x7fffffffLL || smem > 232448) return -2;
  if (smem > 48 * 1024) {
    // raised once a device, to the most any call asked for
    static size_t raised[64] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 64 && smem > raised[dev]) {
      const cudaError_t e = cudaFuncSetAttribute(
          event_matmul_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      raised[dev] = smem;
    }
  }
  static repro::DriverFunction handle;  // one per instantiation
  const T* a_arg = static_cast<const T*>(a);
  const T* R_arg = static_cast<const T*>(R);
  const int* act_arg = static_cast<const int*>(act_mask);
  const int* rmask_arg = static_cast<const int*>(rmask);
  T* y_arg = static_cast<T*>(y);
  unsigned long long* count_arg = static_cast<unsigned long long*>(block_count);
  void* params[] = {&a_arg, &R_arg, &act_arg, &rmask_arg, &y_arg, &count_arg,
                    &B, &n, &m};
  return repro::driver_launch(handle, reinterpret_cast<const void*>(event_matmul_kernel<T>),
                              dim3(static_cast<unsigned>(tiles)), warps * 32, smem, stream,
                              params);
}

// The launch arguments, packed by the wrapper as 11 64-bit ints in one
// buffer: one ctypes argument to convert instead of 11.
struct EventMatmulArgs {
  unsigned long long a, R, act_mask, rmask, y, block_count, B, n, m, bf16,
      stream;
};

}  // namespace

extern "C" {

// Launches the kernel on the packed arguments (block_count 0 = none; bf16
// non-zero for bf16 a, R and y) through the driver API (driver_launch.cuh).
// Returns 0 when launched, the launch's error otherwise; -1 for shapes that
// are not block multiples, -2 for a grid or shared memory the card cannot
// take.
int repro_event_matmul(const void* packed) {
  EventMatmulArgs p;
  memcpy(&p, packed, sizeof p);
  const void* a = reinterpret_cast<const void*>(static_cast<uintptr_t>(p.a));
  const void* R = reinterpret_cast<const void*>(static_cast<uintptr_t>(p.R));
  const void* act = reinterpret_cast<const void*>(static_cast<uintptr_t>(p.act_mask));
  const void* rm = reinterpret_cast<const void*>(static_cast<uintptr_t>(p.rmask));
  void* y = reinterpret_cast<void*>(static_cast<uintptr_t>(p.y));
  void* count = reinterpret_cast<void*>(static_cast<uintptr_t>(p.block_count));
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(static_cast<uintptr_t>(p.stream));
  const int B = static_cast<int>(p.B);
  const int n = static_cast<int>(p.n);
  const int m = static_cast<int>(p.m);
  if (n % kL != 0 || m % kCols != 0) return -1;
  if (B == 0 || m == 0) return 0;
  if (p.bf16) return launch<__nv_bfloat16>(a, R, act, rm, y, count, B, n, m, s);
  return launch<float>(a, R, act, rm, y, count, B, n, m, s);
}

const char* repro_error_string(int err) {
  if (err == -1) return "n must be a multiple of 8 and m of 128";
  if (err == -2) return "grid or shared memory too large (B or n too large)";
  return repro::error_string(err);
}

}  // extern "C"
