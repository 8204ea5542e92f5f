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
// (67 TFLOP/s over 3.35 TB/s = 20), so it stays on the CUDA cores: TF32
// tensor cores would break the f32 tolerance and buy nothing where bytes
// bound.  At n=256, P=20864, B=4 each of M, M-bar and the output is 85 MB,
// past the 50 MB L2.  At the spiral width (B=32, n=16, P <= 1024) a launch
// moves a few MB, and the chain of dependent memory round trips in a CTA,
// with the host's launch path, sets the time.
//
// Design (an earlier version ran one CTA per 8-row block, so the n/8
// row-block CTAs of a column block each read it again, past L2):
//   * one CTA per (128-column tile pb, group of up to 4 row blocks = 32
//     rows, example b), one warp per 8-row block; a thread holds 4 columns
//     of its warp's 8 rows (32 f32 accumulators).  The row groups of one
//     column tile are neighbours on grid.x, so they meet that tile of M in
//     L2; grid.y walks the examples.  4 warps measured faster than 8 (a
//     warp skips half the l-blocks at J density 0.5, and with 8 warps two
//     share a scheduler: the barrier then waits on the busier) and than 2;
//   * every mask the CTA needs first is loaded in one round trip (each load
//     predicated on bounds only); a dead column tile, or a group whose row
//     blocks are all dead, writes zeros (float4 stores) and returns; a dead
//     row block's warp writes its zeros and takes no further part but the
//     CTA's barriers;
//   * the CTA lists the l-blocks live for this example (prev_mask) and for
//     some live row block of the group (jmask), each with the bit set of
//     warps that need it, by a ballot and a prefix count;
//   * the listed l-blocks' 8 x 128 M tiles and the group's 32 x 8 J tiles
//     go through a kStages-deep cp.async ring in shared memory, 16-byte
//     copies; all warps read each M tile, so each column block of M is read
//     n/32 times per example and not n/8; of a J tile only the rows of the
//     warps that multiply that l-block are copied;
//   * a warp whose bit is set reads its J tile (broadcast) and the M tile
//     (float4, conflict-free) and does 256 fmaf a thread an l-block; the
//     skip stays uniform over the warp;
//   * hp is fetched at the start; M-bar too, into shared memory by
//     cp.async, so that its loads overlap the l-block loop (measured as
//     fast as, or faster than, reading it in the epilogue at both the
//     spiral width and n=256);
//   * the epilogue scales hp * (acc + M-bar) and writes float4;
//   * an optional counter gets the executed (kb, lb) pairs of live column
//     tiles: blocks where all four masks are live, as before;
//   * the host side takes its arguments packed in one buffer and launches
//     through the driver API (driver_launch.cuh): the wrapper's host time,
//     not the device's, is the call's time at the spiral width.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "driver_launch.cuh"

namespace {

constexpr int kCols = 128;   // columns per CTA (bp), 4 per thread
constexpr int kRows = 8;     // rows per row block (bk), one block per warp
constexpr int kL = 8;        // rows of M per l-block (bl)
constexpr int kMaxWarps = 4; // row blocks per CTA
constexpr int kStages = 4;   // depth of the M/J ring
constexpr int kMTile = kL * kCols;  // floats of one M tile

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

// Ring stages in shared memory: no more than there are l-blocks (a list of
// at most nb entries never wraps a ring of nb slots), which keeps the
// footprint small at small n.
__host__ __device__ inline int ring_slots(int nb) { return nb < kStages ? nb : kStages; }

// shared memory: [warps][8][128] M-bar, ring_slots x ([8][128] M +
// [warps*8][8] J), then the l-block list (nb ints)
size_t smem_bytes(int warps, int nb) {
  return sizeof(float) * (static_cast<size_t>(warps) * kRows * kCols +
                          static_cast<size_t>(ring_slots(nb)) * (kMTile + warps * kRows * kL)) +
         sizeof(int) * static_cast<size_t>(nb);
}

// For l-block lb: bit w set where prev_mask[b, lb] and jmask[kb0 + w, lb]
// are both live (0 past the last l-block or row block).
template <int kWarps>
__device__ __forceinline__ unsigned jbits(const int* __restrict__ prev_b,
                                          const int* __restrict__ jmask, int lb,
                                          int nb, int kb0) {
  if (lb >= nb) return 0;
  const int pv = prev_b[lb];
  unsigned bits = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (kb0 + w < nb && jmask[static_cast<size_t>(kb0 + w) * nb + lb] != 0) {
      bits |= 1u << w;
    }
  }
  return pv != 0 ? bits : 0u;
}

template <int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
influence_kernel(const float* __restrict__ hp, const float* __restrict__ J,
                 const float* __restrict__ M, const float* __restrict__ Mbar,
                 const int* __restrict__ row_mask,
                 const int* __restrict__ prev_mask,
                 const int* __restrict__ col_mask,
                 const int* __restrict__ jmask, float* __restrict__ out,
                 unsigned long long* __restrict__ block_count, int n, int P) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int warp_cnt[kWarps];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nb = n / kL;                       // l-blocks, and row blocks
  const int groups = (nb + kWarps - 1) / kWarps;
  const int g = blockIdx.x % groups;           // row groups fastest
  const int pb = blockIdx.x / groups;
  const int b = blockIdx.y;
  const int kb0 = g * kWarps;
  const int kb = kb0 + warp;
  const bool in_range = kb < nb;
  const int col = pb * kCols + 4 * lane;
  const int* rows_b = row_mask + static_cast<size_t>(b) * nb;
  const int* prev_b = prev_mask + static_cast<size_t>(b) * nb;

  // Every mask the CTA needs first is loaded in one round trip: each load
  // is predicated on bounds only, never on another load's value.
  unsigned rows_bits = 0;  // live row blocks of the group: the same in every thread
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (kb0 + w < nb && rows_b[kb0 + w] != 0) rows_bits |= 1u << w;
  }
  const int col_live = col_mask[pb];
  const unsigned first_bits = jbits<kWarps>(prev_b, jmask, threadIdx.x, nb, kb0);

  const bool row_live = (rows_bits >> warp) & 1u;
  const bool cta_dead = col_live == 0 || rows_bits == 0;
  // row 0 of the warp's 8 x 128 block, in the output and in M-bar
  const size_t block0 = (static_cast<size_t>(b) * n + static_cast<size_t>(kb) * kRows) * P + col;
  float* out_w = out + block0;
  if ((cta_dead || !row_live) && in_range) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      *reinterpret_cast<float4*>(out_w + static_cast<size_t>(r) * P) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  if (cta_dead) return;  // uniform over the CTA

  float* Mb_s = smem;                                 // [kWarps][8][128]
  float* ring = Mb_s + kWarps * kRows * kCols;
  constexpr int stage_floats = kMTile + kWarps * kRows * kL;
  int* list = reinterpret_cast<int*>(ring + ring_slots(nb) * stage_floats);

  // the epilogue's operands, fetched now
  float hv[kRows];
  if (row_live) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      cp_async16(Mb_s + (warp * kRows + r) * kCols + 4 * lane, Mbar + block0 + static_cast<size_t>(r) * P);
      hv[r] = hp[static_cast<size_t>(b) * n + kb * kRows + r];
    }
  }
  cp_async_commit();

  // the live l-blocks, ascending, each as (lb << 8) | bits of the warps
  // that multiply it
  int count = 0;
  int executed = 0;
  for (int r0 = 0; r0 < nb; r0 += blockDim.x) {
    const unsigned wm = rows_bits &
        (r0 == 0 ? first_bits : jbits<kWarps>(prev_b, jmask, r0 + threadIdx.x, nb, kb0));
    const int lb = r0 + threadIdx.x;
    const unsigned ballot = __ballot_sync(0xffffffffu, wm != 0);
    if (lane == 0) warp_cnt[warp] = __popc(ballot);
    __syncthreads();
    int off = count;
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
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

  const float* Mb = M + static_cast<size_t>(b) * n * P + pb * kCols;
  const float* Jg = J + (static_cast<size_t>(b) * n + static_cast<size_t>(kb0) * kRows) * n;
  auto load_stage = [&](int i) {
    const int lb = list[i] >> 8;
    const unsigned bits = list[i] & 0xff;  // the warps that multiply l-block lb
    float* Ms = ring + (i % kStages) * stage_floats;
    float* Js = Ms + kMTile;
    for (int c = threadIdx.x; c < kMTile / 4; c += blockDim.x) {  // 8 rows x 32 chunks
      const int r = c / (kCols / 4);
      const int q = c % (kCols / 4);
      cp_async16(Ms + r * kCols + 4 * q, Mb + static_cast<size_t>(lb * kL + r) * P + 4 * q);
    }
    for (int c = threadIdx.x; c < kWarps * kRows * 2; c += blockDim.x) {  // rows x 2 chunks
      const int rr = c / 2;
      const int h = c % 2;
      if ((bits >> (rr / kRows)) & 1u) {  // only the J rows a warp will read
        cp_async16(Js + rr * kL + 4 * h, Jg + static_cast<size_t>(rr) * n + lb * kL + 4 * h);
      }
    }
  };

  float acc[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  }
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
    const float* Ms = ring + (i % kStages) * stage_floats;
    const float* Jw = Ms + kMTile + warp * kRows * kL;  // [8 rows][8 l]
#pragma unroll 1  // rolled: less code for a launch that runs alone
    for (int h = 0; h < 2; ++h) {
      float4 m[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        m[q] = *reinterpret_cast<const float4*>(Ms + (4 * h + q) * kCols + 4 * lane);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 j = *reinterpret_cast<const float4*>(Jw + r * kL + 4 * h);
        const float jl[4] = {j.x, j.y, j.z, j.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[r][0] = fmaf(jl[q], m[q].x, acc[r][0]);
          acc[r][1] = fmaf(jl[q], m[q].y, acc[r][1]);
          acc[r][2] = fmaf(jl[q], m[q].z, acc[r][2]);
          acc[r][3] = fmaf(jl[q], m[q].w, acc[r][3]);
        }
      }
    }
  }
  cp_async_wait<0>();  // M-bar (this thread's own copies) and empty groups
  if (!row_live) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float4 mb = *reinterpret_cast<const float4*>(Mb_s + (warp * kRows + r) * kCols + 4 * lane);
    *reinterpret_cast<float4*>(out_w + static_cast<size_t>(r) * P) =
        make_float4(hv[r] * (acc[r][0] + mb.x), hv[r] * (acc[r][1] + mb.y),
                    hv[r] * (acc[r][2] + mb.z), hv[r] * (acc[r][3] + mb.w));
  }
}

__global__ void empty_kernel() {}

// The launch arguments, packed by the wrapper as 14 64-bit ints in one
// buffer: one ctypes argument to convert instead of 14.
struct InfluenceArgs {
  unsigned long long hp, J, M, Mbar, row_mask, prev_mask, col_mask, jmask, out,
      block_count, B, n, P, stream;
};

template <typename T>
T* ptr(unsigned long long p) {
  return reinterpret_cast<T*>(static_cast<uintptr_t>(p));
}

}  // namespace

extern "C" {

// Launches the kernel on the packed arguments (block_count 0 = none)
// through the driver API (driver_launch.cuh).  Returns 0 when launched, the
// launch's error otherwise; -1 for shapes that are not block multiples, -2
// for a grid or shared memory the card cannot take.
int repro_influence_update(const void* packed) {
  InfluenceArgs a;
  memcpy(&a, packed, sizeof a);
  const int B = static_cast<int>(a.B);
  const int n = static_cast<int>(a.n);
  const int P = static_cast<int>(a.P);
  if (n % kRows != 0 || P % kCols != 0) return -1;
  if (B == 0 || n == 0 || P == 0) return 0;
  const int nb = n / kRows;
  // row blocks per CTA: 4, or 2 or 1 where n has fewer
  const int warps = nb >= kMaxWarps ? kMaxWarps : nb >= 2 ? 2 : 1;
  const long long groups = (nb + warps - 1) / warps;
  const long long tiles = groups * (P / kCols);
  const size_t smem = smem_bytes(warps, nb);
  if (B > 65535 || tiles > 0x7fffffffLL || smem > 232448) return -2;
  const dim3 grid(static_cast<unsigned>(tiles), B);
  const cudaStream_t stream = reinterpret_cast<cudaStream_t>(static_cast<uintptr_t>(a.stream));
  using Kernel = void (*)(const float*, const float*, const float*, const float*, const int*,
                          const int*, const int*, const int*, float*, unsigned long long*, int, int);
  static const Kernel kernels[3] = {influence_kernel<1>, influence_kernel<2>,
                                    influence_kernel<kMaxWarps>};
  static repro::DriverFunction handles[3];
  const int wi = warps == kMaxWarps ? 2 : warps - 1;
  const Kernel kernel = kernels[wi];
  if (smem > 48 * 1024) {
    // raised once a device and kernel, to the most any call asked for
    static size_t raised[64][3] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 64 && smem > raised[dev][wi]) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      raised[dev][wi] = smem;
    }
  }
  const float* hp = ptr<const float>(a.hp);
  const float* J = ptr<const float>(a.J);
  const float* M = ptr<const float>(a.M);
  const float* Mbar = ptr<const float>(a.Mbar);
  const int* row_mask = ptr<const int>(a.row_mask);
  const int* prev_mask = ptr<const int>(a.prev_mask);
  const int* col_mask = ptr<const int>(a.col_mask);
  const int* jmask = ptr<const int>(a.jmask);
  float* out = ptr<float>(a.out);
  unsigned long long* block_count = ptr<unsigned long long>(a.block_count);
  int n_arg = n;
  int P_arg = P;
  void* params[] = {&hp, &J, &M, &Mbar, &row_mask, &prev_mask, &col_mask,
                    &jmask, &out, &block_count, &n_arg, &P_arg};
  return repro::driver_launch(handles[wi], reinterpret_cast<const void*>(kernel), grid,
                              warps * 32, smem, stream, params);
}

// An empty kernel launched through the same ctypes route (the stream packed
// as one 64-bit int): the launch floor.
int repro_empty_launch(const void* packed) {
  unsigned long long stream;
  memcpy(&stream, packed, sizeof stream);
  static repro::DriverFunction handle;
  return repro::driver_launch(handle, reinterpret_cast<const void*>(empty_kernel), dim3(1), 32, 0,
                              reinterpret_cast<cudaStream_t>(static_cast<uintptr_t>(stream)),
                              nullptr);
}

const char* repro_error_string(int err) {
  if (err == -1) return "n must be a multiple of 8 and P of 128";
  if (err == -2) return "grid or shared memory too large (B above 65535 or n too large)";
  return repro::error_string(err);
}

}  // extern "C"
