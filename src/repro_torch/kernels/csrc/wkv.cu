// Chunked RWKV6 WKV for Hopper (sm_90a), hand-written CUDA: the value
// columns of each head split across the CTAs of a thread-block cluster, the
// state held in registers.
//
// Replaces the TPU kernel src/repro/kernels/wkv.py::wkv_pallas (body
// _kernel).  For each (batch b, head h), over chunks of L steps in order,
// with logP the per-channel cumulative sum of logw inside the chunk and
// logP_prev = logP - logw:
//
//   o[i,v]  = sum_d r[i,d] e^{logP_prev[i,d]} S[d,v]  +  sum_{j<=i} A[i,j] v[j,v]
//   A[i,j]  = sum_d r[i,d] k[j,d] e^{min(logP_prev[i,d] - logP[j,d], 0)}   j < i
//   A[i,i]  = sum_d r[i,d] u[d] k[i,d]
//   S[d,v] <- e^{logP[L-1,d]} S[d,v] + sum_j k[j,d] e^{logP[L-1,d] - logP[j,d]} v[j,v]
//
// Every exponent is <= 0, so no term overflows at any decay (logw down to
// -e^10).  S starts from S0 (zeros when S0 is null) and the final state is
// written to S_out: the TPU kernel keeps its state in VMEM and drops it,
// the serving cache needs it.  r/k/v are bf16 or f32, logw, u, o and S f32.
//
// What bounds it on an H100: at RWKV6-3B's prefill (B=4, H=40, T=2048,
// D=64, L=16) it moves ~300 MB (r/k/v bf16, logw and o f32) and does about
// 6.9 GFLOP of f32 work (the inter term and the state update are 2*L*D*D
// each a chunk, A's triangle 5*D*L*(L-1)/2, one expf in each of its terms):
// 0.089 ms of bytes and 0.103 ms of f32 CUDA-core FLOP.  The chunk loop is
// sequential, so a design with one CTA per (b, h) has 160 CTAs on 132 SMs
// and is latency-bound (the first version: 2.5 ms, five barriers a chunk,
// the state in shared memory).  This design is latency-bound too: each
// chunk's chain of dependent phases (scalar phase, A, partials, output),
// not the instruction issue rate, sets its time.
//
// Design: o[:, c] and S[:, c] depend only on v[:, c] and S[:, c], so the
// value columns of a head split cleanly across CTAs.
//   * one CTA per (b, h, tile of kDV value columns), kDV = 32 where it
//     divides D, else 16, of 8 * kDV threads: at D = 64, B*H*2 CTAs of 256
//     threads (320 at the prefill, 2 or 3 on an SM).  The tiles of a head
//     form a cluster and share the work that does not depend on the
//     column: each takes its share of the channels in the scalar phase
//     (the cumulative sum and the exponentials) and of the pairs of A, and
//     stores its results into every CTA of the cluster (distributed shared
//     memory).  A head's CTAs are neighbours on the grid, so they meet its
//     r/k/logw in L2;
//   * thread (g, c) holds S[8g : 8g+8, c] in registers.  The inter term is
//     8-row partial sums over its rows, for every step i of the chunk, into
//     a [8][L][kDV] buffer; then it updates its own rows of S:
//     S <- e^{logP_L} S + sum_j kt[j,d] v[j,c];
//   * the next chunk's r, k, logw ([L, D]) and v ([L, kDV]) come in by
//     cp.async into the other half of a double buffer while this chunk
//     computes (one buffer where two would pass the card's shared memory:
//     f32 inputs at L = 64);
//   * the scalar phase keeps every channel's cumulative sum in ascending
//     steps (the plain version's order, so the clamp at 0 sees the same
//     rounding), 8 threads a channel; A splits each pair's channel sum
//     over 8 lanes, reduced by shuffles;
//   * three barriers a chunk: the chunk's tiles have landed (the CTA's);
//     the scalar phase is done everywhere (the cluster's); A and the
//     partials are done everywhere (the cluster's).  A CTA writes into the
//     others only between two cluster barriers that every reader of the
//     written arrays has passed, so one buffer of each suffices.  Each
//     output then sums its partials in ascending g, adds
//     sum_{j<=i} A[i,j] v[j,c], and is written, kDV contiguous f32 a row;
//   * L = 16, RWKV6's chunk, has an instantiation with its loops unrolled;
//     other L up to 64 take the same code with L at run time;
//   * the host side takes its arguments packed in one buffer and launches
//     through the driver API (driver_launch.cuh), in clusters.
//   Sums are fmaf; expf, not __expf, and no fast math.
//   Measured against the alternatives on an H100 (PERF.md, Findings): 16
//   columns a CTA in clusters of 4 leave 6 of the prefill's 160 clusters
//   for a second wave (154 fit: a cluster's CTAs share one GPC); without
//   the cluster every CTA recomputes A; 16 rows a thread (128 threads of
//   32 columns) leave too few warps an SM to hide the chains' latency.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "driver_launch.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxD = 64;
constexpr int kMaxL = 64;
constexpr int kFixedL = 16;               // the chunk with an unrolled build
constexpr int kRows = 8;                  // state rows a thread holds
constexpr int kGroups = kMaxD / kRows;    // row groups of a CTA
constexpr int kPairLanes = 8;             // lanes that share one pair of A
constexpr int kMaxSmem = 232448;          // dynamic shared bytes a CTA may use

// At head width D: the value columns a CTA owns (32 where that divides D,
// else 16), its threads (a row group of every column), and the CTAs an SM
// must hold (3 of 256 threads, 5 of 128)
template <int D>
struct Width {
  static constexpr int kCols = D % 32 == 0 ? 32 : 16;
  static constexpr int kThreads = kGroups * kCols;
  static constexpr int kMinCtas = kThreads > 128 ? 3 : 5;
};
template <int D>
__host__ __device__ constexpr int cols() {
  return Width<D>::kCols;
}
template <int D>
__host__ __device__ constexpr int tiles() {
  return D / cols<D>();
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// N (2 or 4) consecutive values from shared memory, widened to f32
template <int N>
struct Vec {
  float x[N];
};
template <int N>
__device__ __forceinline__ Vec<N> load_vec(const float* p) {
  Vec<N> out;
  if constexpr (N == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    out.x[0] = f.x; out.x[1] = f.y; out.x[2] = f.z; out.x[3] = f.w;
  } else {
    const float2 f = *reinterpret_cast<const float2*>(p);
    out.x[0] = f.x; out.x[1] = f.y;
  }
  return out;
}
template <int N>
__device__ __forceinline__ Vec<N> load_vec(const __nv_bfloat16* p) {
  Vec<N> out;
#pragma unroll
  for (int e = 0; e < N; e += 2) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + e));
    out.x[e] = f.x;
    out.x[e + 1] = f.y;
  }
  return out;
}

// Shared memory, in this order (every array starts 16-byte aligned):
//   two stages (one where two pass kMaxSmem) of the chunk's inputs:
//     r [L][D], k [L][D] (input type),
//     logw [L][D] f32, v [L][kDV] (input type);
//   logP, logP_prev, q = r e^{logP_prev}, kt = k e^{logP_L - logP}: [L][D] f32;
//   the inter-term partials: kGroups x ([L][kDV] + 16 pad) f32;
//   decay e^{logP_L} [D], u [D], A's lower triangle row by row (L(L+1)/2)
//   f32; the pair list (ushort).

__host__ __device__ inline size_t stage_bytes(int D, int L, size_t elt, int dv) {
  return static_cast<size_t>(L) * D * (2 * elt + sizeof(float)) +
         static_cast<size_t>(L) * dv * elt;
}
__host__ __device__ inline int part_stride(int L, int dv) {
  return L * dv + 16;  // floats; +16: the next group on other banks
}
size_t smem_bytes(int D, int L, size_t elt, int dv, int stages) {
  const size_t pairs = static_cast<size_t>(L) * (L + 1) / 2;
  return stages * stage_bytes(D, L, elt, dv) +
         sizeof(float) * (4 * static_cast<size_t>(L) * D +
                          static_cast<size_t>(kGroups) * part_stride(L, dv) +
                          2 * static_cast<size_t>(D) + pairs) +
         sizeof(unsigned short) * pairs;
}

// kL > 0: the chunk length, fixed at compile time; 0: L_arg.  stages: 2
// (the next chunk's inputs load while this one computes) or 1.
template <typename T, int D, int kL>
__global__ void __launch_bounds__(Width<D>::kThreads, Width<D>::kMinCtas)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ logw,
           const float* __restrict__ u, const float* __restrict__ S0,
           float* __restrict__ o, float* __restrict__ S_out, int H, int T_len,
           int L_arg, int stages) {
  constexpr int kDV = cols<D>();              // value columns a CTA owns
  constexpr int kThreads = Width<D>::kThreads;
  constexpr int kPairSlots = kThreads / kPairLanes;
  constexpr int kTiles = tiles<D>();          // CTAs of one head, a cluster
  constexpr int kChan = D / kTiles;           // channels of a CTA's scalar phase
  constexpr int kSplit = kThreads / kChan;    // threads of a channel there
  constexpr int kHeld = D / kRows;            // row groups that hold state
  constexpr int kVec = D % 32 == 0 ? 4 : 2;   // channels a lane loads at once in A
  constexpr int kSteps = D / (kPairLanes * kVec);
  extern __shared__ __align__(16) unsigned char smem[];

  const int L = kL > 0 ? kL : L_arg;
  const int tid = threadIdx.x;
  const int c = tid % kDV;                    // value column in the tile
  const int g = tid / kDV;                    // row group
  const int rank = blockIdx.x % kTiles;       // the CTA's rank in its cluster
  const int bh = blockIdx.x / kTiles;
  const int h = bh % H;
  const int col0 = rank * kDV;
  const int LD = L * D;
  const int nchunks = T_len / L;
  const int n_pairs = L * (L + 1) / 2;
  const int pstride = part_stride(L, kDV);
  cg::cluster_group cluster = cg::this_cluster();
  // a shared array of the CTA of rank `dst` in this cluster
  auto at_rank = [&](float* p, int dst) -> float* {
    if constexpr (kTiles > 1) {
      return cluster.map_shared_rank(p, dst);
    } else {
      return p;
    }
  };
  // the CTA barrier, or the cluster's where the cluster shares work
  auto share_sync = [&]() {
    if constexpr (kTiles > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
  };

  const size_t sbytes = stage_bytes(D, L, sizeof(T), kDV);
  float* lp = reinterpret_cast<float*>(smem + stages * sbytes);  // logP
  float* lpp = lp + LD;                                     // logP_prev
  float* q = lpp + LD;                                      // r e^{logP_prev}
  float* kt = q + LD;                                       // k e^{logP_L - logP}
  float* part = kt + LD;                                    // inter partials
  float* decay = part + kGroups * pstride;                  // e^{logP_L}
  float* us = decay + D;                                    // u[h]
  float* A = us + D;                      // row i at i(i+1)/2, j <= i
  unsigned short* pairs = reinterpret_cast<unsigned short*>(A + n_pairs);

  const size_t seq = static_cast<size_t>(bh) * T_len;  // row of step 0
  auto load_chunk = [&](int ch) {
    unsigned char* st = smem + (ch % stages) * sbytes;
    const size_t row0 = seq + static_cast<size_t>(ch) * L;
    const int rk16 = LD * static_cast<int>(sizeof(T)) / 16;
    const char* gr = reinterpret_cast<const char*>(r + row0 * D);
    const char* gk = reinterpret_cast<const char*>(k + row0 * D);
    const char* gw = reinterpret_cast<const char*>(logw + row0 * D);
    for (int e = tid; e < rk16; e += kThreads) {
      cp_async16(st + 16 * e, gr + 16 * e);
      cp_async16(st + LD * sizeof(T) + 16 * e, gk + 16 * e);
    }
    unsigned char* sw = st + 2 * LD * sizeof(T);
    for (int e = tid; e < LD / 4; e += kThreads) cp_async16(sw + 16 * e, gw + 16 * e);
    constexpr int kV16 = kDV * static_cast<int>(sizeof(T)) / 16;  // copies a row
    unsigned char* sv = sw + LD * sizeof(float);
    for (int e = tid; e < L * kV16; e += kThreads) {
      const int i = e / kV16;
      const int x = e - i * kV16;
      cp_async16(sv + i * kDV * sizeof(T) + 16 * x,
                 reinterpret_cast<const char*>(v + (row0 + i) * D + col0) + 16 * x);
    }
    cp_async_commit();
  };
  if (nchunks > 0) load_chunk(0);

  // once: the pairs (i, j <= i) of A, row by row, as A keeps them
  for (int p = tid; p < n_pairs; p += kThreads) {
    int i = 0;
    while ((i + 1) * (i + 2) / 2 <= p) ++i;
    pairs[p] = static_cast<unsigned short>((i << 8) | (p - i * (i + 1) / 2));
  }
  for (int d = tid; d < D; d += kThreads) us[d] = u[static_cast<size_t>(h) * D + d];

  const bool holds = g < kHeld;
  const int g0 = g * kRows;
  const size_t sbase = static_cast<size_t>(bh) * D * D;
  float S[kRows];
#pragma unroll
  for (int d = 0; d < kRows; ++d) {
    S[d] = holds && S0 != nullptr ? S0[sbase + static_cast<size_t>(g0 + d) * D + col0 + c]
                                  : 0.f;
  }
  if constexpr (kTiles > 1) cluster.sync();  // every CTA of the cluster runs

  for (int ch = 0; ch < nchunks; ++ch) {
    if (stages == 1 && ch > 0) {
      __syncthreads();  // the previous chunk's inputs are consumed
      load_chunk(ch);
    }
    cp_async_wait_all();
    __syncthreads();  // chunk ch has landed; the previous chunk is consumed
    if (stages == 2 && ch + 1 < nchunks) load_chunk(ch + 1);
    const unsigned char* st = smem + (ch % stages) * sbytes;
    const T* rs = reinterpret_cast<const T*>(st);
    const T* ks = rs + LD;
    const float* ws = reinterpret_cast<const float*>(ks + LD);
    const T* vs = reinterpret_cast<const T*>(ws + LD);

    // scalar phase, this CTA's kChan channels: each channel's cumulative sum
    // in ascending steps (all kSplit threads of a channel take it), then
    // every kSplit-th step's logP, logP_prev, q and kt, stored into every
    // CTA of the cluster
    if (tid < kSplit * kChan) {
      const int d = rank * kChan + tid % kChan;
      const int mine = tid / kChan;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const int t = i * D + d;
        const float w = ws[t];
        acc += w;
        if (i % kSplit == mine) {
          lp[t] = acc;
          lpp[t] = acc - w;
        }
      }
#pragma unroll
      for (int i = mine; i < L; i += kSplit) {
        const int t = i * D + d;
        const float p = lp[t];
        const float pp = lpp[t];
        const float qv = to_f32(rs[t]) * expf(pp);
        const float kv = to_f32(ks[t]) * expf(acc - p);
        q[t] = qv;
        kt[t] = kv;
#pragma unroll
        for (int dst = 0; dst < kTiles; ++dst) {
          if (dst == rank) continue;
          float* base = at_rank(lp, dst);
          base[t] = p;
          base[LD + t] = pp;
          base[2 * LD + t] = qv;
          base[3 * LD + t] = kv;
        }
      }
      if (mine == 0) {
        const float dec = expf(acc);
#pragma unroll
        for (int dst = 0; dst < kTiles; ++dst) at_rank(decay, dst)[d] = dec;
      }
    }
    share_sync();  // logP, q, kt and the decay are complete in every CTA

    // this CTA's pairs of A (p = rank + kTiles * s), 8 lanes to a pair,
    // kVec channels a load; stored into every CTA of the cluster
    {
      const int sub = tid % kPairLanes;
      const int n_mine = (n_pairs - rank + kTiles - 1) / kTiles;
      for (int s0 = 0; s0 < n_mine; s0 += kPairSlots) {
        const int s = s0 + tid / kPairLanes;
        const int p = rank + kTiles * s;
        const bool live = s < n_mine;
        const int ij = live ? pairs[p] : 0;
        const int i = ij >> 8;
        const int j = ij & 255;
        float a = 0.f;
        if (live && i != j) {
#pragma unroll
          for (int m = 0; m < kSteps; ++m) {
            const int d = kVec * sub + kVec * kPairLanes * m;
            const Vec<kVec> ri = load_vec<kVec>(rs + i * D + d);
            const Vec<kVec> kj = load_vec<kVec>(ks + j * D + d);
            const Vec<kVec> pi = load_vec<kVec>(lpp + i * D + d);
            const Vec<kVec> pj = load_vec<kVec>(lp + j * D + d);
#pragma unroll
            for (int e = 0; e < kVec; ++e) {
              a = fmaf(ri.x[e] * kj.x[e], expf(fminf(pi.x[e] - pj.x[e], 0.f)), a);
            }
          }
        } else if (live) {
#pragma unroll
          for (int m = 0; m < kSteps; ++m) {
            const int d = kVec * sub + kVec * kPairLanes * m;
            const Vec<kVec> ri = load_vec<kVec>(rs + i * D + d);
            const Vec<kVec> ki = load_vec<kVec>(ks + i * D + d);
            const Vec<kVec> ud = load_vec<kVec>(us + d);
#pragma unroll
            for (int e = 0; e < kVec; ++e) a = fmaf(ri.x[e] * ud.x[e], ki.x[e], a);
          }
        }
#pragma unroll
        for (int x = 1; x < kPairLanes; x *= 2) a += __shfl_xor_sync(0xffffffffu, a, x);
        if (live && sub < kTiles) at_rank(A, sub)[p] = a;
      }
    }

    // the inter term's partial sums over this thread's rows, then its rows
    // of the state
    if (holds) {
      float* pg = part + g * pstride;
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const float* qi = q + i * D + g0;
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < kRows; d += 4) {
          const float4 x = *reinterpret_cast<const float4*>(qi + d);
          s = fmaf(x.x, S[d], s);
          s = fmaf(x.y, S[d + 1], s);
          s = fmaf(x.z, S[d + 2], s);
          s = fmaf(x.w, S[d + 3], s);
        }
        pg[i * kDV + c] = s;
      }
      float acc[kRows];
#pragma unroll
      for (int d = 0; d < kRows; ++d) acc[d] = 0.f;
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const float vj = to_f32(vs[j * kDV + c]);
        const float* kj = kt + j * D + g0;
#pragma unroll
        for (int d = 0; d < kRows; d += 4) {
          const float4 x = *reinterpret_cast<const float4*>(kj + d);
          acc[d] = fmaf(x.x, vj, acc[d]);
          acc[d + 1] = fmaf(x.y, vj, acc[d + 1]);
          acc[d + 2] = fmaf(x.z, vj, acc[d + 2]);
          acc[d + 3] = fmaf(x.w, vj, acc[d + 3]);
        }
      }
#pragma unroll
      for (int d = 0; d < kRows; ++d) S[d] = fmaf(decay[g0 + d], S[d], acc[d]);
    }
    share_sync();  // A and the partials are complete; the scalar arrays are read

    // the outputs: the partials in ascending g, then the intra-chunk term
    const size_t orow0 = seq + static_cast<size_t>(ch) * L;
#pragma unroll
    for (int i = g; i < L; i += kGroups) {
      float inter = 0.f;
#pragma unroll
      for (int gg = 0; gg < kHeld; ++gg) inter += part[gg * pstride + i * kDV + c];
      float intra = 0.f;
      const float* Ai = A + i * (i + 1) / 2;
#pragma unroll 4
      for (int j = 0; j <= i; ++j) intra = fmaf(Ai[j], to_f32(vs[j * kDV + c]), intra);
      o[(orow0 + i) * D + col0 + c] = inter + intra;
    }
  }
  if (holds) {
#pragma unroll
    for (int d = 0; d < kRows; ++d) {
      S_out[sbase + static_cast<size_t>(g0 + d) * D + col0 + c] = S[d];
    }
  }
}

// The instantiations: D = 16, 32, 48, 64, f32 or bf16, L = 16 unrolled or
// any L; index ((D/16 - 1) * 2 + bf16) * 2 + (L == 16).
constexpr int kKernels = kMaxD / 16 * 2 * 2;
template <typename T, int D>
const void* kernel_of_width(bool fixed) {
  return fixed ? reinterpret_cast<const void*>(wkv_kernel<T, D, kFixedL>)
               : reinterpret_cast<const void*>(wkv_kernel<T, D, 0>);
}
template <typename T>
const void* kernel_of(int D, bool fixed) {
  switch (D) {
    case 16: return kernel_of_width<T, 16>(fixed);
    case 32: return kernel_of_width<T, 32>(fixed);
    case 48: return kernel_of_width<T, 48>(fixed);
    default: return kernel_of_width<T, 64>(fixed);
  }
}
// (value columns a CTA, CTAs a cluster) at head width D
void widths_of(int D, int* dv, unsigned* cluster) {
  switch (D) {
    case 16: *dv = cols<16>(); *cluster = tiles<16>(); break;
    case 32: *dv = cols<32>(); *cluster = tiles<32>(); break;
    case 48: *dv = cols<48>(); *cluster = tiles<48>(); break;
    default: *dv = cols<64>(); *cluster = tiles<64>(); break;
  }
}

bool takes(int D, int L) {
  return D >= 16 && D <= kMaxD && D % 16 == 0 && L >= 1 && L <= kMaxL;
}

struct Instance {
  const void* fn;
  int index;
  int dv;
  unsigned cluster;
  int threads;
  int stages;
  size_t smem;
};
Instance instance(int D, int L, bool bf16) {
  const bool fixed = L == kFixedL;
  const size_t elt = bf16 ? 2 : 4;
  Instance in;
  in.fn = bf16 ? kernel_of<__nv_bfloat16>(D, fixed) : kernel_of<float>(D, fixed);
  in.index = ((D / 16 - 1) * 2 + (bf16 ? 1 : 0)) * 2 + (fixed ? 1 : 0);
  widths_of(D, &in.dv, &in.cluster);
  in.threads = kGroups * in.dv;
  in.stages = smem_bytes(D, L, elt, in.dv, 2) <= kMaxSmem ? 2 : 1;
  in.smem = smem_bytes(D, L, elt, in.dv, in.stages);
  return in;
}

// Raises the kernel's dynamic shared memory limit where it passes 48 KB,
// once a device and instantiation, to the most any call asked for.
int allow_smem(const Instance& in) {
  if (in.smem <= 48 * 1024) return 0;
  static size_t raised[kKernels][64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (in.smem > raised[in.index][dev]) {
    e = cudaFuncSetAttribute(in.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(in.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    raised[in.index][dev] = in.smem;
  }
  return 0;
}

// The launch arguments, packed by the wrapper as 15 64-bit ints in one
// buffer: one ctypes argument to convert instead of 15.
struct WkvArgs {
  unsigned long long r, k, v, logw, u, S0, o, S_out, B, H, T, D, L, bf16,
      stream;
};

}  // namespace

extern "C" {

// Launches the kernel on the packed arguments (S0 0 = a zero initial state;
// bf16 non-zero for bf16 r, k and v) through the driver API
// (driver_launch.cuh).  Returns 0 when launched, the launch's error
// otherwise; -1 for shapes the kernel does not take, -2 for a grid too
// large.
int repro_wkv(const void* packed) {
  WkvArgs p;
  memcpy(&p, packed, sizeof p);
  const int D = static_cast<int>(p.D);
  int H = static_cast<int>(p.H);
  int T = static_cast<int>(p.T);
  int L = static_cast<int>(p.L);
  if (!takes(D, L) || T % L != 0) return -1;
  const Instance in = instance(D, L, p.bf16 != 0);
  const unsigned long long ctas = p.B * p.H * (D / in.dv);
  if (ctas == 0) return 0;
  if (ctas > 0x7fffffffULL) return -2;
  const int err = allow_smem(in);
  if (err != 0) return err;
  static repro::DriverFunction handles[kKernels];
  auto ptr = [](unsigned long long a) {
    return reinterpret_cast<void*>(static_cast<uintptr_t>(a));
  };
  void* r = ptr(p.r);
  void* k = ptr(p.k);
  void* v = ptr(p.v);
  void* logw = ptr(p.logw);
  void* u = ptr(p.u);
  void* S0 = ptr(p.S0);
  void* o = ptr(p.o);
  void* S_out = ptr(p.S_out);
  int stages = in.stages;
  void* params[] = {&r, &k, &v, &logw, &u, &S0, &o, &S_out, &H, &T, &L, &stages};
  return repro::driver_launch(handles[in.index], in.fn, dim3(static_cast<unsigned>(ctas)),
                              in.threads, in.smem,
                              reinterpret_cast<cudaStream_t>(static_cast<uintptr_t>(p.stream)),
                              params, in.cluster);
}

// The launch's shape at head width D, chunk L (bf16 non-zero for bf16
// inputs) and B*H heads, into out[0..8]: CTAs per (b, h), CTAs a cluster,
// threads a CTA, dynamic shared bytes a CTA, registers a thread, local
// (spilled) bytes a thread, CTAs resident on an SM, clusters resident on
// the card, input stages.  Returns 0, -1 for shapes the kernel does not
// take, or a runtime error.
int repro_wkv_geometry(int D, int L, int bf16, int heads, long long* out) {
  if (!takes(D, L) || heads < 1) return -1;
  const Instance in = instance(D, L, bf16 != 0);
  int err = allow_smem(in);
  if (err != 0) return err;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, in.fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  int resident = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, in.fn, in.threads, in.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute cl = {};
  cl.id = cudaLaunchAttributeClusterDimension;
  cl.val.clusterDim.x = in.cluster;
  cl.val.clusterDim.y = 1;
  cl.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(heads * (D / in.dv)));
  config.blockDim = dim3(in.threads);
  config.dynamicSmemBytes = in.smem;
  config.attrs = &cl;
  config.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, in.fn, &config);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = D / in.dv;
  out[1] = in.cluster;
  out[2] = in.threads;
  out[3] = static_cast<long long>(in.smem);
  out[4] = attr.numRegs;
  out[5] = static_cast<long long>(attr.localSizeBytes);
  out[6] = resident;
  out[7] = clusters;
  out[8] = in.stages;
  return 0;
}

const char* repro_error_string(int err) {
  if (err == -1) {
    return "D must be 16, 32, 48 or 64, L in 1..64 and T a multiple of L";
  }
  if (err == -2) return "grid too large (B * H too large)";
  return repro::error_string(err);
}

}  // extern "C"
