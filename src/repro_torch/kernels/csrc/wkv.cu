// Chunked RWKV6 WKV with the state resident in shared memory, for Hopper
// (sm_90a), hand-written CUDA.
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
// 6 GFLOP of f32 work (the inter term and the state update are 2*L*D*D
// each a chunk): about 0.09 ms of bytes and as much of f32 CUDA-core FLOP,
// the two bounds meet.  The chunk loop is sequential, so only B*H = 160
// CTAs exist: the simple kernel is latency-bound well before either.
//
// Design (simple and right first; no tensor cores, no TMA yet):
//   * one CTA of 256 threads per (b, h) walks the chunks in order, the
//     TPU's "arbitrary" grid axis;
//   * the D x D f32 state lives in shared memory for the whole sequence
//     (16 KB at D = 64), with the chunk's tiles r, k, v, logP, logP_prev,
//     r*e^{logP_prev}, k*e^{logP_L - logP} ([L, D+1] each, the +1 against
//     bank conflicts on column reads) and A [L, L+1];
//   * per chunk: stage the tiles as f32; one thread per channel takes the
//     cumulative sum; the exponentials; A on the j <= i triangle only (one
//     (i, j) pair a thread, expf, fminf); o = inter + intra, one output a
//     thread, written straight to global; then the state update in place.
//   Sums are fmaf in ascending index.  expf, not __expf, and no fast math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxD = 64;
constexpr int kMaxL = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

size_t smem_floats(int D, int L) {
  return static_cast<size_t>(D) * D + 7 * static_cast<size_t>(L) * (D + 1) +
         static_cast<size_t>(L) * (L + 1) + 2 * static_cast<size_t>(D);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ logw,
           const float* __restrict__ u, const float* __restrict__ S0,
           float* __restrict__ o, float* __restrict__ S_out, int H, int T_len,
           int D, int L) {
  extern __shared__ float sm[];
  const int P = D + 1;                 // padded row stride of the tiles
  float* S = sm;                       // [D][D]
  float* rs = S + D * D;               // [L][P] r
  float* ks = rs + L * P;              // k
  float* vs = ks + L * P;              // v
  float* lp = vs + L * P;              // logP
  float* lpp = lp + L * P;             // logP_prev
  float* qs = lpp + L * P;             // r * e^{logP_prev}
  float* kt = qs + L * P;              // k * e^{logP_L - logP}
  float* A = kt + L * P;               // [L][L+1]
  float* decay = A + L * (L + 1);      // [D] e^{logP_L}
  float* us = decay + D;               // [D] u[h]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int h = bh % H;
  const size_t base = static_cast<size_t>(bh) * T_len * D;
  const size_t sbase = static_cast<size_t>(bh) * D * D;

  for (int e = tid; e < D * D; e += kThreads) {
    S[e] = S0 != nullptr ? S0[sbase + e] : 0.f;
  }
  for (int d = tid; d < D; d += kThreads) us[d] = u[static_cast<size_t>(h) * D + d];

  for (int c0 = 0; c0 < T_len; c0 += L) {
    __syncthreads();  // the previous chunk's tiles are consumed
    const size_t off = base + static_cast<size_t>(c0) * D;
    for (int e = tid; e < L * D; e += kThreads) {
      const int i = e / D;
      const int t = i * P + (e - i * D);
      rs[t] = to_f32(r[off + e]);
      ks[t] = to_f32(k[off + e]);
      vs[t] = to_f32(v[off + e]);
      lp[t] = logw[off + e];
    }
    __syncthreads();
    for (int d = tid; d < D; d += kThreads) {  // cumulative sum per channel
      float acc = 0.f;
      for (int i = 0; i < L; ++i) {
        const float w = lp[i * P + d];
        acc += w;
        lp[i * P + d] = acc;
        lpp[i * P + d] = acc - w;
      }
      decay[d] = expf(acc);
    }
    __syncthreads();
    for (int e = tid; e < L * D; e += kThreads) {
      const int i = e / D;
      const int d = e - i * D;
      const int t = i * P + d;
      qs[t] = rs[t] * expf(lpp[t]);
      kt[t] = ks[t] * expf(lp[(L - 1) * P + d] - lp[t]);
    }
    for (int e = tid; e < L * L; e += kThreads) {
      const int i = e / L;
      const int j = e - i * L;
      const float* ri = rs + i * P;
      float a = 0.f;
      if (j < i) {
        const float* kj = ks + j * P;
        const float* pi = lpp + i * P;
        const float* pj = lp + j * P;
        for (int d = 0; d < D; ++d) {
          a = fmaf(ri[d] * kj[d], expf(fminf(pi[d] - pj[d], 0.f)), a);
        }
      } else if (j == i) {
        const float* ki = ks + i * P;
        for (int d = 0; d < D; ++d) a = fmaf(ri[d] * us[d], ki[d], a);
      }
      A[i * (L + 1) + j] = a;
    }
    __syncthreads();
    for (int e = tid; e < L * D; e += kThreads) {  // o = inter + intra
      const int i = e / D;
      const int c = e - i * D;
      const float* qi = qs + i * P;
      float inter = 0.f;
      for (int d = 0; d < D; ++d) inter = fmaf(qi[d], S[d * D + c], inter);
      float intra = 0.f;
      for (int j = 0; j <= i; ++j) intra = fmaf(A[i * (L + 1) + j], vs[j * P + c], intra);
      o[off + e] = inter + intra;
    }
    __syncthreads();  // every read of the old state is done
    for (int e = tid; e < D * D; e += kThreads) {
      const int d = e / D;
      const int c = e - d * D;
      float acc = 0.f;
      for (int j = 0; j < L; ++j) acc = fmaf(kt[j * P + d], vs[j * P + c], acc);
      S[e] = fmaf(decay[d], S[e], acc);
    }
  }
  __syncthreads();
  for (int e = tid; e < D * D; e += kThreads) S_out[sbase + e] = S[e];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, const void* S0, void* o, void* S_out, int B, int H,
           int T_len, int D, int L, cudaStream_t stream) {
  const size_t bytes = smem_floats(D, L) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  wkv_kernel<T><<<B * H, kThreads, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<const float*>(S0),
      static_cast<float*>(o), static_cast<float*>(S_out), H, T_len, D, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched); -1 for shapes
// the kernel does not take.  S0 may be null (a zero initial state).
int repro_wkv(const void* r, const void* k, const void* v, const void* logw,
              const void* u, const void* S0, void* o, void* S_out, int B,
              int H, int T, int D, int L, int bf16, void* stream) {
  if (D < 1 || D > kMaxD || L < 1 || L > kMaxL || T % L != 0) return -1;
  if (B * H == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16>(r, k, v, logw, u, S0, o, S_out, B, H, T, D,
                                 L, s);
  }
  return launch<float>(r, k, v, logw, u, S0, o, S_out, B, H, T, D, L, s);
}

const char* repro_error_string(int err) {
  if (err == -1) return "D must be in 1..64, L in 1..64 and T a multiple of L";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
