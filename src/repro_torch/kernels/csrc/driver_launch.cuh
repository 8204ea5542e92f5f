// Kernel launches through the CUDA driver API, for the port's kernels whose
// host launch cost matters (K2 influence.cu, K3 event_matmul.cu) and K4
// (wkv.cu), which launches thread-block clusters.
//
// cuLaunchKernel on a handle looked up once a device (cudaGetFuncBySymbol)
// took less host time than the runtime's <<<>>> launch, which goes through
// the runtime's own launch bookkeeping first, when the two were timed in
// turn on an H100's host.  A driver error r comes back as
// kDriverErrorBase - r; a runtime error as itself.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace repro {

constexpr int kDriverErrorBase = -1000;

// One handle cache per kernel instantiation (a function-local static at the
// call site), one slot a device.
struct DriverFunction {
  CUfunction slot[64] = {};
};

// Launches `kernel` on `grid` x `threads` with `smem` bytes of dynamic
// shared memory on `stream`, in clusters of `cluster` CTAs along x where
// cluster > 1; params[i] points at the kernel's i-th argument.  Returns 0
// when launched.
inline int driver_launch(DriverFunction& fn, const void* kernel, dim3 grid,
                         int threads, size_t smem, cudaStream_t stream,
                         void** params, unsigned cluster = 1) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  CUfunction& f = fn.slot[dev];
  if (f == nullptr) {
    e = cudaGetFuncBySymbol(&f, kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  CUresult r;
  if (cluster > 1) {
    CUlaunchAttribute attr = {};
    attr.id = CU_LAUNCH_ATTRIBUTE_CLUSTER_DIMENSION;
    attr.value.clusterDim.x = cluster;
    attr.value.clusterDim.y = 1;
    attr.value.clusterDim.z = 1;
    CUlaunchConfig config = {};
    config.gridDimX = grid.x;
    config.gridDimY = grid.y;
    config.gridDimZ = grid.z;
    config.blockDimX = static_cast<unsigned>(threads);
    config.blockDimY = 1;
    config.blockDimZ = 1;
    config.sharedMemBytes = static_cast<unsigned>(smem);
    config.hStream = reinterpret_cast<CUstream>(stream);
    config.attrs = &attr;
    config.numAttrs = 1;
    r = cuLaunchKernelEx(&config, f, params, nullptr);
  } else {
    r = cuLaunchKernel(f, grid.x, grid.y, grid.z, threads, 1, 1,
                       static_cast<unsigned>(smem),
                       reinterpret_cast<CUstream>(stream), params, nullptr);
  }
  return r == CUDA_SUCCESS ? 0 : kDriverErrorBase - static_cast<int>(r);
}

inline const char* error_string(int err) {
  if (err <= kDriverErrorBase) {
    const char* s = nullptr;
    cuGetErrorString(static_cast<CUresult>(kDriverErrorBase - err), &s);
    return s != nullptr ? s : "unknown CUDA driver error";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // namespace repro
