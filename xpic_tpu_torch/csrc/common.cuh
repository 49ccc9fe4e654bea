// Shared helpers of the port's Hopper kernels (sm_90a).
//
// Every kernel has a plain C entry point, exported from one shared
// library and bound with ctypes (xpic_tpu_torch/kernels.py).  An entry
// point enqueues its kernel on the stream it is given, allocates
// nothing, does not synchronise, and returns cudaGetLastError() so the
// caller can raise on a launch that CUDA refused.
#pragma once

#include <cuda_runtime.h>

#define XPIC_API extern "C" __attribute__((visibility("default")))

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kChannels = 8;   // rx, ry, rz, px, py, pz, valid, 0
constexpr int kValidCh = 6;
constexpr int kWarpsPerBlock = 4;

// One warp per cell: the warp index of this thread.
__device__ __forceinline__ int warp_id() {
  return (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

inline int warp_blocks(int n_warps) {
  return (n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
}
