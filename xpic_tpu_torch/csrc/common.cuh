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

// The math of the kernels that take both element types T (float and
// double): one overload a type, so that a kernel templated on T calls
// the float intrinsic for float, its float machine code unchanged, and
// the double one for double.
__device__ __forceinline__ float tmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double tmax(double a, double b) {
  return fmax(a, b);
}
__device__ __forceinline__ float tmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double tmin(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ float tabs(float a) { return fabsf(a); }
__device__ __forceinline__ double tabs(double a) { return fabs(a); }
__device__ __forceinline__ float tfma(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double tfma(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float trint(float a) { return rintf(a); }
__device__ __forceinline__ double trint(double a) { return rint(a); }
__device__ __forceinline__ float tfloor(float a) { return floorf(a); }
__device__ __forceinline__ double tfloor(double a) { return floor(a); }

// Two 16-byte vectors: float4 holds four floats, double2 two doubles.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};
