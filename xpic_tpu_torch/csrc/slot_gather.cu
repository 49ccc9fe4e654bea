// slot_gather: an E-staggered field at the particle slots through the
// factored s1 slot weights,
//   E_p[g, k, c] = sum_s W_cs(t_gk) * Fg[g, c, s],
// with the 12 slot values per component and cell (Fg) gathered from the
// grid beforehand (ops/ecsim_blocks.gather_slots, a PyTorch op).
//
// Replaces: xpic_tpu/ops/pallas_ecsim.py:_gather_kernel (entry
// ecsim_gather_pallas), which rebuilds the 36 weights per slot in TPU
// VMEM over [3, 128, K] planes.
//
// Inputs: t [G, K, 3] (cell-relative positions in [0, 1), the JAX
// package's layout), Fg [G, 3, 12].  Output [G, K, 3].  K is a launch
// argument.  One source, two element types: xpic_slot_gather takes
// float32, xpic_slot_gather_f64 float64 (the float64 path of the
// schemes), the same kernel template instantiated for each.
//
// Bound on the H100: memory.  t is read and E_p written once, 2 x 12
// bytes a slot in float32 (63 MB at G = 32768, K = 80), plus Fg
// (4.7 MB): ~20 us at 3.35 TB/s; twice that in float64.  ~75 operations
// a slot are negligible in either type.  Design: one warp per cell, one
// slot per lane, K in 32-slot chunks; Fg[g] is read once per warp (a
// broadcast load) into registers (36 values: 72 registers in float64);
// each lane reads its 3 t values and writes its 3 outputs, so a warp
// touches one contiguous span each way.  The sums follow the order of
// the plain twin; nvcc may fuse a multiply and an add, which rounds once.
#include "common.cuh"
#include "slot_weights.cuh"

namespace {

template <typename T>
__global__ void slot_gather_kernel(const T* __restrict__ t,
                                   const T* __restrict__ Fg,
                                   T* __restrict__ out, int G, int K) {
  const int g = warp_id();
  if (g >= G) return;  // uniform across the warp
  const int lane = lane_id();

  T f[3 * kSlots];
  const T* F = Fg + static_cast<size_t>(g) * 3 * kSlots;
#pragma unroll
  for (int j = 0; j < 3 * kSlots; ++j) f[j] = __ldg(F + j);

  const size_t row = static_cast<size_t>(g) * K;
  for (int k = lane; k < K; k += 32) {
    const T* tk = t + (row + k) * 3;
    const AxisHats<T> hx = axis_hats(__ldg(tk + 0));
    const AxisHats<T> hy = axis_hats(__ldg(tk + 1));
    const AxisHats<T> hz = axis_hats(__ldg(tk + 2));
    T e[3];
    gather_components(hx, hy, hz, f, e);
    T* ok = out + (row + k) * 3;
    ok[0] = e[0];
    ok[1] = e[1];
    ok[2] = e[2];
  }
}

template <typename T>
int launch(const T* t, const T* Fg, T* out, int G, int K, void* stream) {
  slot_gather_kernel<T><<<warp_blocks(G), 32 * kWarpsPerBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(t, Fg, out, G,
                                                               K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

XPIC_API int xpic_slot_gather(const float* t, const float* Fg, float* out,
                              int G, int K, void* stream) {
  return launch(t, Fg, out, G, K, stream);
}

XPIC_API int xpic_slot_gather_f64(const double* t, const double* Fg,
                                  double* out, int G, int K, void* stream) {
  return launch(t, Fg, out, G, K, stream);
}
