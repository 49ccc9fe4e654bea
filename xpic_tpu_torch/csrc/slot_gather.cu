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
// Inputs: t [G, K, 3] float32 (cell-relative positions in [0, 1), the
// JAX package's layout), Fg [G, 3, 12] float32.  Output [G, K, 3].  K is
// a launch argument.
//
// Bound on the H100: memory.  t is read and E_p written once, 2 x 12
// bytes a slot (63 MB at G = 32768, K = 80), plus Fg (4.7 MB): ~20 us at
// 3.35 TB/s; ~75 FLOP a slot is negligible.  Design: one warp per cell,
// one slot per lane, K in 32-slot chunks; Fg[g] is read once per warp (a
// broadcast load) into registers; each lane reads its 3 t values and
// writes its 3 outputs, so a warp touches one contiguous 384-byte span
// each way.  The sums follow the order of the plain twin; nvcc may fuse
// a multiply and an add, which rounds once.
#include "common.cuh"
#include "slot_weights.cuh"

namespace {

__global__ void slot_gather_kernel(const float* __restrict__ t,
                                   const float* __restrict__ Fg,
                                   float* __restrict__ out, int G, int K) {
  const int g = warp_id();
  if (g >= G) return;  // uniform across the warp
  const int lane = lane_id();

  float f[3 * kSlots];
  const float* F = Fg + static_cast<size_t>(g) * 3 * kSlots;
#pragma unroll
  for (int j = 0; j < 3 * kSlots; ++j) f[j] = __ldg(F + j);

  const size_t row = static_cast<size_t>(g) * K;
  for (int k = lane; k < K; k += 32) {
    const float* tk = t + (row + k) * 3;
    const AxisHats hx = axis_hats(__ldg(tk + 0));
    const AxisHats hy = axis_hats(__ldg(tk + 1));
    const AxisHats hz = axis_hats(__ldg(tk + 2));
    float e[3];
    gather_components(hx, hy, hz, f, e);
    float* ok = out + (row + k) * 3;
    ok[0] = e[0];
    ok[1] = e[1];
    ok[2] = e[2];
  }
}

}  // namespace

XPIC_API int xpic_slot_gather(const float* t, const float* Fg, float* out,
                              int G, int K, void* stream) {
  slot_gather_kernel<<<warp_blocks(G), 32 * kWarpsPerBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(t, Fg, out, G,
                                                            K);
  return static_cast<int>(cudaGetLastError());
}
