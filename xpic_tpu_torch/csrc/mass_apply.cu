// mass_apply: the per-cell matrix-free ECSIM mass apply for one species,
//   Y[g, c, s] = sum_k W_cs(t_gk) * y_c(g, k),
//   y = coef * (u + (b.u) b + u x b),  u_c = sum_s W_cs(t_gk) * xg[g, c, s],
// with W the factored s1 slot weights (slot_weights.cuh).
//
// Replaces: xpic_tpu/ops/pallas_mass.py:_mass_kernel (entry
// mass_apply_slots_pallas), which runs the same factored chain over
// [128, 8, K] cell blocks in TPU VMEM.  The gather of x to the 12 slots
// per component (xg) and the deposit of Y back to the grid stay PyTorch
// ops, as they stay XLA ops around the TPU kernel.
//
// Inputs: xg [G, 3, 12] float32; packed [G, 8, K] float32 with channel
// rows (tx, ty, tz, bx, by, bz, coef, 0).  Output Y [G, 3, 12].  K is a
// launch argument (the schemes grow K between steps); padding slots carry
// coef = 0 and t at the cell centre, so they add exactly 0.
//
// Bound on the H100: memory.  The operand read is 7 channels x K x 4
// bytes per cell (the zero 8th channel is never read): 73 MB at
// G = 32768, K = 80, plus 9.4 MB of xg and Y, ~25 us at 3.35 TB/s.  The
// arithmetic (~140 FLOP a slot, ~0.37 GFLOP) is far below the card's
// float32 rate.  Design: one warp per cell, one slot per lane, K in
// 32-slot chunks: every channel row is read once, coalesced, and nothing
// per slot is written back.  xg[g] (36 floats) is read once per warp (a
// broadcast load) and kept in registers, as are the 36 partial sums of
// Y; one butterfly shuffle reduction per sum ends the cell.  No atomics
// (the port's determinism rule): the sum order is fixed by K and the warp
// layout, and differs from the twin's torch.sum only by rounding.
#include "common.cuh"
#include "slot_weights.cuh"

namespace {

constexpr int kOperandCh = 8;  // tx, ty, tz, bx, by, bz, coef, 0

__global__ void mass_apply_kernel(const float* __restrict__ xg,
                                  const float* __restrict__ packed,
                                  float* __restrict__ Y, int G, int K) {
  const int g = warp_id();
  if (g >= G) return;  // uniform across the warp
  const int lane = lane_id();

  float x[3 * kSlots];
  const float* Xg = xg + static_cast<size_t>(g) * 3 * kSlots;
#pragma unroll
  for (int j = 0; j < 3 * kSlots; ++j) x[j] = __ldg(Xg + j);

  float acc[3 * kSlots];
#pragma unroll
  for (int j = 0; j < 3 * kSlots; ++j) acc[j] = 0.0f;

  const float* Pg = packed + static_cast<size_t>(g) * kOperandCh * K;
  for (int k = lane; k < K; k += 32) {
    const AxisHats hx = axis_hats(__ldg(Pg + 0 * K + k));
    const AxisHats hy = axis_hats(__ldg(Pg + 1 * K + k));
    const AxisHats hz = axis_hats(__ldg(Pg + 2 * K + k));
    const float bx = __ldg(Pg + 3 * K + k);
    const float by = __ldg(Pg + 4 * K + k);
    const float bz = __ldg(Pg + 5 * K + k);
    const float coef = __ldg(Pg + 6 * K + k);

    float u[3];
    gather_components(hx, hy, hz, x, u);
    const float ub = u[0] * bx + u[1] * by + u[2] * bz;
    const float yx = coef * (u[0] + ub * bx + (u[1] * bz - u[2] * by));
    const float yy = coef * (u[1] + ub * by + (u[2] * bx - u[0] * bz));
    const float yz = coef * (u[2] + ub * bz + (u[0] * by - u[1] * bx));

    deposit_slots3<2, 2, 3>(hz.n, hy.n, hx.s, yx, acc);
    deposit_slots3<2, 3, 2>(hz.n, hy.s, hx.n, yy, acc + kSlots);
    deposit_slots3<3, 2, 2>(hz.s, hy.n, hx.n, yz, acc + 2 * kSlots);
  }

  float* Yg = Y + static_cast<size_t>(g) * 3 * kSlots;
#pragma unroll
  for (int j = 0; j < 3 * kSlots; ++j) {
    float v = acc[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(kFullMask, v, off);
    if (lane == (j & 31)) Yg[j] = v;
  }
}

}  // namespace

XPIC_API int xpic_mass_apply(const float* xg, const float* packed, float* Y,
                             int G, int K, void* stream) {
  mass_apply_kernel<<<warp_blocks(G), 32 * kWarpsPerBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(xg, packed, Y, G,
                                                           K);
  return static_cast<int>(cudaGetLastError());
}
