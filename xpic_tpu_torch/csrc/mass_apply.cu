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
// float32 rate.  Design: a group of kLanes = 16 lanes per cell, two
// cells a warp, one slot per lane, K in 16-slot rounds: every channel
// row is read once, coalesced, and nothing per slot is written back.
// Each lane loads the 7 channels two rounds ahead of the round it works
// on.  xg[g] (36 floats) is read once per lane group (a broadcast load)
// and kept in registers, as are the lane's 36 partial sums of Y.
//
// Sixteen lanes, not 32: K = 80 then runs five full rounds a cell
// instead of three rounds with a sixth of the lanes idle, and K = 112
// seven instead of four with an eighth idle.  A 32-lane build of this
// kernel, timed against it in turns (benchmarks/turns.py) on an H100,
// was slower at both K (PERF.md section 6 has the times).
//
// The cell ends with a reduce-scatter, not 36 whole-group reductions
// (180 shuffles a warp at 32 lanes): at each butterfly level a lane
// sends half of its remaining partial sums to its partner and adds the
// partner's half of the other, so 32 of the sums shrink to two a lane
// over four levels; the last 4 take two such levels and a butterfly.
// 35 shuffles a warp (two cells), and each lane stores the sums it ends
// with, coalesced.  No atomics (the port's determinism rule): the sum
// order is fixed by K and the lane layout, and differs from the twin's
// torch.sum only by rounding.
#include "common.cuh"
#include "slot_weights.cuh"

namespace {

constexpr int kOperandCh = 8;  // tx, ty, tz, bx, by, bz, coef, 0
constexpr int kReadCh = 7;     // the zero channel is never read
constexpr int kSums = 3 * kSlots;
constexpr int kLanes = 16;  // lanes a cell
constexpr int kCellsPerWarp = 32 / kLanes;

__device__ __forceinline__ void load_slot(const float* __restrict__ Pg,
                                          int K, int k, float (&ch)[kReadCh]) {
#pragma unroll
  for (int c = 0; c < kReadCh; ++c) ch[c] = __ldg(Pg + c * K + k);
}

// One reduce-scatter level over the lane bit `off`: of each pair (r[i],
// r[i + h]) a lane keeps the half its bit selects and adds its
// partner's copy of that half.
template <int H>
__device__ __forceinline__ void scatter_level(float* r, int lane, int off) {
  const bool up = (lane & off) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? r[i] : r[i + H];
    const float keep = up ? r[i + H] : r[i];
    r[i] = keep + __shfl_xor_sync(kFullMask, send, off);
  }
}

__global__ void mass_apply_kernel(const float* __restrict__ xg,
                                  const float* __restrict__ packed,
                                  float* __restrict__ Y, int G, int K) {
  const int w = warp_id();
  if (w * kCellsPerWarp >= G) return;  // uniform across the warp
  const int lane = lane_id();
  const int l = lane % kLanes;
  const int g = w * kCellsPerWarp + lane / kLanes;
  const bool live = g < G;  // the second cell of the last warp may not be
  const int k_end = live ? K : 0;

  float x[kSums];
  const float* Xg = xg + static_cast<size_t>(g) * kSums;
#pragma unroll
  for (int j = 0; j < kSums; ++j) x[j] = live ? __ldg(Xg + j) : 0.0f;

  float acc[kSums];
#pragma unroll
  for (int j = 0; j < kSums; ++j) acc[j] = 0.0f;

  const float* Pg = packed + static_cast<size_t>(g) * kOperandCh * K;
  float ch[kReadCh], next[kReadCh];
  if (l < k_end) load_slot(Pg, K, l, ch);
  if (l + kLanes < k_end) load_slot(Pg, K, l + kLanes, next);
  for (int k = l; k < k_end; k += kLanes) {
    float after[kReadCh];
    if (k + 2 * kLanes < k_end) load_slot(Pg, K, k + 2 * kLanes, after);
    const AxisHats hx = axis_hats(ch[0]);
    const AxisHats hy = axis_hats(ch[1]);
    const AxisHats hz = axis_hats(ch[2]);
    const float bx = ch[3], by = ch[4], bz = ch[5], coef = ch[6];

    float u[3];
    gather_components(hx, hy, hz, x, u);
    const float ub = u[0] * bx + u[1] * by + u[2] * bz;
    const float yx = coef * (u[0] + ub * bx + (u[1] * bz - u[2] * by));
    const float yy = coef * (u[1] + ub * by + (u[2] * bx - u[0] * bz));
    const float yz = coef * (u[2] + ub * bz + (u[0] * by - u[1] * bx));

    deposit_slots3<2, 2, 3>(hz.n, hy.n, hx.s, yx, acc);
    deposit_slots3<2, 3, 2>(hz.n, hy.s, hx.n, yy, acc + kSlots);
    deposit_slots3<3, 2, 2>(hz.s, hy.n, hx.n, yz, acc + 2 * kSlots);
#pragma unroll
    for (int c = 0; c < kReadCh; ++c) {
      ch[c] = next[c];
      next[c] = after[c];
    }
  }

  // Sums 0..31: lane bit off = 8 .. 1 picks sum bit 4 .. 1, so lane l
  // ends with sums 2l and 2l + 1.
  scatter_level<16>(acc, lane, 8);
  scatter_level<8>(acc, lane, 4);
  scatter_level<4>(acc, lane, 2);
  scatter_level<2>(acc, lane, 1);
  // Sums 32..35: two levels pick sum bits 1 and 0, then the rest of the
  // group adds up the one that is left.
  float* r4 = acc + 32;
  scatter_level<2>(r4, lane, 8);
  scatter_level<1>(r4, lane, 4);
  r4[0] += __shfl_xor_sync(kFullMask, r4[0], 2);
  r4[0] += __shfl_xor_sync(kFullMask, r4[0], 1);
  if (!live) return;
  float* Yg = Y + static_cast<size_t>(g) * kSums;
  Yg[2 * l] = acc[0];
  Yg[2 * l + 1] = acc[1];
  if ((l & 3) == 0) Yg[32 + 2 * ((l >> 3) & 1) + ((l >> 2) & 1)] = r4[0];
}

}  // namespace

XPIC_API int xpic_mass_apply(const float* xg, const float* packed, float* Y,
                             int G, int K, void* stream) {
  const int warps = (G + kCellsPerWarp - 1) / kCellsPerWarp;
  mass_apply_kernel<<<warp_blocks(warps), 32 * kWarpsPerBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(xg, packed, Y, G,
                                                           K);
  return static_cast<int>(cudaGetLastError());
}
