// rebin_place: one axis pass of the neighbor-exchange migration,
// append the arrivals.
//
// Replaces: xpic_tpu/ops/neighbor_rebin.py:_place_kernel with its folded
// x roll _roll_x_in_block (entry _place_pass), and the two roll kernels
// between extract and place: _roll_outer_pallas (copy_kernel, the z
// roll) and _roll_inner_pallas (_roll_kernel_sub, the y roll).  On the
// TPU the +-1-cell rolls of the direction buffers were separate block
// copies; here each destination cell simply reads its neighbors'
// buffers, so the rolls cost no launch and no extra pass over memory.
//
// For destination cell g along the pass axis:
//   out[g] = P[g] + shift_right(up[g - e], n_res) +
//            shift_right(dn[g + e], n_res + a_up)
// with periodic wrap of g -/+ e (the jnp.roll semantics of the TPU
// path), n_res the live residents of P[g] (left-compacted by the extract
// pass), a_up the live lanes of up[g - e].  Content shifted past AT is
// dropped, as on the TPU.
//
// Bound on the H100: memory (~8 x AT x 4 bytes per cell read and written
// once, plus 2 x 8 x A x 4 bytes of neighbor buffers) and launch latency.
// Design: one warp per destination cell; the two counts are warp sums
// (__reduce_add_sync), AT > 32 runs in 32-column chunks.
#include "common.cuh"

namespace {

__global__ void rebin_place_kernel(const float* __restrict__ P,
                                   const float* __restrict__ up,
                                   const float* __restrict__ dn,
                                   float* __restrict__ out, int G, int AT,
                                   int A, int axis, int nx, int ny,
                                   int nz) {
  const int g = warp_id();
  if (g >= G) return;  // uniform across the warp
  const int lane = lane_id();

  const int cx = g % nx, cy = (g / nx) % ny, cz = g / (nx * ny);
  int gm, gp;  // the cells at -1 and +1 along the axis, wrapped
  if (axis == 0) {
    const int lo = cx == 0 ? nx - 1 : cx - 1, hi = cx == nx - 1 ? 0 : cx + 1;
    gm = (cz * ny + cy) * nx + lo;
    gp = (cz * ny + cy) * nx + hi;
  } else if (axis == 1) {
    const int lo = cy == 0 ? ny - 1 : cy - 1, hi = cy == ny - 1 ? 0 : cy + 1;
    gm = (cz * ny + lo) * nx + cx;
    gp = (cz * ny + hi) * nx + cx;
  } else {
    const int lo = cz == 0 ? nz - 1 : cz - 1, hi = cz == nz - 1 ? 0 : cz + 1;
    gm = (lo * ny + cy) * nx + cx;
    gp = (hi * ny + cy) * nx + cx;
  }

  const float* Pg = P + static_cast<size_t>(g) * kChannels * AT;
  const float* Um = up + static_cast<size_t>(gm) * kChannels * A;
  const float* Dp = dn + static_cast<size_t>(gp) * kChannels * A;
  float* Og = out + static_cast<size_t>(g) * kChannels * AT;

  int n_res = 0;
  for (int base = 0; base < AT; base += 32) {
    const int col = base + lane;
    const int v = col < AT ? static_cast<int>(Pg[kValidCh * AT + col]) : 0;
    n_res += __reduce_add_sync(kFullMask, v);
  }
  int a_up = 0;
  for (int base = 0; base < A; base += 32) {
    const int j = base + lane;
    const int v = j < A ? static_cast<int>(Um[kValidCh * A + j]) : 0;
    a_up += __reduce_add_sync(kFullMask, v);
  }

  for (int col = lane; col < AT; col += 32) {
    const int ju = col - n_res;
    const int jd = ju - a_up;
    const bool take_u = ju >= 0 && ju < A;
    const bool take_d = jd >= 0 && jd < A;
    for (int ch = 0; ch < kChannels; ++ch) {
      const float u = take_u ? Um[ch * A + ju] : 0.0f;
      const float d = take_d ? Dp[ch * A + jd] : 0.0f;
      Og[ch * AT + col] = (Pg[ch * AT + col] + u) + d;
    }
  }
}

}  // namespace

XPIC_API int xpic_rebin_place(const float* P, const float* up,
                              const float* dn, float* out, int G, int AT,
                              int A, int axis, int nx, int ny, int nz,
                              void* stream) {
  rebin_place_kernel<<<warp_blocks(G), 32 * kWarpsPerBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      P, up, dn, out, G, AT, A, axis, nx, ny, nz);
  return static_cast<int>(cudaGetLastError());
}
