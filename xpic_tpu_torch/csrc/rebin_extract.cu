// rebin_extract: one axis pass of the neighbor-exchange migration,
// classify and compact.
//
// Replaces: xpic_tpu/ops/neighbor_rebin.py:_extract_kernel (entry
// _extract_pass).  The TPU kernel packs 128/AT cells per 128-lane
// register row and compacts with log2(AT) butterfly lane rolls; neither
// is needed on a GPU, so this kernel works on the unpacked buffer.
//
// Input P [G, 8, AT] float32 per cell: channels rx, ry, rz, px, py, pz,
// valid, 0 of the movers in the cell's buffer.  Outputs:
//   out [G, 8, AT]: the lanes that stay along this axis, left-compacted
//                   in source order, every other lane exactly 0;
//   up, dn [G, 8, A]: the +1 and -1 movers, compacted the same way
//                   (movers past A are dropped; the exact guard on the
//                   host side keeps the fast path clear of that).
// Classification follows the TPU kernel bit for bit: the cell coordinate
// is the int truncation of the position (positions are >= 0), clamped to
// [0, n_ax); +1 and -1 wrap unconditionally; n_ax == 2 has no -1 class.
//
// Bound on the H100: memory, ~2 x 8 x AT x 4 bytes per cell read and
// written once (~8 MB a pass at 32^3 with AT = 32), and launch latency
// at that size.  Design: one warp per cell.  AT = 32 is exactly one
// warp; smaller AT masks the upper lanes, AT = 64 runs two 32-column
// chunks with the ranks carried from the first.  A class's stable rank
// is __popc(ballot & lanemask_lt) plus the carry, which replaces the
// butterfly compaction; every store lands on a distinct lane.
#include "common.cuh"

namespace {

__global__ void rebin_extract_kernel(const float* __restrict__ P,
                                     float* __restrict__ out,
                                     float* __restrict__ up,
                                     float* __restrict__ dn, int G, int AT,
                                     int A, int axis, int n_ax, int nx,
                                     int ny) {
  const int g = warp_id();
  if (g >= G) return;  // uniform across the warp
  const int lane = lane_id();
  const unsigned lt = (1u << lane) - 1u;

  const int home = axis == 0   ? g % nx
                   : axis == 1 ? (g / nx) % ny
                               : g / (nx * ny);
  const int hp = (home + 1 == n_ax) ? 0 : home + 1;
  const int hm = (home == 0) ? n_ax - 1 : home - 1;

  const float* Pg = P + static_cast<size_t>(g) * kChannels * AT;
  float* Og = out + static_cast<size_t>(g) * kChannels * AT;
  float* Ug = up + static_cast<size_t>(g) * kChannels * A;
  float* Dg = dn + static_cast<size_t>(g) * kChannels * A;

  int n_stay = 0, n_up = 0, n_dn = 0;
  for (int base = 0; base < AT; base += 32) {
    const int col = base + lane;
    int cls = 0;  // 0 empty, 1 stay, 2 up (+1), 3 down (-1)
    if (col < AT && Pg[kValidCh * AT + col] > 0.5f) {
      int cq = static_cast<int>(Pg[axis * AT + col]);
      cq = min(max(cq, 0), n_ax - 1);
      if (cq == hp)
        cls = 2;
      else if (n_ax != 2 && cq == hm)
        cls = 3;
      else
        cls = 1;
    }
    const unsigned ms = __ballot_sync(kFullMask, cls == 1);
    const unsigned mu = __ballot_sync(kFullMask, cls == 2);
    const unsigned md = __ballot_sync(kFullMask, cls == 3);
    if (cls == 1) {
      const int dst = n_stay + __popc(ms & lt);
      for (int ch = 0; ch < kChannels; ++ch)
        Og[ch * AT + dst] = Pg[ch * AT + col];
    } else if (cls == 2) {
      const int dst = n_up + __popc(mu & lt);
      if (dst < A)
        for (int ch = 0; ch < kChannels; ++ch)
          Ug[ch * A + dst] = Pg[ch * AT + col];
    } else if (cls == 3) {
      const int dst = n_dn + __popc(md & lt);
      if (dst < A)
        for (int ch = 0; ch < kChannels; ++ch)
          Dg[ch * A + dst] = Pg[ch * AT + col];
    }
    n_stay += __popc(ms);
    n_up += __popc(mu);
    n_dn += __popc(md);
  }

  // Zero every lane no mover landed on.
  for (int col = lane; col < AT; col += 32)
    if (col >= n_stay)
      for (int ch = 0; ch < kChannels; ++ch) Og[ch * AT + col] = 0.0f;
  for (int j = lane; j < A; j += 32) {
    if (j >= n_up)
      for (int ch = 0; ch < kChannels; ++ch) Ug[ch * A + j] = 0.0f;
    if (j >= n_dn)
      for (int ch = 0; ch < kChannels; ++ch) Dg[ch * A + j] = 0.0f;
  }
}

}  // namespace

XPIC_API int xpic_rebin_extract(const float* P, float* out, float* up,
                                float* dn, int G, int AT, int A, int axis,
                                int n_ax, int nx, int ny, void* stream) {
  rebin_extract_kernel<<<warp_blocks(G), 32 * kWarpsPerBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      P, out, up, dn, G, AT, A, axis, n_ax, nx, ny);
  return static_cast<int>(cudaGetLastError());
}
