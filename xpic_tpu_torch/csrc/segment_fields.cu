// segment_fields: eccapfim's path-averaged (E, B) at the particle slots.
// For the move t0 -> tn of each slot, split at node-cell faces into at
// most 4 segments [a, b] (ops/implicit_esirkepov.split_segments),
//   E_p = sum_seg (b - a) * implicit-Esirkepov E gather over the segment,
//   B_p = sum_seg (b - a) * order-2 magnetic Yee gather at its midpoint,
// against the cell's 6^3 window blocks of E and B.
//
// Replaces: xpic_tpu/ops/pallas_implicit.py:_fields_kernel (entry
// segment_fields_pallas).  The TPU kernel cut the G axis into blocks of 8
// cells and ran the segment loop as a select chain so that its ~2.6K-op
// body fitted VMEM; none of that is carried over.
//
// Inputs: Eblk, Bblk [G, 3, 216] float32 (component, then (dz, dy, dx)
// offsets -2..3 from the cell); t0, tn [G, K, 3] float32 cell-relative
// positions, with `ld` floats between two cells' rows, so that a column
// slice [:, :kc] of a [G, K, 3] tensor is read in place.  Outputs E_p,
// B_p [G, K, 3] contiguous.
//
// Bound on the H100: float32 operations.  A segment that is not of zero
// length costs ~3.9K operations (segment_kernel.FLOPS_PER_SEGMENT: the
// weights, 3 x 300 FMAs for E, 3 x 258 for B); the two windows are
// 5.2 KB a cell, read once.  Design: one warp per cell, 4 cells per
// block; the warp stages its cell's two windows in shared memory once,
// and every lane then reads the same address at the same time (a
// broadcast, no bank conflict).  One lane per slot, the slot loop in
// steps of 32.  Each lane computes its three crossing parameters, sorts
// them, and walks the segments with the loop kept rolled; a zero-length
// segment adds exactly 0 and is skipped.  Per segment the per-axis
// 6-weight vectors live in registers and the factored contractions of
// the TPU kernel (_contract_pair, _contract_one) run fully unrolled, so
// every window read is a shared-memory load at a constant offset.  No
// atomics; float32 FMAs.  rintf rounds half to even, as jnp.round and
// torch.round do.
#include "common.cuh"

namespace {

constexpr int kW = 6;
constexpr int kAnchor = -2;
constexpr int kWin = kW * kW * kW;  // 216
constexpr int kCellWin = 3 * kWin;  // one field's window of a cell

__device__ __forceinline__ float spline1(float s) {
  s = fabsf(s);
  return s <= 1.0f ? 1.0f - s : 0.0f;
}

__device__ __forceinline__ float spline2(float s) {
  s = fabsf(s);
  if (s <= 0.5f) return 0.75f - s * s;
  const float u = 1.5f - s;
  return s < 1.5f ? 0.5f * (u * u) : 0.0f;
}

// w[o] = S(t - (o + kAnchor + shift)) for the 6 window offsets.
template <int Order>
__device__ __forceinline__ void weights6(float t, float shift, float* w) {
#pragma unroll
  for (int o = 0; o < kW; ++o) {
    const float s = t - (static_cast<float>(o + kAnchor) + shift);
    w[o] = Order == 1 ? spline1(s) : spline2(s);
  }
}

// Face-crossing parameter of one axis in [0, 1]; 1 = no crossing.
__device__ __forceinline__ float crossing(float t0, float tn, float d) {
  const float curr = rintf(t0);
  if (curr == rintf(tn) || d == 0.0f) return 1.0f;
  const float bnd = curr + 0.5f * (d > 0.0f ? 1.0f : -1.0f);
  return fminf(fmaxf((bnd - t0) / d, 0.0f), 1.0f);
}

__device__ __forceinline__ int flat(int ox, int oy, int oz) {
  return (oz * kW + oy) * kW + ox;
}

// Both E terms of component CX (cyclic CY, CZ): the sh factor on axis CX
// is summed innermost and shared; outer loops over axes CY and CZ.
template <int CX>
__device__ __forceinline__ float contract_pair(const float* __restrict__ blk,
                                               const float* sh,
                                               const float* wA1,
                                               const float* wB1,
                                               const float* wA2,
                                               const float* wB2) {
  constexpr int CY = (CX + 1) % 3, CZ = (CX + 2) % 3;
  float e1 = 0.0f, e2 = 0.0f;
#pragma unroll
  for (int oA = 0; oA < kW; ++oA) {
    float a1 = 0.0f, a2 = 0.0f;
#pragma unroll
    for (int oB = 0; oB < kW; ++oB) {
      float inner = 0.0f;
#pragma unroll
      for (int oi = 0; oi < kW; ++oi) {
        int o[3];
        o[CX] = oi;
        o[CY] = oA;
        o[CZ] = oB;
        inner = fmaf(sh[oi], blk[flat(o[0], o[1], o[2])], inner);
      }
      a1 = fmaf(wB1[oB], inner, a1);
      a2 = fmaf(wB2[oB], inner, a2);
    }
    e1 = fmaf(wA1[oA], a1, e1);
    e2 = fmaf(wA2[oA], a2, e2);
  }
  return e1 + e2;
}

__device__ __forceinline__ float contract_one(const float* __restrict__ blk,
                                              const float* wx,
                                              const float* wy,
                                              const float* wz) {
  float e = 0.0f;
#pragma unroll
  for (int oz = 0; oz < kW; ++oz) {
    float ay = 0.0f;
#pragma unroll
    for (int oy = 0; oy < kW; ++oy) {
      float ax = 0.0f;
#pragma unroll
      for (int ox = 0; ox < kW; ++ox)
        ax = fmaf(wx[ox], blk[flat(ox, oy, oz)], ax);
      ay = fmaf(wy[oy], ax, ay);
    }
    e = fmaf(wz[oz], ay, e);
  }
  return e;
}

template <int CX>
__device__ __forceinline__ float e_component(const float* __restrict__ Es,
                                             const float (&sh)[3][kW],
                                             const float (&sn)[3][kW],
                                             const float (&s0)[3][kW]) {
  constexpr int CY = (CX + 1) % 3, CZ = (CX + 2) % 3;
  float A[kW], Bc[kW];
#pragma unroll
  for (int o = 0; o < kW; ++o) {
    A[o] = 2.0f * sn[CZ][o] + s0[CZ][o];
    Bc[o] = 2.0f * s0[CZ][o] + sn[CZ][o];
  }
  return contract_pair<CX>(Es + CX * kWin, sh[CX], sn[CY], A, s0[CY], Bc);
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
segment_fields_kernel(const float* __restrict__ Eblk,
                      const float* __restrict__ Bblk,
                      const float* __restrict__ t0,
                      const float* __restrict__ tn, float* __restrict__ Eout,
                      float* __restrict__ Bout, int G, int K, long long ld) {
  __shared__ float win[kWarpsPerBlock][2 * kCellWin];
  const int g = warp_id();
  if (g >= G) return;  // uniform across the warp
  const int lane = lane_id();
  float* Es = win[threadIdx.x >> 5];
  float* Bs = Es + kCellWin;
  const float* Eg = Eblk + static_cast<size_t>(g) * kCellWin;
  const float* Bg = Bblk + static_cast<size_t>(g) * kCellWin;
  for (int j = lane; j < kCellWin; j += 32) {
    Es[j] = __ldg(Eg + j);
    Bs[j] = __ldg(Bg + j);
  }
  __syncwarp();

  for (int k = lane; k < K; k += 32) {
    const float* p0 = t0 + g * ld + 3 * k;
    const float* pn = tn + g * ld + 3 * k;
    float x0[3], d[3], c[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      x0[ax] = __ldg(p0 + ax);
      const float xn = __ldg(pn + ax);
      d[ax] = xn - x0[ax];
      c[ax] = crossing(x0[ax], xn, d[ax]);
    }
    // Sorted crossing parameters: the sort3 network of the TPU kernel.
    const float c0 = c[0], c1 = c[1], c2 = c[2];
    const float lo1 = fminf(c0, c1), hi1 = fmaxf(c0, c1);
    const float s1 = fminf(lo1, c2), hi2 = fmaxf(lo1, c2);
    const float s2 = fminf(hi1, hi2), s3 = fmaxf(hi1, hi2);

    float E[3] = {0.0f, 0.0f, 0.0f}, B[3] = {0.0f, 0.0f, 0.0f};
    float a = 0.0f;
#pragma unroll 1
    for (int s = 0; s < 4; ++s) {
      const float b = s == 0 ? s1 : s == 1 ? s2 : s == 2 ? s3 : 1.0f;
      const float bs = b - a;
      if (bs != 0.0f) {
        float seg0[3], seg1[3], th[3];
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          seg0[ax] = x0[ax] + a * d[ax];
          seg1[ax] = x0[ax] + b * d[ax];
          th[ax] = 0.5f * (seg0[ax] + seg1[ax]);
        }
        {
          float sh[3][kW], sn[3][kW], s0[3][kW];
#pragma unroll
          for (int ax = 0; ax < 3; ++ax) {
            weights6<1>(th[ax], 0.5f, sh[ax]);
            weights6<2>(seg1[ax], 0.0f, sn[ax]);
            weights6<2>(seg0[ax], 0.0f, s0[ax]);
          }
          const float bs6 = bs / 6.0f;
          E[0] = fmaf(bs6, e_component<0>(Es, sh, sn, s0), E[0]);
          E[1] = fmaf(bs6, e_component<1>(Es, sh, sn, s0), E[1]);
          E[2] = fmaf(bs6, e_component<2>(Es, sh, sn, s0), E[2]);
        }
        float wn[3][kW], ws[3][kW];
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          weights6<2>(th[ax], 0.0f, wn[ax]);
          weights6<2>(th[ax], 0.5f, ws[ax]);
        }
        B[0] = fmaf(bs, contract_one(Bs, wn[0], ws[1], ws[2]), B[0]);
        B[1] = fmaf(bs, contract_one(Bs + kWin, ws[0], wn[1], ws[2]), B[1]);
        B[2] = fmaf(bs, contract_one(Bs + 2 * kWin, ws[0], ws[1], wn[2]),
                    B[2]);
      }
      a = b;
    }
    float* oe = Eout + (static_cast<size_t>(g) * K + k) * 3;
    float* ob = Bout + (static_cast<size_t>(g) * K + k) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      oe[c] = E[c];
      ob[c] = B[c];
    }
  }
}

}  // namespace

XPIC_API int xpic_segment_fields(const float* Eblk, const float* Bblk,
                                 const float* t0, const float* tn,
                                 float* Eout, float* Bout, int G, int K,
                                 long long ld, void* stream) {
  segment_fields_kernel<<<warp_blocks(G), 32 * kWarpsPerBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      Eblk, Bblk, t0, tn, Eout, Bout, G, K, ld);
  return static_cast<int>(cudaGetLastError());
}
