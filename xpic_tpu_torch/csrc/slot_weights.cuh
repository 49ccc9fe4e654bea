// The factored s1 slot weights of the ECSIM 12-slot layout, shared by
// mass_apply.cu and slot_gather.cu.
//
// Per axis a slot at cell-relative position t in [0, 1) has the node pair
// S1(t), S1(t - 1) and the staggered triple S1(t + 1/2), S1(t - 1/2),
// S1(t - 3/2) (ops/mass_free._axis_hats_planes).  Component c's weight
// of slot s = (o NM + m) NI + i is fo[o] fm[m] fi[i] with the (outer,
// mid, inner) factor sets X: (z node, y node, x stag), Y: (z node,
// y stag, x node), Z: (z stag, y node, x node), the slot order of
// ops/ecsim_blocks.OFFSETS.  The sums below follow the order of the
// plain twins (mass_free._gather_component / _deposit_component).
#pragma once

constexpr int kSlots = 12;

struct AxisHats {
  float n[2];  // node pair
  float s[3];  // staggered triple
};

__device__ __forceinline__ AxisHats axis_hats(float t) {
  AxisHats h;
  h.n[0] = 1.0f - t;
  h.n[1] = t;
  h.s[0] = fmaxf(0.5f - t, 0.0f);
  h.s[1] = 1.0f - fabsf(t - 0.5f);
  h.s[2] = fmaxf(t - 0.5f, 0.0f);
  return h;
}

// sum_s W_s x[s], factored: sum_o fo[o] sum_m fm[m] sum_i fi[i] x[s].
template <int NO, int NM, int NI>
__device__ __forceinline__ float gather_slots3(const float* fo,
                                               const float* fm,
                                               const float* fi,
                                               const float* x) {
  float e = 0.0f;
#pragma unroll
  for (int o = 0; o < NO; ++o) {
    float t2 = 0.0f;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      float t1 = 0.0f;
#pragma unroll
      for (int i = 0; i < NI; ++i) t1 += fi[i] * x[(o * NM + m) * NI + i];
      t2 += fm[m] * t1;
    }
    e += fo[o] * t2;
  }
  return e;
}

// acc[s] += W_s y, as fi[i] * (fm[m] * (fo[o] * y)).
template <int NO, int NM, int NI>
__device__ __forceinline__ void deposit_slots3(const float* fo,
                                               const float* fm,
                                               const float* fi, float y,
                                               float* acc) {
#pragma unroll
  for (int o = 0; o < NO; ++o) {
    const float v1 = fo[o] * y;
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const float v2 = fm[m] * v1;
#pragma unroll
      for (int i = 0; i < NI; ++i) acc[(o * NM + m) * NI + i] += fi[i] * v2;
    }
  }
}

// The three components' slot sums of x [3 * 12] at one slot.
__device__ __forceinline__ void gather_components(const AxisHats& hx,
                                                  const AxisHats& hy,
                                                  const AxisHats& hz,
                                                  const float* x,
                                                  float* u) {
  u[0] = gather_slots3<2, 2, 3>(hz.n, hy.n, hx.s, x);
  u[1] = gather_slots3<2, 3, 2>(hz.n, hy.s, hx.n, x + kSlots);
  u[2] = gather_slots3<3, 2, 2>(hz.s, hy.n, hx.n, x + 2 * kSlots);
}
