// ecsim_fill: the fill of the assembled ECSIM mass route.  For every cell
// g and slot k (t the cell-relative position, v the velocity, B_p the
// magnetic field at the slot):
//   W_c[i, k]          the s1 slot weights (slot_weights.cuh),
//   b = (dt/2)(q/m) B_p,  A_p = (dt^2/2) mpw q^2/m / (1 + b^2),
//   I_p = q mpw / (1 + b^2) (v + v x b + (v.b) b),
//   Islot[g, c, i]     = sum_k W_c[i, k] I_p,c[k],
//   L[g, c, i, d, j]   = sum_k W_c[i, k] A_p[k] matB[c, d](b_k) W_d[j, k],
// where invalid slots add nothing.
//
// Replaces: xpic_tpu/ops/pallas_ecsim.py:_fill_kernel (entry
// ecsim_fill_pallas), which builds the weights as [BG, 12, K] lane stacks
// in TPU VMEM and forms the nine (c, d) blocks as batched MXU products.
//
// Inputs: t, v, B_p [G, K, 3] float32 (the JAX package's layout), valid
// [G, K] bool (one byte a slot).  Outputs: L [G, 3, 12, 3, 12] and Islot
// [G, 3, 12] float32.  K is a launch argument, 1 to 512.
//
// Bound on the H100: bytes.  t, v, B_p and valid in, L and Islot out are
// ~291 MB at G = 32768, K = 96 (L alone 170 MB): 0.087 ms at 3.35 TB/s.
// The nine 12 x 12 outer products are 2 * 9 * 144 = 2,592 float32
// operations a live slot (plus ~40 for the weights and the particle
// terms); at 50 particles a cell that is 4.3 GFLOP, 0.064 ms at
// 67 TFLOP/s.  Invalid slots add nothing, so they count no operations.
//
// Design: one 128-thread block per cell, the cell's slots in chunks of
// 32.  For each chunk the block writes the chunk's rows to shared memory,
// one slot a lane and a quarter of the rows a warp: the 36 weights
// W_c[i], the 108 products W_c[i] A_p matB[c, d] and the 3 components of
// I_p.  Then 108 threads each keep a 3 x 4 register tile of one 12 x 12
// block (c, d) of L, which takes 3 + 4 shared loads and 12 FMAs a slot;
// the other 20 threads keep the 36 sums of Islot.  At the end the sums go
// through shared memory and each warp writes consecutive addresses of
// the [3, 12, 3, 12] block.  The sums run over k in slot order; they
// differ from the plain twin's batched products by rounding only.
//
// What holds this design back: every FMA needs a shared-memory operand
// (7 loads per 12 FMAs), so the load/store pipe and the instruction issue,
// not the FP32 units, set its speed.  The direction for a later PR is
// FP32 tensor-core assembly: the [12, K] x [K, 12] products as 3xTF32
// mma.sync / wgmma tiles (ROADMAP B7), which takes the products off the
// load pipe; below that, the floor is the write of L.
#include "common.cuh"
#include "slot_weights.cuh"

namespace {

constexpr int kFillThreads = 128;
constexpr int kChunk = 32;                       // slots a chunk
constexpr int kRowW = 0;                         // 36 rows: c * 12 + i
constexpr int kRowA = 3 * kSlots;                // 108 rows: (c * 3 + d) * 12 + i
constexpr int kRowI = kRowA + 9 * kSlots;        // 3 rows: I_p,c
// 147 floats a slot: odd, so a warp writing one row for 32 slots touches
// 32 banks.
constexpr int kRows = kRowI + 3;
constexpr int kTiles = 9 * 4 * 3;                // 3 x 4 tiles of nine blocks
constexpr int kIslotThreads = kFillThreads - kTiles;  // 20
constexpr int kBlockSize = 3 * kSlots * 3 * kSlots;   // 1296

// W_c[s] of one slot, c-major, in the plain twin's product order
// (outer * mid) * inner.
__device__ __forceinline__ void slot_weights(const AxisHats& hx,
                                             const AxisHats& hy,
                                             const AxisHats& hz, float* w) {
#pragma unroll
  for (int o = 0; o < 2; ++o)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 3; ++i) w[(o * 2 + m) * 3 + i] = hz.n[o] * hy.n[m] * hx.s[i];
#pragma unroll
  for (int o = 0; o < 2; ++o)
#pragma unroll
    for (int m = 0; m < 3; ++m)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        w[kSlots + (o * 3 + m) * 2 + i] = hz.n[o] * hy.s[m] * hx.n[i];
#pragma unroll
  for (int o = 0; o < 3; ++o)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        w[2 * kSlots + (o * 2 + m) * 2 + i] = hz.s[o] * hy.n[m] * hx.n[i];
}

// Row c of matB(b) = I + b b^T + the antisymmetric part of b.
__device__ __forceinline__ void rotation_row(int c, float bx, float by,
                                             float bz, float* r) {
  if (c == 0) {
    r[0] = 1.0f + bx * bx; r[1] = bz + bx * by;   r[2] = -by + bx * bz;
  } else if (c == 1) {
    r[0] = -bz + by * bx;  r[1] = 1.0f + by * by; r[2] = bx + by * bz;
  } else {
    r[0] = by + bz * bx;   r[1] = -bx + bz * by;  r[2] = 1.0f + bz * bz;
  }
}

__global__ void __launch_bounds__(kFillThreads)
ecsim_fill_kernel(const float* __restrict__ t, const float* __restrict__ v,
                  const float* __restrict__ Bp,
                  const unsigned char* __restrict__ valid,
                  float* __restrict__ L, float* __restrict__ Islot, int K,
                  float half, float coef_a, float coef_i) {
  __shared__ float s[kChunk * kRows];
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // A tile thread's rows i0..i0+2 of block (c, d) and columns j0..j0+3.
  const bool tiler = tid < kTiles;
  const int cd = tid / kSlots;
  const int c = cd / 3, d = cd % 3;
  const int i0 = 3 * ((tid % kSlots) / 3);
  const int j0 = 4 * (tid % 3);
  float acc[3][4];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
  // An Islot thread's entries e0 and e0 + 20 (the second when < 36).
  const int e0 = tid - kTiles;
  const bool two = e0 + kIslotThreads < 3 * kSlots;
  float isum0 = 0.0f, isum1 = 0.0f;

  const size_t row = static_cast<size_t>(g) * K;
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int n = min(kChunk, K - k0);
    if (lane < n) {
      const size_t sk = row + k0 + lane;
      const AxisHats hx = axis_hats(__ldg(t + 3 * sk + 0));
      const AxisHats hy = axis_hats(__ldg(t + 3 * sk + 1));
      const AxisHats hz = axis_hats(__ldg(t + 3 * sk + 2));
      const float bx = __ldg(Bp + 3 * sk + 0) * half;
      const float by = __ldg(Bp + 3 * sk + 1) * half;
      const float bz = __ldg(Bp + 3 * sk + 2) * half;
      const float inv = 1.0f / (1.0f + (bx * bx + by * by + bz * bz));
      const float on = valid[sk] ? 1.0f : 0.0f;
      float w[3 * kSlots];
      slot_weights(hx, hy, hz, w);
      float* sr = s + lane * kRows;
      if (warp == 0) {
#pragma unroll
        for (int j = 0; j < 3 * kSlots; ++j) sr[kRowW + j] = w[j];
        const float vx = __ldg(v + 3 * sk + 0);
        const float vy = __ldg(v + 3 * sk + 1);
        const float vz = __ldg(v + 3 * sk + 2);
        const float ci = coef_i * inv * on;
        const float vb = vx * bx + vy * by + vz * bz;
        sr[kRowI + 0] = ci * (vx + (vy * bz - vz * by) + vb * bx);
        sr[kRowI + 1] = ci * (vy + (vz * bx - vx * bz) + vb * by);
        sr[kRowI + 2] = ci * (vz + (vx * by - vy * bx) + vb * bz);
      } else {
        const int rc = warp - 1;  // the row component of this warp's rows
        float rot[3];
        rotation_row(rc, bx, by, bz, rot);
        const float a = coef_a * inv * on;
#pragma unroll
        for (int dd = 0; dd < 3; ++dd) {
          const float md = a * rot[dd];
#pragma unroll
          for (int i = 0; i < kSlots; ++i)
            sr[kRowA + (rc * 3 + dd) * kSlots + i] = w[rc * kSlots + i] * md;
        }
      }
    }
    __syncthreads();
    if (tiler) {
      const float* sa = s + kRowA + cd * kSlots + i0;
      const float* sw = s + kRowW + d * kSlots + j0;
      for (int k = 0; k < n; ++k) {
        float a[3], w[4];
#pragma unroll
        for (int r = 0; r < 3; ++r) a[r] = sa[k * kRows + r];
#pragma unroll
        for (int q = 0; q < 4; ++q) w[q] = sw[k * kRows + q];
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(a[r], w[q], acc[r][q]);
      }
    } else {
      const int e1 = e0 + kIslotThreads;
      for (int k = 0; k < n; ++k) {
        const float* sk = s + k * kRows;
        isum0 = fmaf(sk[kRowW + e0], sk[kRowI + e0 / kSlots], isum0);
        if (two) isum1 = fmaf(sk[kRowW + e1], sk[kRowI + e1 / kSlots], isum1);
      }
    }
    __syncthreads();
  }

  // The sums in [3, 12, 3, 12] order (L) and then [3, 12] (Islot).
  if (tiler) {
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        s[((c * kSlots + i0 + r) * 3 + d) * kSlots + j0 + q] = acc[r][q];
  } else {
    s[kBlockSize + e0] = isum0;
    if (two) s[kBlockSize + e0 + kIslotThreads] = isum1;
  }
  __syncthreads();
  float* Lg = L + static_cast<size_t>(g) * kBlockSize;
  for (int e = tid; e < kBlockSize; e += kFillThreads) Lg[e] = s[e];
  if (tid < 3 * kSlots)
    Islot[static_cast<size_t>(g) * 3 * kSlots + tid] = s[kBlockSize + tid];
}

}  // namespace

XPIC_API int xpic_ecsim_fill(const float* t, const float* v, const float* Bp,
                             const unsigned char* valid, float* L,
                             float* Islot, int G, int K, float half,
                             float coef_a, float coef_i, void* stream) {
  ecsim_fill_kernel<<<G, kFillThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      t, v, Bp, valid, L, Islot, K, half, coef_a, coef_i);
  return static_cast<int>(cudaGetLastError());
}
