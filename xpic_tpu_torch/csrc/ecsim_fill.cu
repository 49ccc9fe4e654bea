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
// Bound on the H100: bytes, counted from what the inputs need.  The
// kernel reads t, v and B_p of live slots only (36 bytes a slot), the
// valid byte of every slot, and writes L and Islot whole:
// 36 n_live + G K + 4 G 1332 bytes.  On the 32^3 x 50 ppc state at
// K = 112 (1.64 M live slots) that is 237 MB, 0.0708 ms at 3.35 TB/s,
// of which the write of L is 0.051 ms.  The operations, 2,632 a live
// slot (the nine 12 x 12 outer products and ~40 for the weights and the
// particle terms), are 4.31 GFLOP: 0.0644 ms at 67 TFLOP/s.
//
// Design: one warp a cell, four cells a block.  What it does about each
// limit of the earlier design (a 128-thread block a cell, every slot in
// chunks of 32, each FMA with a shared-memory operand):
//  1. Dead slots (~55% of them at 50 ppc and K = 112) are never loaded,
//     staged or multiplied.  The warp reads the valid bytes 32 at a time
//     and compacts the live slots' indices in slot order (__ballot_sync
//     and a __popc prefix) into its own list; nothing assumes the live
//     slots form a prefix.
//  2. The products run on the tensor cores, off the shared-load pipe.
//     Per row component c they are one matrix product
//        C_c [12 -> 16, 40] = W_c [12, n] [Z_c | I_c | 0] [n, 40],
//     Z_c[k, (d, j)] = A_p matB_cd W_d[j, k] in columns 0-35 and
//     I_c(k) in column 36, so Islot comes from the same product: mma.sync
//     m16n8k8 TF32, 8 live slots a step (a tile's last step padded with
//     zero rows), five n-tiles a component, in 3xTF32.  Each operand x
//     splits into hi, x rounded to TF32 (to nearest, ties away from
//     zero), and lo = x - hi, and hi lo + lo hi + hi hi go into float32
//     accumulators (60 a lane).  A lane reads 7 weights and 3 float4 of
//     each of its two slot rows, 20 loads for the 45 MMAs of a step, and
//     forms its Z_c entries itself.  A row is 56 floats (56 mod 32 = 24),
//     so the four rows one fragment load touches start 0, 24, 16 and 8
//     banks apart and its 32 lanes hit 32 banks.
//  3. Each live slot is staged once: the list is taken 32 live slots at
//     a time, one lane a slot, which computes the hats, the 36 weights
//     W_c[i] and per c the float4 (A_p matB_c0, A_p matB_c1,
//     A_p matB_c2, I_p,c) and writes them as one row of the warp's tile.
//     Every register array has constant indices: no local-memory frame.
//  4. No block-wide barrier: __syncwarp orders the warp's tile.  The
//     accumulators go straight from the fragments to L and Islot, each
//     float2 store filling a 32-byte sector (3% faster on the card than
//     a pass through shared memory and float4 stores).
// The sums are not taken in slot order: they differ from the plain
// twin's by ~1e-6 of their largest magnitude; two calls on the same
// inputs give the same bits (no atomics, a fixed order of MMAs).
//
// What holds it back (PERF.md, K7): the SM's issue of ~250 instructions
// for every 8 live slots (the 3xTF32 splits are half of them, the 45
// MMAs a sixth) on top of the staging, whose loads and arithmetic cost
// as much again; 127 registers leave 16 warps an SM to hide them.
#include <cstdint>

#include "common.cuh"
#include "slot_weights.cuh"

namespace {

constexpr int kCellsPerBlock = 4;
constexpr int kFillThreads = 32 * kCellsPerBlock;
constexpr int kMaxK = 512;
constexpr int kTile = 32;                   // live slots staged at a time
// A staged slot's row: W_c[i] at c * 12 + i, then (1, 0, 0, 0) (the
// weight of the Islot column and padding), then per c the float4
// (A_p matB_c0, A_p matB_c1, A_p matB_c2, I_p,c).
constexpr int kRowOne = 3 * kSlots;         // 36
constexpr int kRowM = kRowOne + 4;          // 40
constexpr int kRowStride = 56;
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

// Slot sk's row of the tile (sk < 0: a zero row, the padding of a step).
__device__ __forceinline__ void stage_slot(
    const float* __restrict__ t, const float* __restrict__ v,
    const float* __restrict__ Bp, long long sk, float half, float coef_a,
    float coef_i, float* sr) {
  float4* s4 = reinterpret_cast<float4*>(sr);
  if (sk < 0) {
#pragma unroll
    for (int q = 0; q < (kRowM + 12) / 4; ++q)
      s4[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  const AxisHats hx = axis_hats(__ldg(t + 3 * sk + 0));
  const AxisHats hy = axis_hats(__ldg(t + 3 * sk + 1));
  const AxisHats hz = axis_hats(__ldg(t + 3 * sk + 2));
  const float bx = __ldg(Bp + 3 * sk + 0) * half;
  const float by = __ldg(Bp + 3 * sk + 1) * half;
  const float bz = __ldg(Bp + 3 * sk + 2) * half;
  const float vx = __ldg(v + 3 * sk + 0);
  const float vy = __ldg(v + 3 * sk + 1);
  const float vz = __ldg(v + 3 * sk + 2);
  const float inv = 1.0f / (1.0f + (bx * bx + by * by + bz * bz));
  float w[3 * kSlots];
  slot_weights(hx, hy, hz, w);
#pragma unroll
  for (int q = 0; q < 3 * kSlots / 4; ++q)
    s4[q] = make_float4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
  s4[kRowOne / 4] = make_float4(1.0f, 0.0f, 0.0f, 0.0f);
  const float a = coef_a * inv;
  const float ci = coef_i * inv;
  const float vb = vx * bx + vy * by + vz * bz;
  const float I[3] = {ci * (vx + (vy * bz - vz * by) + vb * bx),
                      ci * (vy + (vz * bx - vx * bz) + vb * by),
                      ci * (vz + (vx * by - vy * bx) + vb * bz)};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float rot[3];
    rotation_row(c, bx, by, bz, rot);
    s4[kRowM / 4 + c] = make_float4(a * rot[0], a * rot[1], a * rot[2], I[c]);
  }
}

// x as hi + lo: hi = x rounded to the nearest TF32 on its bits (ties
// away from zero; x finite), lo = x - hi, exact in float32, of which the
// tensor core reads the top 10 mantissa bits (|lo| <= 2^-11 |x|, so what
// it drops is below 2^-21 |x|).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b on the tensor cores: a 16 x 8 (row), b 8 x 8 (col), TF32 in,
// float32 accumulate.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: the small terms first.
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* ahi,
                                           const uint32_t* alo, float b0,
                                           float b1) {
  uint32_t b0hi, b0lo, b1hi, b1lo;
  split_tf32(b0, b0hi, b0lo);
  split_tf32(b1, b1hi, b1lo);
  mma_tf32(d, alo, b0hi, b1hi);
  mma_tf32(d, ahi, b0lo, b1lo);
  mma_tf32(d, ahi, b0hi, b1hi);
}

__global__ void __launch_bounds__(kFillThreads)
ecsim_fill_kernel(const float* __restrict__ t, const float* __restrict__ v,
                  const float* __restrict__ Bp,
                  const unsigned char* __restrict__ valid,
                  float* __restrict__ L, float* __restrict__ Islot, int G,
                  int K, float half, float coef_a, float coef_i) {
  __shared__ __align__(16) float tiles[kCellsPerBlock][kTile * kRowStride];
  __shared__ unsigned short lists[kCellsPerBlock][kMaxK];
  const int warp = threadIdx.x >> 5;
  const int lane = lane_id();
  const int g = blockIdx.x * kCellsPerBlock + warp;
  if (g >= G) return;
  float* tile = tiles[warp];
  unsigned short* list = lists[warp];
  const long long row = static_cast<long long>(g) * K;

  // The live slots' indices, in slot order.
  int n_live = 0;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int k = k0 + lane;
    const bool live = k < K && valid[row + k];
    const unsigned mask = __ballot_sync(kFullMask, live);
    if (live) list[n_live + __popc(mask & ((1u << lane) - 1u))] = k;
    n_live += __popc(mask);
  }

  // The fragment coordinates: group gq (rows gq, gq + 8 of A and C,
  // column gq of B) and thread tq (k-columns tq, tq + 4 of A, rows of B).
  const int gq = lane >> 2;
  const int tq = lane & 3;
  // The B factor of n-tiles 1 and 4 (column 8 + gq: d = 0 or 1; column
  // 32 + gq: d = 2, or the Islot column and padding).
  const bool low = gq < 4;
  float acc[3][5][4];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int n = 0; n < 5; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][n][e] = 0.0f;

  for (int c0 = 0; c0 < n_live; c0 += kTile) {
    const int n = min(kTile, n_live - c0);
    __syncwarp();  // the list is written, the last tile read
    // Each live slot staged once; the rest of the tile's rows zero.
    stage_slot(t, v, Bp, lane < n ? row + list[c0 + lane] : -1LL, half,
               coef_a, coef_i, tile + lane * kRowStride);
    __syncwarp();
    // 8 live slots a step.
    for (int k8 = 0; k8 < n; k8 += 8) {
      const float* r[2] = {tile + (k8 + tq) * kRowStride,
                           tile + (k8 + tq + 4) * kRowStride};
      // The weights this lane reads of its two slot rows, at columns
      // gq + {0, 8, 12, 16, 20, 24, 32} of the row.
      float w[2][7];
      float4 m[2][3];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* p = r[h] + gq;
        w[h][0] = p[0];  w[h][1] = p[8];  w[h][2] = p[12]; w[h][3] = p[16];
        w[h][4] = p[20]; w[h][5] = p[24]; w[h][6] = p[32];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          m[h][c] = reinterpret_cast<const float4*>(r[h] + kRowM)[c];
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        // A_c's rows gq and gq + 8: W_c[gq], W_c[gq + 8] (rows 12-15 of
        // C read the next weights and are never stored).
        const int i0 = c == 0 ? 0 : c == 1 ? 2 : 5;
        const int i1 = c == 0 ? 1 : c == 1 ? 4 : 6;
        uint32_t ahi[4], alo[4];
        split_tf32(w[0][i0], ahi[0], alo[0]);
        split_tf32(w[0][i1], ahi[1], alo[1]);
        split_tf32(w[1][i0], ahi[2], alo[2]);
        split_tf32(w[1][i1], ahi[3], alo[3]);
        // Z_c at this lane's columns: nt * 8 + gq.
#pragma unroll
        for (int nt = 0; nt < 5; ++nt) {
          float z[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 f = m[h][c];
            const float x = nt == 0 ? w[h][0] * f.x
                          : nt == 1 ? w[h][1] * (low ? f.x : f.y)
                          : nt == 2 ? w[h][3] * f.y
                          : nt == 3 ? w[h][5] * f.z
                                    : w[h][6] * (low ? f.z : f.w);
            z[h] = x;
          }
          mma_3xtf32(acc[c][nt], ahi, alo, z[0], z[1]);
        }
      }
    }
  }

  // Straight from the fragments: each float2 store of a fragment
  // row fills a 32-byte sector.
  float* Lg = L + static_cast<size_t>(g) * kBlockSize;
  float* Ig = Islot + static_cast<size_t>(g) * 3 * kSlots;
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int nt = 0; nt < 5; ++nt) {
      const int col = nt * 8 + 2 * tq;
      const float* a = acc[c][nt];
      const int r0 = (c * kSlots + gq) * (3 * kSlots);
      const int r1 = r0 + 8 * (3 * kSlots);
      if (col < 3 * kSlots) {
        *reinterpret_cast<float2*>(Lg + r0 + col) = make_float2(a[0], a[1]);
        if (low)
          *reinterpret_cast<float2*>(Lg + r1 + col) = make_float2(a[2], a[3]);
      } else if (col == 3 * kSlots) {
        Ig[c * kSlots + gq] = a[0];
        if (low) Ig[c * kSlots + gq + 8] = a[2];
      }
    }
}

}  // namespace

XPIC_API int xpic_ecsim_fill(const float* t, const float* v, const float* Bp,
                             const unsigned char* valid, float* L,
                             float* Islot, int G, int K, float half,
                             float coef_a, float coef_i, void* stream) {
  if (K < 1 || K > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (G + kCellsPerBlock - 1) / kCellsPerBlock;
  ecsim_fill_kernel<<<blocks, kFillThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      t, v, Bp, valid, L, Islot, G, K, half, coef_a, coef_i);
  return static_cast<int>(cudaGetLastError());
}
