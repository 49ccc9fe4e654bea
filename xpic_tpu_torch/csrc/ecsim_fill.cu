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
// Inputs: t, v, B_p [G, K, 3] (the JAX package's layout), valid [G, K]
// bool (one byte a slot).  Outputs: L [G, 3, 12, 3, 12] and Islot
// [G, 3, 12].  K is a launch argument, 1 to 512.  One source, two element
// types: xpic_ecsim_fill takes float32 and forms the products on tensor
// cores (below), xpic_ecsim_fill_f64 takes float64 (the float64 path of
// ECSIM and ecsimcorr, which always assembles) and forms them as DFMA
// loops; both instantiate one kernel template and share its live-slot
// list, its staging and its weights.
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
// Design (float32): one warp a cell, four cells a block.  What it does
// about each
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
//
// Design (float64): the same live-slot list and the same staging, once
// a live slot, 32 at a time, into a row of 50 doubles (the 36 weights,
// then per c the double2 pairs (A_p matB_c0, A_p matB_c1) and
// (A_p matB_c2, I_p,c); 50 mod 16 = 2, so a double2 store of 8 lanes
// into 8 rows hits 8 distinct 16-byte bank groups).  Two cells a block:
// the float tile of 32 x 56 floats would take 57 KB a block of four in
// double, past the 48 KB of static shared memory; two take 27.6 KB.
// The products have no float64 tensor-core form in mma.sync m16n8k8, so
// they run as DFMA loops: the 1,332 outputs of a cell are 90 work units,
// the 81 4 x 4 sub-blocks of L (3 x 3 in each of the nine 12 x 12
// (c, d) blocks) and the 9 quads of Islot, unit u = lane + 32 q, q < 3.
// For each staged slot a lane reads its units' weight quads (double2
// loads) and A_p matB_cd, forms z_j = A_p matB_cd W_d[j] and adds
// W_c[i] z_j into its accumulators (at most 48 doubles), the order of
// the twin's assemble_blocks (M W first, then the K-sum), so the sums
// differ from the twin's only by the rounding of their order.  Bound:
// 72 n_live + G K + 8 G 1332 bytes (471 MB, 0.141 ms at K = 112 on the
// 32^3 x 50 ppc state) against 2,632 operations a live slot at
// 34 TFLOP/s (0.127 ms): bytes.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "slot_weights.cuh"

namespace {

constexpr int kMaxK = 512;
constexpr int kTile = 32;                   // live slots staged at a time
constexpr int kBlockSize = 3 * kSlots * 3 * kSlots;   // 1296

// The block and tile layout of each element type.  A staged slot's row
// holds W_c[i] at c * 12 + i, then, from kRowM, per c the four values
// (A_p matB_c0, A_p matB_c1, A_p matB_c2, I_p,c).
template <typename T>
struct Fill;
template <>
struct Fill<float> {
  static constexpr int kCells = 4;    // cells (warps) a block
  // (1, 0, 0, 0) at kRowOne: the weight of the Islot column and padding.
  static constexpr int kRowOne = 3 * kSlots;  // 36
  static constexpr int kRowM = kRowOne + 4;   // 40
  static constexpr int kRowStride = 56;
};
template <>
struct Fill<double> {
  static constexpr int kCells = 2;
  static constexpr int kRowM = 3 * kSlots;    // 36
  static constexpr int kRowStride = 50;
};

// Four values into a row at p (16-byte aligned): one float4 or two
// double2 stores.
__device__ __forceinline__ void put4(float* p, float a, float b, float c,
                                     float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void put4(double* p, double a, double b,
                                     double c, double d) {
  reinterpret_cast<double2*>(p)[0] = make_double2(a, b);
  reinterpret_cast<double2*>(p)[1] = make_double2(c, d);
}

// W_c[s] of one slot, c-major, in the plain twin's product order
// (outer * mid) * inner.
template <typename T>
__device__ __forceinline__ void slot_weights(const AxisHats<T>& hx,
                                             const AxisHats<T>& hy,
                                             const AxisHats<T>& hz, T* w) {
#pragma unroll
  for (int o = 0; o < 2; ++o)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 3; ++i)
        w[(o * 2 + m) * 3 + i] = hz.n[o] * hy.n[m] * hx.s[i];
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
template <typename T>
__device__ __forceinline__ void rotation_row(int c, T bx, T by, T bz,
                                             T* r) {
  if (c == 0) {
    r[0] = T(1) + bx * bx; r[1] = bz + bx * by;   r[2] = -by + bx * bz;
  } else if (c == 1) {
    r[0] = -bz + by * bx;  r[1] = T(1) + by * by; r[2] = bx + by * bz;
  } else {
    r[0] = by + bz * bx;   r[1] = -bx + bz * by;  r[2] = T(1) + bz * bz;
  }
}

// Slot sk's row of the tile (sk < 0: a zero row, the padding of a step
// of the float32 products).
template <typename T>
__device__ __forceinline__ void stage_slot(
    const T* __restrict__ t, const T* __restrict__ v,
    const T* __restrict__ Bp, long long sk, T half, T coef_a, T coef_i,
    T* sr) {
  constexpr int kRowM = Fill<T>::kRowM;
  if (sk < 0) {
#pragma unroll
    for (int q = 0; q < (kRowM + 12) / 4; ++q)
      put4(sr + 4 * q, T(0), T(0), T(0), T(0));
    return;
  }
  const AxisHats<T> hx = axis_hats(__ldg(t + 3 * sk + 0));
  const AxisHats<T> hy = axis_hats(__ldg(t + 3 * sk + 1));
  const AxisHats<T> hz = axis_hats(__ldg(t + 3 * sk + 2));
  const T bx = __ldg(Bp + 3 * sk + 0) * half;
  const T by = __ldg(Bp + 3 * sk + 1) * half;
  const T bz = __ldg(Bp + 3 * sk + 2) * half;
  const T vx = __ldg(v + 3 * sk + 0);
  const T vy = __ldg(v + 3 * sk + 1);
  const T vz = __ldg(v + 3 * sk + 2);
  const T inv = T(1) / (T(1) + (bx * bx + by * by + bz * bz));
  T w[3 * kSlots];
  slot_weights(hx, hy, hz, w);
#pragma unroll
  for (int q = 0; q < 3 * kSlots / 4; ++q)
    put4(sr + 4 * q, w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
  if constexpr (std::is_same<T, float>::value)
    put4(sr + Fill<T>::kRowOne, T(1), T(0), T(0), T(0));
  const T a = coef_a * inv;
  const T ci = coef_i * inv;
  const T vb = vx * bx + vy * by + vz * bz;
  const T I[3] = {ci * (vx + (vy * bz - vz * by) + vb * bx),
                  ci * (vy + (vz * bx - vx * bz) + vb * by),
                  ci * (vz + (vx * by - vy * bx) + vb * bz)};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    T rot[3];
    rotation_row(c, bx, by, bz, rot);
    put4(sr + kRowM + 4 * c, a * rot[0], a * rot[1], a * rot[2], I[c]);
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

// The float32 products of cell g on the tensor cores, from its list of
// n_live live slots; writes the cell's L and Islot.
__device__ __forceinline__ void tf32_products(
    const float* __restrict__ t, const float* __restrict__ v,
    const float* __restrict__ Bp, const unsigned short* list, float* tile,
    int n_live, long long row, int g, int lane, float half, float coef_a,
    float coef_i, float* __restrict__ L, float* __restrict__ Islot) {
  constexpr int kRowM = Fill<float>::kRowM;
  constexpr int kRowStride = Fill<float>::kRowStride;
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

// The float64 work units (see the header): 81 sub-blocks of L, then 9
// quads of Islot; a lane takes units lane, lane + 32 and lane + 64.
constexpr int kLUnits = 81;
constexpr int kUnits = kLUnits + 9;

// Unit u's offsets in a staged row: its W_c quad, its W_d quad (L units)
// and its A_p matB_cd (L) or I_p,c (Islot); and its first output.
struct Unit {
  int wc, wd, m, out;

  __device__ __forceinline__ static Unit of(int u) {
    constexpr int kRowM = Fill<double>::kRowM;
    Unit x;
    if (u < kLUnits) {
      const int cd = u / 9, c = cd / 3, d = cd % 3;
      const int i4 = 4 * ((u % 9) / 3), j4 = 4 * (u % 3);
      x.wc = c * kSlots + i4;
      x.wd = d * kSlots + j4;
      x.m = kRowM + 4 * c + d;
      x.out = (c * kSlots + i4) * (3 * kSlots) + d * kSlots + j4;
    } else {
      const int c = (u - kLUnits) / 3, i4 = 4 * ((u - kLUnits) % 3);
      x.wc = c * kSlots + i4;
      x.wd = 0;
      x.m = kRowM + 4 * c + 3;
      x.out = c * kSlots + i4;
    }
    return x;
  }
};

// acc[4 i + j] += W_c[i] (A_p matB_cd W_d[j]) for one staged row r.
__device__ __forceinline__ void l_unit(const double* r, const Unit& x,
                                       double* acc) {
  const double2 a01 = *reinterpret_cast<const double2*>(r + x.wc);
  const double2 a23 = *reinterpret_cast<const double2*>(r + x.wc + 2);
  const double2 b01 = *reinterpret_cast<const double2*>(r + x.wd);
  const double2 b23 = *reinterpret_cast<const double2*>(r + x.wd + 2);
  const double m = r[x.m];
  const double a[4] = {a01.x, a01.y, a23.x, a23.y};
  const double z[4] = {m * b01.x, m * b01.y, m * b23.x, m * b23.y};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[4 * i + j] = fma(a[i], z[j], acc[4 * i + j]);
}

// A 4 x 4 sub-block of L from its accumulators, as double2 pairs.
__device__ __forceinline__ void store_l(double* o, const double* acc) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    double2* p = reinterpret_cast<double2*>(o + i * 3 * kSlots);
    p[0] = make_double2(acc[4 * i], acc[4 * i + 1]);
    p[1] = make_double2(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

// The float64 products of cell g as DFMA loops, from its list of n_live
// live slots; writes the cell's L and Islot.
__device__ __forceinline__ void f64_products(
    const double* __restrict__ t, const double* __restrict__ v,
    const double* __restrict__ Bp, const unsigned short* list,
    double* tile, int n_live, long long row, int g, int lane, double half,
    double coef_a, double coef_i, double* __restrict__ L,
    double* __restrict__ Islot) {
  constexpr int kRowStride = Fill<double>::kRowStride;
  // Units lane and lane + 32 are sub-blocks of L; unit lane + 64 is one
  // for lanes 0-16, a quad of Islot for lanes 17-25 and none after.
  const Unit u0 = Unit::of(lane), u1 = Unit::of(lane + 32);
  const int u = lane + 64;
  const Unit u2 = Unit::of(u < kUnits ? u : 0);
  const bool l2 = u < kLUnits, i2 = u >= kLUnits && u < kUnits;
  double acc[3][16];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[q][e] = 0.0;

  for (int c0 = 0; c0 < n_live; c0 += kTile) {
    const int n = min(kTile, n_live - c0);
    __syncwarp();  // the list is written, the last tile read
    if (lane < n)
      stage_slot(t, v, Bp, row + list[c0 + lane], half, coef_a, coef_i,
                 tile + lane * kRowStride);
    __syncwarp();
    for (int k = 0; k < n; ++k) {
      const double* r = tile + k * kRowStride;
      l_unit(r, u0, acc[0]);
      l_unit(r, u1, acc[1]);
      if (l2) {
        l_unit(r, u2, acc[2]);
      } else if (i2) {
        const double2 a01 = *reinterpret_cast<const double2*>(r + u2.wc);
        const double2 a23 =
            *reinterpret_cast<const double2*>(r + u2.wc + 2);
        const double m = r[u2.m];
        acc[2][0] = fma(a01.x, m, acc[2][0]);
        acc[2][1] = fma(a01.y, m, acc[2][1]);
        acc[2][2] = fma(a23.x, m, acc[2][2]);
        acc[2][3] = fma(a23.y, m, acc[2][3]);
      }
    }
  }

  double* Lg = L + static_cast<size_t>(g) * kBlockSize;
  double* Ig = Islot + static_cast<size_t>(g) * 3 * kSlots;
  store_l(Lg + u0.out, acc[0]);
  store_l(Lg + u1.out, acc[1]);
  if (l2) {
    store_l(Lg + u2.out, acc[2]);
  } else if (i2) {
    reinterpret_cast<double2*>(Ig + u2.out)[0] =
        make_double2(acc[2][0], acc[2][1]);
    reinterpret_cast<double2*>(Ig + u2.out)[1] =
        make_double2(acc[2][2], acc[2][3]);
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * Fill<T>::kCells)
ecsim_fill_kernel(const T* __restrict__ t, const T* __restrict__ v,
                  const T* __restrict__ Bp,
                  const unsigned char* __restrict__ valid,
                  T* __restrict__ L, T* __restrict__ Islot, int G, int K,
                  T half, T coef_a, T coef_i) {
  constexpr int kCells = Fill<T>::kCells;
  __shared__ __align__(16) T tiles[kCells][kTile * Fill<T>::kRowStride];
  __shared__ unsigned short lists[kCells][kMaxK];
  const int warp = threadIdx.x >> 5;
  const int lane = lane_id();
  const int g = blockIdx.x * kCells + warp;
  if (g >= G) return;
  T* tile = tiles[warp];
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

  if constexpr (std::is_same<T, float>::value)
    tf32_products(t, v, Bp, list, tile, n_live, row, g, lane, half, coef_a,
                  coef_i, L, Islot);
  else
    f64_products(t, v, Bp, list, tile, n_live, row, g, lane, half, coef_a,
                 coef_i, L, Islot);
}

template <typename T>
int launch(const T* t, const T* v, const T* Bp, const unsigned char* valid,
           T* L, T* Islot, int G, int K, T half, T coef_a, T coef_i,
           void* stream) {
  if (K < 1 || K > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kCells = Fill<T>::kCells;
  const int blocks = (G + kCells - 1) / kCells;
  ecsim_fill_kernel<T><<<blocks, 32 * kCells, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      t, v, Bp, valid, L, Islot, G, K, half, coef_a, coef_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

XPIC_API int xpic_ecsim_fill(const float* t, const float* v, const float* Bp,
                             const unsigned char* valid, float* L,
                             float* Islot, int G, int K, float half,
                             float coef_a, float coef_i, void* stream) {
  return launch(t, v, Bp, valid, L, Islot, G, K, half, coef_a, coef_i,
                stream);
}

XPIC_API int xpic_ecsim_fill_f64(const double* t, const double* v,
                                 const double* Bp,
                                 const unsigned char* valid, double* L,
                                 double* Islot, int G, int K, double half,
                                 double coef_a, double coef_i,
                                 void* stream) {
  return launch(t, v, Bp, valid, L, Islot, G, K, half, coef_a, coef_i,
                stream);
}
