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
// Inputs: Eblk, Bblk [G, 3, 216] (component, then (dz, dy, dx) offsets
// -2..3 from the cell); t0, tn [G, K, 3] cell-relative positions, with
// `ld` elements between two cells' rows, so that a column slice [:, :kc]
// of a [G, K, 3] tensor is read in place.  Outputs E_p, B_p [G, K, 3]
// contiguous.  One source, two element types: xpic_segment_fields takes
// float32, xpic_segment_fields_f64 float64 (the float64 path of
// eccapfim); both kernels work a cell's items with the same code
// (work_cell) and differ in how the windows reach shared memory.
//
// Bound on the H100: memory, 5.2 KB of windows a cell in float32
// (10.4 KB in float64) read once beside the moves and the two outputs;
// the operations, ~1.3K a live segment (segment_kernel.FLOPS_PER_SEGMENT),
// take a third (1.2 live segments a slot) to two thirds (2.2) of that
// time in float32, and as much in float64 (half the rate, twice the
// bytes).
//
// Design.  One warp a cell: the cell's two windows in shared memory as
// stored, then (slot, segment) items.
//
// * Only the weights that can be nonzero.  S1 is nonzero on 2 window
//   offsets and S2 at one point on 3, so each contraction of the 6^3
//   window runs over the offsets that hold its nonzero weights: 2 x 4 x 4
//   for an E component (its middle and outer axes take S2 at both ends
//   of the segment, 4 offsets apart at most for a segment no longer than
//   a cell), 3 x 3 x 3 for a B component, 177 window loads and ~330 FMAs
//   a segment where the full loops take 1,296 and ~1,700.  The first
//   offset of each support is worked out from the position and checked
//   against the rounded |s| < h test the splines themselves make, so
//   every skipped weight is exactly zero and every sum keeps its order:
//   the result is the full loops' result.  A segment longer than a cell
//   on an axis takes the whole window on E's middle and outer axes, out
//   of line.  Each lane reads from its own window offset; for moves
//   below a cell the lanes' offsets differ by at most 3 an axis, and two
//   of them rarely fall in one bank.
// * Segment-balanced lanes.  A warp would run as many segments as its
//   busiest lane, so lanes take (slot, segment) items, not slots.  In
//   groups of 32 slots each lane counts the live segments (b != a) of
//   its slot and keeps the slot's move in shared memory, a warp prefix
//   sum flattens the counts into an item list, and the warp runs the
//   items 32 at a time.  Each item writes its six raw contractions into
//   a shared [slot][segment] array, and each slot's lane then adds them
//   up in segment order 0..3 with the same FMA chain as a per-slot
//   loop: the result does not depend on which lane ran which item.
//
// float32: the warp loads its cell's windows itself (16-byte loads, then
// __syncwarp), two warps a block, 96 registers, 9.7 KB of shared memory
// a warp.
//
// float64: the windows are twice the bytes, and loaded the float32 way they
// left the warp waiting: 0.104 of 0.37 ms in builds with parts removed (H100
// 80GB HBM3 at 700 W, PERF.md §6).  So a persistent block of kRingWarps = 11
// warps, one an SM, shares kStages = 13 window stages (10.4 KB each, the
// items' term arrays 8.8 KB a warp: 232,096 bytes of dynamic shared memory),
// which one TMA bulk copy a window fills ahead of the warps (see "float64"
// below); 168 registers, no spill, 11 warps an SM (the float32 kernel's 19.2
// KB a warp in float64 gave 10).  The items and sums are work_cell's: the
// float64 outputs are, bit for bit, those of the one-warp-a-cell kernel in
// float64.
//
// No atomics; FMAs in the element type.  rint rounds half to even, as
// jnp.round and torch.round do.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kW = 6;
constexpr int kAnchor = -2;
constexpr int kWin = kW * kW * kW;  // 216
constexpr int kCellWin = 3 * kWin;  // one field's window of a cell
constexpr int kSegments = 4;
constexpr int kTerms = 6;           // E x, y, z and B x, y, z
// Elements a slot in the term array: 4 x 6, plus one so that the slots'
// rows start in different banks.
constexpr int kTermStride = kSegments * kTerms + 1;
constexpr int kSegWarps = 2;    // warps a block
constexpr int kMoveStride = 9;  // x0, d, s1, s2, s3 (odd: no conflicts)

// What a warp keeps of the 32 slots in hand: their moves, their (slot,
// segment) items and the items' terms.
template <typename T>
struct CellParts {
  T terms[32 * kTermStride];
  T moves[32 * kMoveStride];
  unsigned char items[32 * kSegments];  // slot << 2 | segment
};

// One warp's shared memory in the float32 kernel: its cell's windows and
// its parts.
template <typename T>
struct __align__(16) WarpSmem {
  using Vec = typename Vec16<T>::type;
  static constexpr int kVec = 16 / sizeof(T);  // elements a Vec
  Vec win[2 * kCellWin / kVec];  // E, then B, as stored
  CellParts<T> parts;
};

// The splines without branches (both sides computed, one selected): the
// lanes of a warp hold different items, so a branch would run both
// sides anyway, behind a reconvergence barrier.
template <typename T>
__device__ __forceinline__ T spline1(T s) {
  return tmax(T(1) - tabs(s), T(0));
}

template <typename T>
__device__ __forceinline__ T spline2(T s) {
  s = tabs(s);
  const T u = tmax(T(1.5) - s, T(0));
  const T outer = T(0.5) * (u * u);
  return s <= T(0.5) ? T(0.75) - s * s : outer;
}

// Face-crossing parameter of one axis in [0, 1]; 1 = no crossing.
template <typename T>
__device__ __forceinline__ T crossing(T t0, T tn, T d) {
  const T curr = trint(t0);
  if (curr == trint(tn) || d == T(0)) return T(1);
  const T bnd = curr + T(0.5) * (d > T(0) ? T(1) : -T(1));
  return tmin(tmax((bnd - t0) / d, T(0)), T(1));
}

// A slot's move and its sorted crossing parameters: segment s runs from
// tau(s) to tau(s + 1), with tau(0) = 0 and tau(4) = 1.
template <typename T>
struct Move {
  T x0[3], d[3], s1, s2, s3;

  __device__ __forceinline__ T tau(int s) const {
    return s == 0 ? T(0) : s == 1 ? s1 : s == 2 ? s2 : s == 3 ? s3 : T(1);
  }

  __device__ __forceinline__ void store(T* p) const {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      p[ax] = x0[ax];
      p[3 + ax] = d[ax];
    }
    p[6] = s1;
    p[7] = s2;
    p[8] = s3;
  }

  __device__ __forceinline__ static Move load(const T* p) {
    Move m;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      m.x0[ax] = p[ax];
      m.d[ax] = p[3 + ax];
    }
    m.s1 = p[6];
    m.s2 = p[7];
    m.s3 = p[8];
    return m;
  }
};

template <typename T>
__device__ __forceinline__ Move<T> load_move(const T* __restrict__ p0,
                                             const T* __restrict__ pn) {
  Move<T> m;
  T c[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    m.x0[ax] = __ldg(p0 + ax);
    const T xn = __ldg(pn + ax);
    m.d[ax] = xn - m.x0[ax];
    c[ax] = crossing(m.x0[ax], xn, m.d[ax]);
  }
  // The sort3 network of the TPU kernel.
  const T lo1 = tmin(c[0], c[1]), hi1 = tmax(c[0], c[1]);
  m.s1 = tmin(lo1, c[2]);
  const T hi2 = tmax(lo1, c[2]);
  m.s2 = tmin(hi1, hi2);
  m.s3 = tmax(hi1, hi2);
  return m;
}

template <int Order, typename T>
__device__ __forceinline__ T spline(T s) {
  return Order == 1 ? spline1(s) : spline2(s);
}

// The weight of window offset o, S(x - (o + kAnchor + shift)): the same
// float operations as a loop over the 6 offsets, so the same value.
template <int Order, typename T>
__device__ __forceinline__ T weight(T x, T shift, int o) {
  return spline<Order>(x - (static_cast<T>(o + kAnchor) + shift));
}

// Whether weight(x, shift, o) is not zero: |s| < h, h the spline's half
// width (1 for S1, 1.5 for S2), exactly as the splines above decide.
template <int Order, typename T>
__device__ __forceinline__ bool nonzero(T x, T shift, int o) {
  constexpr T h = Order == 1 ? T(1) : T(1.5);
  return tabs(x - (static_cast<T>(o + kAnchor) + shift)) < h;
}

// The first of the consecutive offsets that hold every nonzero weight
// (at most 2 for S1, 3 for S2): the first integer above
// x - kAnchor - shift - h, then moved by one where the rounded |s|
// says otherwise at that edge.
template <int Order, typename T>
__device__ __forceinline__ int support_lo(T x, T shift) {
  constexpr T h = Order == 1 ? T(1) : T(1.5);
  const int k = static_cast<int>(tfloor(x + (T(1) - kAnchor - h - shift)));
  if (nonzero<Order>(x, shift, k - 1)) return k - 1;
  return nonzero<Order>(x, shift, k) ? k : k + 1;
}

// N weights from window offset lo: w[j] = weight(x, shift, lo + j).
template <int Order, int N, typename T>
__device__ __forceinline__ void weights_at(T x, T shift, int lo, T* w) {
#pragma unroll
  for (int j = 0; j < N; ++j) w[j] = weight<Order>(x, shift, lo + j);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Window strides of the three axes in the stored (dz, dy, dx) order.
__device__ __forceinline__ constexpr int stride(int ax) {
  return ax == 0 ? 1 : ax == 1 ? kW : kW * kW;
}

// Both E terms of component CX: the outer sum over axis CY (weights
// sn, s0 of the CY axis), the middle over CZ (A = 2 sn + s0 and
// Bc = 2 s0 + sn of the CZ axis), the inner over CX (sh, 2 offsets),
// each over the window offsets that hold the nonzero weights, in
// increasing order.  `lo` is each axis's first offset of sn / s0,
// `ilo` of sh.
template <int CX, int WM, typename T>
__device__ __forceinline__ T e_component(const T* __restrict__ Es,
                                         const T (&sh)[3][2],
                                         const int (&ilo)[3],
                                         const T (&sn)[3][WM],
                                         const T (&s0)[3][WM],
                                         const int (&lo)[3]) {
  constexpr int CY = (CX + 1) % 3, CZ = (CX + 2) % 3;
  T A[WM], Bc[WM];
#pragma unroll
  for (int j = 0; j < WM; ++j) {
    A[j] = T(2) * sn[CZ][j] + s0[CZ][j];
    Bc[j] = T(2) * s0[CZ][j] + sn[CZ][j];
  }
  const T* base = Es + CX * kWin + lo[CY] * stride(CY) +
                      lo[CZ] * stride(CZ) + ilo[CX] * stride(CX);
  T e1 = T(0), e2 = T(0);
#pragma unroll
  for (int jA = 0; jA < WM; ++jA) {
    T a1 = T(0), a2 = T(0);
#pragma unroll
    for (int jB = 0; jB < WM; ++jB) {
      const T* row = base + jA * stride(CY) + jB * stride(CZ);
      T inner = T(0);
      inner = tfma(sh[CX][0], row[0], inner);
      inner = tfma(sh[CX][1], row[stride(CX)], inner);
      a1 = tfma(A[jB], inner, a1);
      a2 = tfma(Bc[jB], inner, a2);
    }
    e1 = tfma(sn[CY][jA], a1, e1);
    e2 = tfma(s0[CY][jA], a2, e2);
  }
  return e1 + e2;
}

// One B component: sum_z wz (sum_y wy (sum_x wx B)) over 3 offsets an
// axis from (zlo, ylo, xlo).
template <typename T>
__device__ __forceinline__ T b_component(const T* __restrict__ Bs,
                                         const T* wx, int xlo, const T* wy,
                                         int ylo, const T* wz, int zlo) {
  const T* base = Bs + zlo * stride(2) + ylo * stride(1) + xlo;
  T e = T(0);
#pragma unroll
  for (int jz = 0; jz < 3; ++jz) {
    T ay = T(0);
#pragma unroll
    for (int jy = 0; jy < 3; ++jy) {
      const T* row = base + jz * stride(2) + jy * stride(1);
      T ax = T(0);
#pragma unroll
      for (int jx = 0; jx < 3; ++jx) ax = tfma(wx[jx], row[jx], ax);
      ay = tfma(wy[jy], ax, ay);
    }
    e = tfma(wz[jz], ay, e);
  }
  return e;
}

// The three E terms of a segment with sn and s0 over WM offsets an axis
// from lo (WM = 4 holds both ends of a segment no longer than a cell;
// WM = 6 is the whole window).
template <int WM, typename T>
__device__ __forceinline__ void e_terms(const T* __restrict__ Es,
                                        const T (&seg0)[3],
                                        const T (&seg1)[3],
                                        const T (&sh)[3][2],
                                        const int (&ilo)[3],
                                        const int (&lo)[3], T* t) {
  T sn[3][WM], s0[3][WM];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    weights_at<2, WM>(seg1[ax], T(0), lo[ax], sn[ax]);
    weights_at<2, WM>(seg0[ax], T(0), lo[ax], s0[ax]);
  }
  t[0] = e_component<0, WM>(Es, sh, ilo, sn, s0, lo);
  t[1] = e_component<1, WM>(Es, sh, ilo, sn, s0, lo);
  t[2] = e_component<2, WM>(Es, sh, ilo, sn, s0, lo);
}

// A segment longer than a cell on some axis: sn and s0 over the whole
// window.  Kept out of line, so that its registers do not weigh on the
// common path.
template <typename T>
__device__ __noinline__ void e_terms_wide(const T* __restrict__ Es, T a0,
                                          T a1, T a2, T b0, T b1, T b2,
                                          T* t) {
  const T seg0[3] = {a0, a1, a2}, seg1[3] = {b0, b1, b2};
  T sh[3][2];
  int ilo[3];
  const int lo[3] = {0, 0, 0};
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const T th = T(0.5) * (seg0[ax] + seg1[ax]);
    ilo[ax] = clampi(support_lo<1>(th, T(0.5)), 0, kW - 2);
    weights_at<1, 2>(th, T(0.5), ilo[ax], sh[ax]);
  }
  e_terms<kW>(Es, seg0, seg1, sh, ilo, lo, t);
}

// The six raw contractions of one segment [a, b] of a move, into t[6]:
// the sums of the 6^3-window loops, taken over the offsets where the
// weights are not zero (a zero weight adds exactly 0 there).
template <typename T>
__device__ __forceinline__ void segment_terms(const T* __restrict__ Es,
                                              const T* __restrict__ Bs,
                                              const Move<T>& m, T a, T b,
                                              T* t) {
  T seg0[3], seg1[3], th[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    seg0[ax] = m.x0[ax] + a * m.d[ax];
    seg1[ax] = m.x0[ax] + b * m.d[ax];
    th[ax] = T(0.5) * (seg0[ax] + seg1[ax]);
  }
  T sh[3][2];
  int ilo[3], lo[3];
  bool wide = false;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    ilo[ax] = clampi(support_lo<1>(th[ax], T(0.5)), 0, kW - 2);
    weights_at<1, 2>(th[ax], T(0.5), ilo[ax], sh[ax]);
    const int l0 = support_lo<2>(seg0[ax], T(0));
    const int l1 = support_lo<2>(seg1[ax], T(0));
    wide |= abs(l1 - l0) > 1;
    lo[ax] = clampi(min(l0, l1), 0, kW - 4);
  }
  if (wide)
    e_terms_wide(Es, seg0[0], seg0[1], seg0[2], seg1[0], seg1[1], seg1[2],
                 t);
  else
    e_terms<4>(Es, seg0, seg1, sh, ilo, lo, t);

  T wn[3][3], ws[3][3];
  int nlo[3], slo[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    nlo[ax] = clampi(support_lo<2>(th[ax], T(0)), 0, kW - 3);
    slo[ax] = clampi(support_lo<2>(th[ax], T(0.5)), 0, kW - 3);
    weights_at<2, 3>(th[ax], T(0), nlo[ax], wn[ax]);
    weights_at<2, 3>(th[ax], T(0.5), slo[ax], ws[ax]);
  }
  t[3] = b_component(Bs, wn[0], nlo[0], ws[1], slo[1], ws[2], slo[2]);
  t[4] = b_component(Bs + kWin, ws[0], slo[0], wn[1], nlo[1], ws[2],
                     slo[2]);
  t[5] = b_component(Bs + 2 * kWin, ws[0], slo[0], ws[1], slo[1], wn[2],
                     nlo[2]);
}

// Stage a cell's two windows as stored, 16 bytes a load.
template <typename T>
__device__ __forceinline__ void stage_cell(
    const T* __restrict__ Eg, const T* __restrict__ Bg,
    typename WarpSmem<T>::Vec* win, int lane) {
  using Vec = typename WarpSmem<T>::Vec;
  constexpr int kN = kCellWin / WarpSmem<T>::kVec;  // Vecs a window
  const Vec* E4 = reinterpret_cast<const Vec*>(Eg);
  const Vec* B4 = reinterpret_cast<const Vec*>(Bg);
  for (int q = lane; q < kN; q += 32) {
    win[q] = __ldg(E4 + q);
    win[kN + q] = __ldg(B4 + q);
  }
}

// Exclusive prefix sum over the warp's lanes; *total gets the sum.
__device__ __forceinline__ int warp_offset(int n, int lane, int* total) {
  int incl = n;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(kFullMask, incl, off);
    if (lane >= off) incl += up;
  }
  *total = __shfl_sync(kFullMask, incl, 31);
  return incl - n;
}

// One cell's slots against its staged windows Es, Bs (one warp): in
// groups of 32 slots, (1) each lane counts its slot's live segments and
// the warp lists the (slot, segment) items, (2) the items, 32 at a time,
// write their raw contractions into the term array, (3) each slot's lane
// adds its terms up in segment order and writes E_p, B_p.
template <typename T>
__device__ __forceinline__ void work_cell(const T* __restrict__ Es,
                                          const T* __restrict__ Bs,
                                          const T* __restrict__ T0,
                                          const T* __restrict__ Tn,
                                          T* __restrict__ Eout,
                                          T* __restrict__ Bout, int g, int K,
                                          CellParts<T>& p, int lane) {
  for (int base = 0; base < K; base += 32) {
    // 1. Count each slot's live segments and list them.
    const int k = base + lane;
    T* mv = p.moves + lane * kMoveStride;
    int live = 0;
    Move<T> m;
    if (k < K) {
      m = load_move(T0 + 3 * k, Tn + 3 * k);
      m.store(mv);
#pragma unroll
      for (int seg = 0; seg < kSegments; ++seg)
        live += m.tau(seg + 1) - m.tau(seg) != T(0);
    }
    int n_items;
    int at = warp_offset(live, lane, &n_items);
    if (k < K) {
#pragma unroll
      for (int seg = 0; seg < kSegments; ++seg)
        if (m.tau(seg + 1) - m.tau(seg) != T(0))
          p.items[at++] = static_cast<unsigned char>(lane << 2 | seg);
    }
    __syncwarp();

    // 2. The items, 32 at a time: raw contractions into the term array.
    for (int i = lane; i < n_items; i += 32) {
      const int v = p.items[i] >> 2, seg = p.items[i] & 3;
      const Move<T> mi = Move<T>::load(p.moves + v * kMoveStride);
      segment_terms(Es, Bs, mi, mi.tau(seg), mi.tau(seg + 1),
                    p.terms + v * kTermStride + seg * kTerms);
    }
    __syncwarp();

    // 3. Each slot's sum over its live segments, in segment order.
    if (k < K) {
      m = Move<T>::load(mv);
      const T* tv = p.terms + lane * kTermStride;
      T E[3] = {T(0), T(0), T(0)}, B[3] = {T(0), T(0), T(0)};
      T a = T(0);
#pragma unroll
      for (int seg = 0; seg < kSegments; ++seg) {
        const T b = m.tau(seg + 1);
        const T bs = b - a;
        if (bs != T(0)) {
          const T bs6 = bs / T(6);
          const T* t = tv + seg * kTerms;
#pragma unroll
          for (int ax = 0; ax < 3; ++ax) {
            E[ax] = tfma(bs6, t[ax], E[ax]);
            B[ax] = tfma(bs, t[3 + ax], B[ax]);
          }
        }
        a = b;
      }
      const size_t out = (static_cast<size_t>(g) * K + k) * 3;
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        Eout[out + ax] = E[ax];
        Bout[out + ax] = B[ax];
      }
    }
    __syncwarp();
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * kSegWarps)
segment_fields_kernel(const T* __restrict__ Eblk,
                      const T* __restrict__ Bblk,
                      const T* __restrict__ t0,
                      const T* __restrict__ tn, T* __restrict__ Eout,
                      T* __restrict__ Bout, int G, int K, long long ld) {
  __shared__ WarpSmem<T> smem[kSegWarps];
  const int g = warp_id();
  if (g >= G) return;  // uniform across the warp
  const int lane = lane_id();
  WarpSmem<T>& sm = smem[threadIdx.x >> 5];
  stage_cell(Eblk + static_cast<size_t>(g) * kCellWin,
             Bblk + static_cast<size_t>(g) * kCellWin, sm.win, lane);
  __syncwarp();
  const T* Es = reinterpret_cast<const T*>(sm.win);
  work_cell(Es, Es + kCellWin, t0 + g * ld, tn + g * ld, Eout, Bout, g, K,
            sm.parts, lane);
}

// ---- float64: a persistent ring of window stages ---------------------
//
// kRingWarps warps a block share kStages = kRingWarps + 2 stages, each one
// cell's two windows.  The block's cells are g = blockIdx.x + t gridDim.x for
// tickets t = 0, 1, ...; ticket t's windows go into stage t mod kStages.  A
// warp takes the next ticket (a shared atomic), waits for its stage, works the
// cell's items, and then loads ticket t + kStages into the stage it frees,
// with one TMA bulk copy a window (cp.async.bulk completing on the stage's
// mbarrier): the loads of the next two cells run while the warps work theirs
// (one spare stage gave 0.2964 ms, two 0.2935, at K' = 32 of 96; H100 80GB
// HBM3 at 700 W, PERF.md §6).  A warp waits for filled[s] == t before the
// stage's mbarrier, so that it never tests the parity of a phase a stage has
// not begun.
constexpr int kRingWarps = 11;
constexpr int kStages = kRingWarps + 2;
constexpr unsigned kWinBytes = kCellWin * sizeof(double);  // 5,184

struct __align__(16) RingSmem {
  double2 win[kStages][kCellWin];  // per stage E, then B, as stored
  CellParts<double> parts[kRingWarps];
  unsigned long long full[kStages];  // mbarriers: the stage's bytes landed
  int filled[kStages];  // the ticket whose windows the stage holds
  int next_ticket;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Load ticket t's cell g into stage s (one thread): the ticket first, so
// that its warp waits on the stage's phase of this load.
__device__ __forceinline__ void load_stage(RingSmem& sm, int s, int t,
                                           const double* Eg,
                                           const double* Bg) {
  *reinterpret_cast<volatile int*>(&sm.filled[s]) = t;
  const uint32_t bar = smem_addr(&sm.full[s]);
  const uint32_t dst = smem_addr(sm.win[s]);
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
      :: "r"(bar), "r"(2 * kWinBytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(Eg), "r"(kWinBytes), "r"(bar) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(dst + kWinBytes), "l"(Bg), "r"(kWinBytes), "r"(bar)
      : "memory");
}

// Wait until stage s holds ticket t's windows.
__device__ __forceinline__ void wait_stage(RingSmem& sm, int s, int t) {
  while (*reinterpret_cast<volatile int*>(&sm.filled[s]) != t) {
  }
  const uint32_t bar = smem_addr(&sm.full[s]);
  const uint32_t parity = (t / kStages) & 1;
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__global__ void __launch_bounds__(32 * kRingWarps, 1)
segment_fields_f64_kernel(const double* __restrict__ Eblk,
                          const double* __restrict__ Bblk,
                          const double* __restrict__ t0,
                          const double* __restrict__ tn,
                          double* __restrict__ Eout,
                          double* __restrict__ Bout, int G, int K,
                          long long ld) {
  extern __shared__ __align__(16) unsigned char dyn[];
  RingSmem& sm = *reinterpret_cast<RingSmem*>(dyn);
  const int lane = lane_id();
  CellParts<double>& parts = sm.parts[threadIdx.x >> 5];
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   :: "r"(smem_addr(&sm.full[s])), "r"(1) : "memory");
      sm.filled[s] = -1;
    }
    sm.next_ticket = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages; ++s) {
      const long long g = blockIdx.x + static_cast<long long>(s) * gridDim.x;
      if (g >= G) break;
      load_stage(sm, s, s, Eblk + g * kCellWin, Bblk + g * kCellWin);
    }

  for (;;) {
    int t = 0;
    if (lane == 0) t = atomicAdd(&sm.next_ticket, 1);
    t = __shfl_sync(kFullMask, t, 0);
    const long long g = blockIdx.x + static_cast<long long>(t) * gridDim.x;
    if (g >= G) break;  // uniform across the warp
    const int s = t % kStages;
    wait_stage(sm, s, t);
    const double* Es = reinterpret_cast<const double*>(sm.win[s]);
    work_cell(Es, Es + kCellWin, t0 + g * ld, tn + g * ld, Eout, Bout,
              static_cast<int>(g), K, parts, lane);
    __syncwarp();  // every lane is done with the stage
    const long long g2 = g + static_cast<long long>(kStages) * gridDim.x;
    if (lane == 0 && g2 < G) {
      // the stage's reads come before the bulk copy's writes
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      load_stage(sm, s, t + kStages, Eblk + g2 * kCellWin,
                 Bblk + g2 * kCellWin);
    }
  }
}

constexpr int kRingBytes = sizeof(RingSmem);  // past the static 48 KB

// The float64 kernel's dynamic shared memory, allowed on this device.
cudaError_t allow_ring_bytes() {
  return cudaFuncSetAttribute(segment_fields_f64_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kRingBytes);
}

int launch_f64(const double* Eblk, const double* Bblk, const double* t0,
               const double* tn, double* Eout, double* Bout, int G, int K,
               long long ld, void* stream) {
  // Blocks the card holds at once: per SM times SMs, at most one a
  // kRingWarps cells.
  int dev = 0, per_sm = 0, sms = 0;
  cudaError_t err = allow_ring_bytes();
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, segment_fields_f64_kernel, 32 * kRingWarps, kRingBytes);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int work = (G + kRingWarps - 1) / kRingWarps;
  const int resident = per_sm * sms;
  const int blocks = work < resident ? work : resident;
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  segment_fields_f64_kernel<<<blocks, 32 * kRingWarps, kRingBytes,
                              static_cast<cudaStream_t>(stream)>>>(
      Eblk, Bblk, t0, tn, Eout, Bout, G, K, ld);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* Eblk, const T* Bblk, const T* t0, const T* tn, T* Eout,
           T* Bout, int G, int K, long long ld, void* stream) {
  segment_fields_kernel<T><<<(G + kSegWarps - 1) / kSegWarps,
                             32 * kSegWarps, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      Eblk, Bblk, t0, tn, Eout, Bout, G, K, ld);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

XPIC_API int xpic_segment_fields(const float* Eblk, const float* Bblk,
                                 const float* t0, const float* tn,
                                 float* Eout, float* Bout, int G, int K,
                                 long long ld, void* stream) {
  return launch(Eblk, Bblk, t0, tn, Eout, Bout, G, K, ld, stream);
}

XPIC_API int xpic_segment_fields_f64(const double* Eblk, const double* Bblk,
                                     const double* t0, const double* tn,
                                     double* Eout, double* Bout, int G,
                                     int K, long long ld, void* stream) {
  return launch_f64(Eblk, Bblk, t0, tn, Eout, Bout, G, K, ld, stream);
}

XPIC_API int xpic_segment_fields_f64_info(int* out) {
  const cudaError_t err = allow_ring_bytes();
  if (err != cudaSuccess) return static_cast<int>(err);
  return kernel_info(segment_fields_f64_kernel, 32 * kRingWarps, kRingBytes,
                     out);
}
