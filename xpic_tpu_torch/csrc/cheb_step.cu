// cheb_step: the degree-`degree` Chebyshev semi-iteration
//   x ~ ((2 + shift) I + beta curl- curl+)^{-1} rhs
// on a Yee field [3, nz, ny, nx], in one launch an apply.  One source,
// two element types: xpic_cheb_step takes float32, xpic_cheb_step_f64
// float64 (the float64 path of the schemes; its scalars are doubles
// too), the same kernel template instantiated for each.
//
// Replaces: xpic_tpu/ops/pallas_stencil.py:_cheb_kernel (entry
// cheb_matM_inv_pallas), which runs the whole recurrence in one dispatch
// with the field resident in TPU VMEM.
//
// Bound on the H100: operations, with rhs read and x written once.  Per
// element, a middle sweep does 33 operations (four curl+ taps of
// 5, 5 to combine them, 1 for x, 4 for r, 3 for d); the first sweep 13
// more (its 13 distinct taps of rhs, each scaled by 1/theta); the last
// only x += d.  So an apply of degree k >= 2 does 46 + 33 (k - 2) + 1
// operations an element, 377 at degree 12: 0.00055 ms at 32^3 in float32
// (67 TFLOP/s), 0.0011 ms in float64 (34 TFLOP/s).  What an
// apply really waits on is its `degree` dependent sweeps: each needs all
// of the previous sweep's d.  The working set (x, r, two d buffers, rhs:
// ~2 MB at 32^3 in float32, 4 MB in float64) stays in the 50 MB L2.
//
// Design: one cooperative launch (cudaLaunchCooperativeKernel).  The grid
// is as many blocks as the card holds at once (the occupancy query times
// the SM count, asked at every launch for the instantiation launched:
// the float64 one holds more registers), capped at the work.  Each
// iteration is a grid-stride sweep over the 3 nz ny nx elements, so
// every grid size, however large, goes through the same kernel, and a
// grid-wide barrier (cooperative_groups::this_grid().sync()) separates
// the iterations, with a ping-pong d buffer.  The field need not fit
// anywhere on chip.  A launch the runtime refuses returns its error;
// there is no second path.  512 threads a block (ptxas, float32: 40
// registers, no spill).  Per element, (curl- curl+ d)[c, i] comes
// straight from d through the 2-hop stencil (periodic wrap or zero fill
// per axis, as ops/stencil.shift), its 13 tap positions worked out once
// from the cell's wrapped neighbour offsets, then
//   x += d;  r -= a d + beta cc;  d_out = cd d + cr r.
//
// Coherence: d, x and r are written by this launch and read after a grid
// barrier, d by other blocks.  They are read with plain coherent loads:
// no __ldg and no const __restrict__, because a non-coherent
// (ld.global.nc) load may return a line cached before the barrier.
// Only rhs and shift are read-only.
//
// The shift is a device scalar: every thread starts the rho recurrence
// from it at entry and advances it one step an iteration, so the apply
// needs no host synchronisation.  The arithmetic follows the TPU
// kernel's expression order; nvcc may contract a multiply and an add
// into an FMA, which rounds once instead of twice (agreement with the
// plain twin is checked to 1e-5 relative in float32, 1e-12 in float64).
//
// The slab form (xpic_cheb_sweep, xpic_cheb_sweep_f64): a run over a
// 1-D z mesh of ranks holds a z slab of the field, and a launch cannot
// wait for another process's plane, so there an apply is one launch a
// sweep: 12 launches, with the two boundary planes of d exchanged
// between them by the caller (11 exchanges: the first sweep reads rhs's,
// the last reads no neighbour).  rhs, d0 and d1 carry one ghost z plane
// on each side ([3, nz + 2, ny, nx]); x and r are the slab's own
// [3, nz, ny, nx].  A sweep computes each element from the same values
// in the same order as the one-launch kernel (the same tap code, the
// scalar recurrence advanced k times from the shift), so the slab form
// gives the one-launch kernel's bits on the same global field.  Whether
// the ghost plane below (zlo) and above (zhi) exists is the caller's:
// no at a non-periodic global z bound.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;

template <typename T>
struct Grid {
  int nx, ny, nz;
  int px, py, pz;  // 1 = periodic axis
  T ix, iy, iz;  // inverse cell steps
};

// Bring a coordinate one step outside [0, n) back in on a periodic
// axis; false when it lies outside a zero-filled axis.
__device__ __forceinline__ bool wrap(int& q, int n, int periodic) {
  if (q < 0) {
    if (!periodic) return false;
    q += n;
  } else if (q >= n) {
    if (!periodic) return false;
    q -= n;
  }
  return true;
}

// One cell's neighbourhood, worked out once an element: along each axis
// (0 = x, 1 = y, 2 = z) the element offsets of the coordinate one step
// below, at and one step above the cell ([0], [1], [2]; wrapped on a
// periodic axis), and whether each lies inside the grid.  Every tap of
// the 2-hop stencil is one of these per axis, so a tap costs a test and
// two adds.
struct Nbhd {
  int off[3][3];
  bool in[3][3];

  __device__ __forceinline__ void set(int axis, int q, int n, int periodic,
                                      int stride) {
    int lo = q - 1, hi = q + 1;
    in[axis][0] = wrap(lo, n, periodic);
    in[axis][1] = true;
    in[axis][2] = wrap(hi, n, periodic);
    off[axis][0] = lo * stride;
    off[axis][1] = q * stride;
    off[axis][2] = hi * stride;
  }
  // z on a slab: q is the own plane, the field is padded with one ghost
  // plane a side (own plane q at padded plane q + 1).
  __device__ __forceinline__ void set_slab(int q, int n, int zlo, int zhi,
                                           int stride) {
    in[2][0] = q > 0 || zlo;
    in[2][1] = true;
    in[2][2] = q < n - 1 || zhi;
    off[2][0] = q * stride;
    off[2][1] = (q + 1) * stride;
    off[2][2] = (q + 2) * stride;
  }
  __device__ __forceinline__ bool inside(int ix, int iy, int iz) const {
    return in[0][ix] && in[1][iy] && in[2][iz];
  }
  __device__ __forceinline__ int at(int ix, int iy, int iz) const {
    return off[0][ix] + off[1][iy] + off[2][iz];
  }
};

template <typename T>
struct Field {
  const T* d;    // current direction (unused when first); written by
                 // the previous sweep, so never read through __ldg
  const T* rhs;  // first iteration: d = rhs / theta
  T inv_theta;
  bool first;
  int n;         // elements of a component

  // Component c at the neighbour (ix, iy, iz) of N; zero outside.
  __device__ __forceinline__ T at(const Nbhd& N, int c, int ix, int iy,
                                  int iz) const {
    if (!N.inside(ix, iy, iz)) return T(0);
    const int idx = c * n + N.at(ix, iy, iz);
    return first ? rhs[idx] * inv_theta : d[idx];
  }
};

// Component c of curl+ d at the neighbour (ix, iy, iz) of N (each index
// below 2: a tap adds one step); zero outside the grid.
template <typename T>
__device__ __forceinline__ T curlp_at(const Field<T>& F, const Nbhd& N,
                                      const Grid<T>& g, int c, int ix,
                                      int iy, int iz) {
  if (!N.inside(ix, iy, iz)) return T(0);
  if (c == 0) {
    const T fz = F.at(N, 2, ix, iy, iz), fy = F.at(N, 1, ix, iy, iz);
    return (F.at(N, 2, ix, iy + 1, iz) - fz) * g.iy -
           (F.at(N, 1, ix, iy, iz + 1) - fy) * g.iz;
  }
  if (c == 1) {
    const T fx = F.at(N, 0, ix, iy, iz), fz = F.at(N, 2, ix, iy, iz);
    return (F.at(N, 0, ix, iy, iz + 1) - fx) * g.iz -
           (F.at(N, 2, ix + 1, iy, iz) - fz) * g.ix;
  }
  const T fy = F.at(N, 1, ix, iy, iz), fx = F.at(N, 0, ix, iy, iz);
  return (F.at(N, 1, ix + 1, iy, iz) - fy) * g.ix -
         (F.at(N, 0, ix, iy + 1, iz) - fx) * g.iy;
}

// Component c of curl- curl+ d at N's cell.
template <typename T>
__device__ __forceinline__ T curlcurl_at(const Field<T>& F, const Nbhd& N,
                                         const Grid<T>& g, int c) {
  if (c == 0) {
    const T gz = curlp_at(F, N, g, 2, 1, 1, 1);
    const T gy = curlp_at(F, N, g, 1, 1, 1, 1);
    return (gz - curlp_at(F, N, g, 2, 1, 0, 1)) * g.iy -
           (gy - curlp_at(F, N, g, 1, 1, 1, 0)) * g.iz;
  }
  if (c == 1) {
    const T gx = curlp_at(F, N, g, 0, 1, 1, 1);
    const T gz = curlp_at(F, N, g, 2, 1, 1, 1);
    return (gx - curlp_at(F, N, g, 0, 1, 1, 0)) * g.iz -
           (gz - curlp_at(F, N, g, 2, 0, 1, 1)) * g.ix;
  }
  const T gy = curlp_at(F, N, g, 1, 1, 1, 1);
  const T gx = curlp_at(F, N, g, 0, 1, 1, 1);
  return (gy - curlp_at(F, N, g, 1, 0, 1, 1)) * g.ix -
         (gx - curlp_at(F, N, g, 0, 1, 0, 1)) * g.iy;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    cheb_apply_kernel(const T* __restrict__ rhs, const T* __restrict__ shift,
                      T* x, T* r, T* d0, T* d1, Grid<T> g, T beta,
                      T beta_lam, int degree) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int n = g.nx * g.ny * g.nz;
  const int total = 3 * n;
  const int stride = gridDim.x * blockDim.x;

  // Scalar recurrence from the device shift, advanced once an iteration.
  const T a = T(2) + shift[0];
  const T b = a + beta_lam;
  const T theta = T(0.5) * (b + a);
  const T delta = T(0.5) * (b - a);
  const T sigma1 = theta / delta;
  const T inv_theta = T(1) / theta;
  T rho = T(1) / sigma1;

  for (int k = 0; k < degree; ++k) {
    const T rho_new = T(1) / (T(2) * sigma1 - rho);
    const T cd = rho_new * rho;
    const T cr = T(2) * rho_new / delta;
    const bool first = (k == 0);
    const bool last = (k == degree - 1);
    const T* d_in = (k & 1) ? d1 : d0;
    T* d_out = (k & 1) ? d0 : d1;
    const Field<T> F{d_in, rhs, inv_theta, first, n};
    for (int tid = blockIdx.x * blockDim.x + threadIdx.x; tid < total;
         tid += stride) {
      const T dv = first ? rhs[tid] * inv_theta : d_in[tid];
      x[tid] = (first ? T(0) : x[tid]) + dv;
      if (last) continue;  // the last sweep's r and d are never read
      const int c = tid / n;
      const int cell = tid - c * n;
      const int row = cell / g.nx;
      Nbhd N;
      N.set(0, cell - row * g.nx, g.nx, g.px, 1);
      N.set(1, row % g.ny, g.ny, g.py, g.nx);
      N.set(2, row / g.ny, g.nz, g.pz, g.nx * g.ny);
      const T cc = curlcurl_at(F, N, g, c);
      const T rv = (first ? rhs[tid] : r[tid]) - (a * dv + beta * cc);
      r[tid] = rv;
      d_out[tid] = cd * dv + cr * rv;
    }
    rho = rho_new;
    if (!last) grid.sync();
  }
}

// Sweep k of the slab form: rhs, d_in and d_out padded, x and r own.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    cheb_sweep_kernel(const T* __restrict__ rhs, const T* __restrict__ shift,
                      T* x, T* r, const T* d_in, T* d_out, Grid<T> g,
                      int zlo, int zhi, T beta, T beta_lam, int k,
                      int degree) {
  const int plane = g.nx * g.ny;
  const int n = plane * g.nz;
  const int np = plane * (g.nz + 2);
  const int total = 3 * n;

  const T a = T(2) + shift[0];
  const T b = a + beta_lam;
  const T theta = T(0.5) * (b + a);
  const T delta = T(0.5) * (b - a);
  const T sigma1 = theta / delta;
  const T inv_theta = T(1) / theta;
  T rho = T(1) / sigma1;
  for (int j = 0; j < k; ++j) rho = T(1) / (T(2) * sigma1 - rho);
  const T rho_new = T(1) / (T(2) * sigma1 - rho);
  const T cd = rho_new * rho;
  const T cr = T(2) * rho_new / delta;
  const bool first = (k == 0);
  const bool last = (k == degree - 1);
  const Field<T> F{d_in, rhs, inv_theta, first, np};
  const int stride = gridDim.x * blockDim.x;
  for (int tid = blockIdx.x * blockDim.x + threadIdx.x; tid < total;
       tid += stride) {
    const int c = tid / n;
    const int cell = tid - c * n;
    const int pidx = c * np + cell + plane;
    const T dv = first ? rhs[pidx] * inv_theta : d_in[pidx];
    x[tid] = (first ? T(0) : x[tid]) + dv;
    if (last) continue;
    const int row = cell / g.nx;
    Nbhd N;
    N.set(0, cell - row * g.nx, g.nx, g.px, 1);
    N.set(1, row % g.ny, g.ny, g.py, g.nx);
    N.set_slab(row / g.ny, g.nz, zlo, zhi, plane);
    const T cc = curlcurl_at(F, N, g, c);
    const T rv = (first ? rhs[pidx] : r[tid]) - (a * dv + beta * cc);
    r[tid] = rv;
    d_out[pidx] = cd * dv + cr * rv;
  }
}

template <typename T>
int launch_sweep(const T* rhs, const T* shift, T* x, T* r, const T* d_in,
                 T* d_out, int nx, int ny, int nz, int px, int py, int zlo,
                 int zhi, T ix, T iy, T iz, T beta, T beta_lam, int k,
                 int degree, void* stream) {
  if (degree < 1 || k < 0 || k >= degree)
    return static_cast<int>(cudaErrorInvalidValue);
  Grid<T> g{nx, ny, nz, px, py, 0, ix, iy, iz};
  const int blocks = (3 * nx * ny * nz + kThreads - 1) / kThreads;
  cheb_sweep_kernel<T><<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      rhs, shift, x, r, d_in, d_out, g, zlo, zhi, beta, beta_lam, k, degree);
  return static_cast<int>(cudaGetLastError());
}

// r, d0 and d1 are scratch fields of rhs's shape; x receives the apply.
template <typename T>
int launch(const T* rhs, const T* shift, T* x, T* r, T* d0, T* d1, int nx,
           int ny, int nz, int px, int py, int pz, T ix, T iy, T iz, T beta,
           T beta_lam, int degree, void* stream) {
  if (degree < 1) return static_cast<int>(cudaErrorInvalidValue);
  // Blocks the card holds at once: per SM times SMs.
  int dev = 0, per_sm = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cheb_apply_kernel<T>, kThreads, 0);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int resident = per_sm * sms;
  Grid<T> g{nx, ny, nz, px, py, pz, ix, iy, iz};
  const int work = (3 * nx * ny * nz + kThreads - 1) / kThreads;
  const int blocks = work < resident ? work : resident;
  void* args[] = {&rhs, &shift, &x, &r, &d0, &d1, &g, &beta, &beta_lam,
                  &degree};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(cheb_apply_kernel<T>), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

XPIC_API int xpic_cheb_step(const float* rhs, const float* shift, float* x,
                            float* r, float* d0, float* d1, int nx, int ny,
                            int nz, int px, int py, int pz, float ix,
                            float iy, float iz, float beta, float beta_lam,
                            int degree, void* stream) {
  return launch(rhs, shift, x, r, d0, d1, nx, ny, nz, px, py, pz, ix, iy, iz,
                beta, beta_lam, degree, stream);
}

XPIC_API int xpic_cheb_step_f64(const double* rhs, const double* shift,
                                double* x, double* r, double* d0, double* d1,
                                int nx, int ny, int nz, int px, int py,
                                int pz, double ix, double iy, double iz,
                                double beta, double beta_lam, int degree,
                                void* stream) {
  return launch(rhs, shift, x, r, d0, d1, nx, ny, nz, px, py, pz, ix, iy, iz,
                beta, beta_lam, degree, stream);
}

XPIC_API int xpic_cheb_step_f64_info(int* out) {
  return kernel_info(cheb_apply_kernel<double>, kThreads, 0, out);
}

XPIC_API int xpic_cheb_sweep(const float* rhs, const float* shift, float* x,
                             float* r, const float* d_in, float* d_out,
                             int nx, int ny, int nz, int px, int py, int zlo,
                             int zhi, float ix, float iy, float iz,
                             float beta, float beta_lam, int k, int degree,
                             void* stream) {
  return launch_sweep(rhs, shift, x, r, d_in, d_out, nx, ny, nz, px, py, zlo,
                      zhi, ix, iy, iz, beta, beta_lam, k, degree, stream);
}

XPIC_API int xpic_cheb_sweep_f64(const double* rhs, const double* shift,
                                 double* x, double* r, const double* d_in,
                                 double* d_out, int nx, int ny, int nz,
                                 int px, int py, int zlo, int zhi, double ix,
                                 double iy, double iz, double beta,
                                 double beta_lam, int k, int degree,
                                 void* stream) {
  return launch_sweep(rhs, shift, x, r, d_in, d_out, nx, ny, nz, px, py, zlo,
                      zhi, ix, iy, iz, beta, beta_lam, k, degree, stream);
}

XPIC_API int xpic_cheb_sweep_f64_info(int* out) {
  return kernel_info(cheb_sweep_kernel<double>, kThreads, 0, out);
}
