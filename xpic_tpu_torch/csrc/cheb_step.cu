// cheb_step: one iteration of the degree-k Chebyshev semi-iteration
//   x ~ ((2 + shift) I + beta curl- curl+)^{-1} rhs
// on a Yee field [3, nz, ny, nx] float32.
//
// Replaces: xpic_tpu/ops/pallas_stencil.py:_cheb_kernel (entry
// cheb_matM_inv_pallas), which runs the whole recurrence in one dispatch
// with the field resident in TPU VMEM.
//
// Bound on the H100: memory.  Per element and iteration the kernel reads
// d (13 stencil taps, mostly cache hits), x and r, and writes x, r and
// the next d: about 6 x 4 bytes of DRAM-or-L2 traffic and ~40 FLOPs.
// The 32^3 field is 393 KB, more than one block's 227 KB of shared
// memory, so the TPU's single fused dispatch cannot be copied; instead
// the preconditioner issues one launch per iteration with a ping-pong d
// buffer, and the whole working set (x, r, two d buffers, rhs: ~2 MB)
// stays in the 50 MB L2 between launches.
//
// Design: one thread per (component, cell).  It evaluates
// (curl- curl+ d)[c, i] straight from d through the 2-hop stencil
// (periodic wrap or zero fill per axis, as ops/stencil.shift), then
//   x += d;  r -= a d + beta cc;  d_out = cd d + cr r.
// The shift is a device scalar: every thread replays the <= degree
// scalar steps of the rho recurrence from it, so the apply needs no
// host synchronisation.  The arithmetic follows the TPU kernel's
// expression order; nvcc may contract a multiply and an add into an
// FMA, which rounds once instead of twice (agreement with the plain
// twin is checked to 1e-5 relative).
#include "common.cuh"

namespace {

struct Grid {
  int nx, ny, nz;
  int px, py, pz;  // 1 = periodic axis
  float ix, iy, iz;  // inverse cell steps
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

struct Field {
  const float* d;    // current direction (unused when first)
  const float* rhs;  // first iteration: d = rhs / theta
  float inv_theta;
  bool first;

  __device__ __forceinline__ float at(const Grid& g, int c, int z, int y,
                                      int x) const {
    if (!wrap(x, g.nx, g.px) || !wrap(y, g.ny, g.py) ||
        !wrap(z, g.nz, g.pz))
      return 0.0f;
    const int idx = ((c * g.nz + z) * g.ny + y) * g.nx + x;
    return first ? rhs[idx] * inv_theta : d[idx];
  }
};

// Component c of curl+ d at (z, y, x); zero outside a zero-filled axis.
__device__ float curlp_at(const Field& F, const Grid& g, int c, int z,
                          int y, int x) {
  if (!wrap(x, g.nx, g.px) || !wrap(y, g.ny, g.py) || !wrap(z, g.nz, g.pz))
    return 0.0f;
  if (c == 0) {
    const float fz = F.at(g, 2, z, y, x), fy = F.at(g, 1, z, y, x);
    return (F.at(g, 2, z, y + 1, x) - fz) * g.iy -
           (F.at(g, 1, z + 1, y, x) - fy) * g.iz;
  }
  if (c == 1) {
    const float fx = F.at(g, 0, z, y, x), fz = F.at(g, 2, z, y, x);
    return (F.at(g, 0, z + 1, y, x) - fx) * g.iz -
           (F.at(g, 2, z, y, x + 1) - fz) * g.ix;
  }
  const float fy = F.at(g, 1, z, y, x), fx = F.at(g, 0, z, y, x);
  return (F.at(g, 1, z, y, x + 1) - fy) * g.ix -
         (F.at(g, 0, z, y + 1, x) - fx) * g.iy;
}

// Component c of curl- curl+ d at the in-range cell (z, y, x).
__device__ float curlcurl_at(const Field& F, const Grid& g, int c, int z,
                             int y, int x) {
  if (c == 0) {
    const float gz = curlp_at(F, g, 2, z, y, x);
    const float gy = curlp_at(F, g, 1, z, y, x);
    return (gz - curlp_at(F, g, 2, z, y - 1, x)) * g.iy -
           (gy - curlp_at(F, g, 1, z - 1, y, x)) * g.iz;
  }
  if (c == 1) {
    const float gx = curlp_at(F, g, 0, z, y, x);
    const float gz = curlp_at(F, g, 2, z, y, x);
    return (gx - curlp_at(F, g, 0, z - 1, y, x)) * g.iz -
           (gz - curlp_at(F, g, 2, z, y, x - 1)) * g.ix;
  }
  const float gy = curlp_at(F, g, 1, z, y, x);
  const float gx = curlp_at(F, g, 0, z, y, x);
  return (gy - curlp_at(F, g, 1, z, y, x - 1)) * g.ix -
         (gx - curlp_at(F, g, 0, z, y - 1, x)) * g.iy;
}

__global__ void cheb_step_kernel(const float* __restrict__ rhs,
                                 const float* __restrict__ shift,
                                 float* __restrict__ x,
                                 float* __restrict__ r,
                                 const float* __restrict__ d_in,
                                 float* __restrict__ d_out, Grid g,
                                 float beta, float beta_lam, int k) {
  const int n = g.nx * g.ny * g.nz;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= 3 * n) return;
  const int c = tid / n;
  const int cell = tid - c * n;
  const int xq = cell % g.nx;
  const int yq = (cell / g.nx) % g.ny;
  const int zq = cell / (g.nx * g.ny);

  // Scalar recurrence, replayed from the device shift.
  const float a = 2.0f + shift[0];
  const float b = a + beta_lam;
  const float theta = 0.5f * (b + a);
  const float delta = 0.5f * (b - a);
  const float sigma1 = theta / delta;
  const float inv_theta = 1.0f / theta;
  float rho = 1.0f / sigma1;
  for (int i = 0; i < k; ++i) rho = 1.0f / (2.0f * sigma1 - rho);
  const float rho_new = 1.0f / (2.0f * sigma1 - rho);
  const float cd = rho_new * rho;
  const float cr = 2.0f * rho_new / delta;

  const bool first = (k == 0);
  const Field F{d_in, rhs, inv_theta, first};
  const float dv = first ? rhs[tid] * inv_theta : d_in[tid];
  const float xv = (first ? 0.0f : x[tid]) + dv;
  const float cc = curlcurl_at(F, g, c, zq, yq, xq);
  const float rv = (first ? rhs[tid] : r[tid]) - (a * dv + beta * cc);
  x[tid] = xv;
  r[tid] = rv;
  d_out[tid] = cd * dv + cr * rv;
}

}  // namespace

XPIC_API int xpic_cheb_step(const float* rhs, const float* shift, float* x,
                            float* r, const float* d_in, float* d_out,
                            int nx, int ny, int nz, int px, int py, int pz,
                            float ix, float iy, float iz, float beta,
                            float beta_lam, int k, void* stream) {
  const Grid g{nx, ny, nz, px, py, pz, ix, iy, iz};
  const int n = 3 * nx * ny * nz;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  cheb_step_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      rhs, shift, x, r, d_in, d_out, g, beta, beta_lam, k);
  return static_cast<int>(cudaGetLastError());
}
