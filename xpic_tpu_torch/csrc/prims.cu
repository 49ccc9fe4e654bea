// prims: the primitive-rate probes of the calibration path.  Each probe
// reads x [G, 8, 128] float32 once and writes out [G, 8, 128] once:
//   op 0 copy:     out = x
//   op 1 fma16:    acc = x; 16 times acc = acc * 1.0001 + x
//   op 2 fma64:    the same, 64 times
//   op 3 roll8:    acc = x + sum over s = 1, 2, 4, 8, 16, 32, 64, 1 of
//                  roll(x, s) along the 128 columns, roll(x, s)[k] =
//                  x[(k - s) mod 128], added in that order
//   op 4 select16: m = x[:, 0, :] (row 0 of the same column); for
//                  j = 0..15 in order, acc = m > j ? acc + x : acc
//   op 5 reduce16: for each row and j = 0..15, acc += sum over the 128
//                  columns of x * (j + 1); out = acc on every column
//
// Replaces: benchmarks/profile_pallas_prims.py:27-79, the Pallas kernels
// k_copy, k_fma16, k_fma64, k_roll8, k_select16 and k_reduce16 run by
// `call` over [64, 8, 128] VMEM blocks with pltpu.roll.  The probe
// computes what they compute; it measures which operation classes stay
// hidden under the memory time on Hopper.
//
// Bound on the H100: bytes, for every probe.  268.4 MB move at
// G = 32768 (134.2 MB read, 134.2 MB written): 0.0801 ms at 3.35 TB/s.
// The most arithmetic, fma64's 128 float32 operations an element
// (4.29 GFLOP), takes 0.064 ms at 67 TFLOP/s.  Design: one warp per cell
// [8, 128]; lane l owns columns 4l..4l+3 of every row as one float4, so
// each row moves as one coalesced 512-byte warp access, with read-only
// 16-byte loads; the warp loads its 8 rows before it computes (8 loads in
// flight a lane) and writes each row once.  No shared memory, no
// barrier, no atomics.  Other frames are timed against this one and
// out.copy_(x) by xpic_tpu_torch/benchmarks/prims_frames.py (whose .cu
// holds them), and none matches copy_ in every state of L2.  Streaming
// hints (ld/st.global.cs, evict first) bring the copy level with copy_
// while L2 holds the output buffer's own lines, but after another
// buffer's plain stores (copy_'s, in a timing in turns) the copy is no
// faster and fma64, select16 and reduce16 are slower.  TMA bulk copies
// through shared memory (written for the copy probe only) time the same
// in both states, nearer copy_ than this frame, not level with it.
// Persistent grid-stride warps, two cells a warp, 8 warps a block,
// L2-only (.cg) stores and L1-bypassing loads are no faster.
// Each probe keeps its chain of operations (the four components of a
// lane are four independent chains):
// - fma: nvcc contracts each step into one FMA, which rounds once where
//   the twin rounds twice;
// - roll: a shift that is a multiple of 4 is a __shfl_sync of the float4
//   from lane (l - s/4) & 31; s = 1 and 2 take the last one or two
//   components of the previous lane by shuffle.  Shuffles were chosen
//   over staging the row in shared memory because they need no barrier
//   and no shared-memory round trip; the adds run in the twin's order,
//   so the result is bitwise;
// - select: m stays in a register while the warp walks rows 0-7; bitwise;
// - reduce: a 4-element lane partial, then a 5-step __shfl_xor_sync
//   butterfly, which leaves the same sum on every lane (each level adds
//   the same two values); all 16 reductions of a row are kept.
#include "common.cuh"

namespace {

constexpr int kRows = 8;  // rows of a cell; 128 columns = 32 lanes x 4

enum Probe { kCopy = 0, kFma16, kFma64, kRoll8, kSelect16, kReduce16 };

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 shfl4(float4 v, int src) {
  return make_float4(__shfl_sync(kFullMask, v.x, src),
                     __shfl_sync(kFullMask, v.y, src),
                     __shfl_sync(kFullMask, v.z, src),
                     __shfl_sync(kFullMask, v.w, src));
}

// roll(x, S) along the 128 columns of a row held as one float4 a lane.
template <int S>
__device__ __forceinline__ float4 roll(float4 v, int lane) {
  if constexpr (S % 4 == 0) {
    return shfl4(v, (lane - S / 4) & 31);
  } else if constexpr (S == 1) {
    const int prev = (lane - 1) & 31;
    return make_float4(__shfl_sync(kFullMask, v.w, prev), v.x, v.y, v.z);
  } else {
    static_assert(S == 2, "roll: shifts 1, 2 and multiples of 4");
    const int prev = (lane - 1) & 31;
    return make_float4(__shfl_sync(kFullMask, v.z, prev),
                       __shfl_sync(kFullMask, v.w, prev), v.x, v.y);
  }
}

template <int N>
__device__ __forceinline__ float4 fma_chain(float4 x) {
  float4 acc = x;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    acc.x = acc.x * 1.0001f + x.x;
    acc.y = acc.y * 1.0001f + x.y;
    acc.z = acc.z * 1.0001f + x.z;
    acc.w = acc.w * 1.0001f + x.w;
  }
  return acc;
}

__device__ __forceinline__ float select_chain(float m, float x) {
  float acc = x;
#pragma unroll
  for (int j = 0; j < 16; ++j)
    acc = m > static_cast<float>(j) ? acc + x : acc;
  return acc;
}

__device__ __forceinline__ float4 reduce_chain(float4 v) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float c = static_cast<float>(j + 1);
    float part = v.x * c + v.y * c + v.z * c + v.w * c;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(kFullMask, part, off);
    acc += part;
  }
  return make_float4(acc, acc, acc, acc);
}

template <int OP>
__device__ __forceinline__ float4 probe(float4 v, float4 m, int lane) {
  if constexpr (OP == kCopy) {
    return v;
  } else if constexpr (OP == kFma16) {
    return fma_chain<16>(v);
  } else if constexpr (OP == kFma64) {
    return fma_chain<64>(v);
  } else if constexpr (OP == kRoll8) {
    float4 acc = v;
    acc = add4(acc, roll<1>(v, lane));
    acc = add4(acc, roll<2>(v, lane));
    acc = add4(acc, roll<4>(v, lane));
    acc = add4(acc, roll<8>(v, lane));
    acc = add4(acc, roll<16>(v, lane));
    acc = add4(acc, roll<32>(v, lane));
    acc = add4(acc, roll<64>(v, lane));
    return add4(acc, roll<1>(v, lane));
  } else if constexpr (OP == kSelect16) {
    return make_float4(select_chain(m.x, v.x), select_chain(m.y, v.y),
                       select_chain(m.z, v.z), select_chain(m.w, v.w));
  } else {
    return reduce_chain(v);
  }
}

template <int OP>
__global__ void prims_kernel(const float4* __restrict__ x,
                             float4* __restrict__ out, int G) {
  const int g = warp_id();
  if (g >= G) return;  // uniform across the warp
  const int lane = lane_id();
  const size_t base = static_cast<size_t>(g) * kRows * 32 + lane;
  float4 v[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) v[r] = __ldg(x + base + r * 32);
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    out[base + r * 32] = probe<OP>(v[r], v[0], lane);
}

template <int OP>
void launch(const float* x, float* out, int G, cudaStream_t stream) {
  prims_kernel<OP><<<warp_blocks(G), 32 * kWarpsPerBlock, 0, stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out), G);
}

}  // namespace

// x and out must be 16-byte aligned (the wrapper checks).
XPIC_API int xpic_prims(const float* x, float* out, int G, int op,
                        void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kCopy: launch<kCopy>(x, out, G, s); break;
    case kFma16: launch<kFma16>(x, out, G, s); break;
    case kFma64: launch<kFma64>(x, out, G, s); break;
    case kRoll8: launch<kRoll8>(x, out, G, s); break;
    case kSelect16: launch<kSelect16>(x, out, G, s); break;
    case kReduce16: launch<kReduce16>(x, out, G, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
