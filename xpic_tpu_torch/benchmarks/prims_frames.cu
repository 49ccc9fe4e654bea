// Candidate load/store frames for the prims probes (K8), beside the kept
// frame of csrc/prims.cu, whose probe arithmetic they share.  Built and
// timed only by xpic_tpu_torch/benchmarks/prims_frames.py; the port
// never calls them.  Frames (the index is the first argument of
// xpic_prims_frame):
//   0      kept: prims_kernel, one warp a cell, 4 warps a block, __ldg
//          loads, plain stores
//   1-9    one warp a cell, 4 warps a block, with the load / store hint
//          pairs ld.cs / st.cs, ld.cs / plain, __ldg / st.cs, __ldg / st.cg,
//          ld.cs / st.cg, ld.nc.L1::no_allocate / plain,
//          ld.nc.L1::no_allocate / st.cs, ld.nc with an L2 evict_first
//          policy / plain, and the same / st with that policy
//   10     8 warps a block (__ldg / plain)
//   11, 12 two cells a warp, all 16 loads first (__ldg / plain, ld.cs /
//          st.cs)
//   13, 14 persistent grid-stride warps, as many blocks of 256 as the card
//          holds at once, the next cell's loads issued before this cell's
//          stores (__ldg / plain, ld.cs / st.cs)
//   15, 16 copy only: TMA bulk copies (cp.async.bulk) through shared
//          memory, 4 and 8 cells (16 and 32 KB) a block of one warp: one
//          bulk load completing on an mbarrier, then one bulk store
#include "prims.cu"

namespace {

enum Load { kLdg, kLdcs, kLdNoAlloc, kLdEvictFirst };
enum Store { kStPlain, kStcs, kStcg, kStEvictFirst };

__device__ __forceinline__ unsigned long long evict_first_policy() {
  unsigned long long p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}

template <int L>
__device__ __forceinline__ float4 ld(const float4* p,
                                     unsigned long long pol) {
  float4 v;
  if constexpr (L == kLdg) {
    v = __ldg(p);
  } else if constexpr (L == kLdcs) {
    v = __ldcs(p);
  } else if constexpr (L == kLdNoAlloc) {
    asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0,%1,%2,%3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "l"(p));
  } else {
    asm volatile(
        "ld.global.nc.L2::cache_hint.v4.f32 {%0,%1,%2,%3}, [%4], %5;"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
        : "l"(p), "l"(pol));
  }
  return v;
}

template <int S>
__device__ __forceinline__ void st(float4* p, float4 v,
                                   unsigned long long pol) {
  if constexpr (S == kStPlain) {
    *p = v;
  } else if constexpr (S == kStcs) {
    __stcs(p, v);
  } else if constexpr (S == kStcg) {
    __stcg(p, v);
  } else {
    asm volatile("st.global.L2::cache_hint.v4.f32 [%0], {%1,%2,%3,%4}, %5;"
                 :: "l"(p), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w),
                 "l"(pol)
                 : "memory");
  }
}

template <int L, int S>
__device__ __forceinline__ unsigned long long policy() {
  if constexpr (L == kLdEvictFirst || S == kStEvictFirst)
    return evict_first_policy();
  return 0ull;
}

__device__ __forceinline__ size_t cell_base(int g, int lane) {
  return static_cast<size_t>(g) * kRows * 32 + lane;
}

// CELLS cells a warp, every load before the first store.
template <int OP, int L, int S, int CELLS>
__global__ void frame_kernel(const float4* __restrict__ x,
                             float4* __restrict__ out, int G) {
  const int g0 = CELLS * warp_id();
  if (g0 >= G) return;  // uniform across the warp
  const int lane = lane_id();
  const unsigned long long pol = policy<L, S>();
  float4 v[CELLS][kRows];
#pragma unroll
  for (int c = 0; c < CELLS; ++c)
    if (g0 + c < G)
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        v[c][r] = ld<L>(x + cell_base(g0 + c, lane) + r * 32, pol);
#pragma unroll
  for (int c = 0; c < CELLS; ++c)
    if (g0 + c < G)
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        st<S>(out + cell_base(g0 + c, lane) + r * 32,
              probe<OP>(v[c][r], v[c][0], lane), pol);
}

// Persistent warps striding over the cells; the next cell's loads go out
// before this cell's stores.
template <int OP, int L, int S>
__global__ void persist_kernel(const float4* __restrict__ x,
                               float4* __restrict__ out, int G) {
  const int warps = (gridDim.x * blockDim.x) >> 5;
  int g = warp_id();
  if (g >= G) return;
  const int lane = lane_id();
  const unsigned long long pol = policy<L, S>();
  float4 v[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    v[r] = ld<L>(x + cell_base(g, lane) + r * 32, pol);
  while (true) {
    const int next = g + warps;
    float4 w[kRows];
    if (next < G) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        w[r] = ld<L>(x + cell_base(next, lane) + r * 32, pol);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      st<S>(out + cell_base(g, lane) + r * 32, probe<OP>(v[r], v[0], lane),
            pol);
    if (next >= G) break;
#pragma unroll
    for (int r = 0; r < kRows; ++r) v[r] = w[r];
    g = next;
  }
}

// TILE cells through shared memory: lane 0 issues one bulk load that
// completes on an mbarrier, waits on it, issues one bulk store and waits
// until the store has read shared memory.
template <int TILE>
__global__ void tma_copy_kernel(const float4* __restrict__ x,
                                float4* __restrict__ out, int G) {
  constexpr unsigned kBytes = TILE * kRows * 32 * sizeof(float4);
  __shared__ alignas(128) float4 buf[TILE * kRows * 32];
  __shared__ alignas(8) unsigned long long bar;
  const int g0 = blockIdx.x * TILE;
  if (threadIdx.x != 0 || g0 >= G) return;
  const unsigned s_buf =
      static_cast<unsigned>(__cvta_generic_to_shared(buf));
  const unsigned s_bar =
      static_cast<unsigned>(__cvta_generic_to_shared(&bar));
  const size_t base = static_cast<size_t>(g0) * kRows * 32;
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(s_bar));
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(s_bar),
      "r"(kBytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(s_buf),
      "l"(x + base), "r"(kBytes), "r"(s_bar)
      : "memory");
  // A bounded wait: a load that never completes traps instead of
  // spinning for ever.
  unsigned done = 0;
  for (int i = 0; !done && i < (1 << 22); ++i)
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(s_bar)
        : "memory");
  if (!done) __trap();
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(out + base), "r"(s_buf), "r"(kBytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

template <typename K>
int resident_blocks(K kernel, int threads, int* blocks) {
  int dev = 0, per_sm = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, 0);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *blocks = per_sm * sms;
  return static_cast<int>(err);
}

template <int OP, int L, int S>
void hinted(const float4* x, float4* out, int G, cudaStream_t s) {
  frame_kernel<OP, L, S, 1><<<warp_blocks(G), 32 * kWarpsPerBlock, 0, s>>>(
      x, out, G);
}

template <int OP, int L, int S>
int persistent(const float4* x, float4* out, int G, cudaStream_t s) {
  int blocks = 0;
  const int err = resident_blocks(persist_kernel<OP, L, S>, 256, &blocks);
  if (err != 0) return err;
  persist_kernel<OP, L, S><<<blocks, 256, 0, s>>>(x, out, G);
  return 0;
}

template <int OP>
int launch_frame(int frame, const float4* x, float4* out, int G,
                 cudaStream_t s) {
  const int threads = 32 * kWarpsPerBlock;
  switch (frame) {
    case 0: prims_kernel<OP><<<warp_blocks(G), threads, 0, s>>>(x, out, G);
      break;
    case 1: hinted<OP, kLdcs, kStcs>(x, out, G, s); break;
    case 2: hinted<OP, kLdcs, kStPlain>(x, out, G, s); break;
    case 3: hinted<OP, kLdg, kStcs>(x, out, G, s); break;
    case 4: hinted<OP, kLdg, kStcg>(x, out, G, s); break;
    case 5: hinted<OP, kLdcs, kStcg>(x, out, G, s); break;
    case 6: hinted<OP, kLdNoAlloc, kStPlain>(x, out, G, s); break;
    case 7: hinted<OP, kLdNoAlloc, kStcs>(x, out, G, s); break;
    case 8: hinted<OP, kLdEvictFirst, kStPlain>(x, out, G, s); break;
    case 9: hinted<OP, kLdEvictFirst, kStEvictFirst>(x, out, G, s); break;
    case 10:
      frame_kernel<OP, kLdg, kStPlain, 1><<<(G + 7) / 8, 256, 0, s>>>(
          x, out, G);
      break;
    case 11:
      frame_kernel<OP, kLdg, kStPlain, 2>
          <<<warp_blocks((G + 1) / 2), threads, 0, s>>>(x, out, G);
      break;
    case 12:
      frame_kernel<OP, kLdcs, kStcs, 2>
          <<<warp_blocks((G + 1) / 2), threads, 0, s>>>(x, out, G);
      break;
    case 13: {
      const int err = persistent<OP, kLdg, kStPlain>(x, out, G, s);
      if (err != 0) return err;
      break;
    }
    case 14: {
      const int err = persistent<OP, kLdcs, kStcs>(x, out, G, s);
      if (err != 0) return err;
      break;
    }
    case 15:
    case 16:
      if (OP != kCopy) return static_cast<int>(cudaErrorNotSupported);
      if (frame == 15) {
        if (G % 4) return static_cast<int>(cudaErrorInvalidValue);
        tma_copy_kernel<4><<<G / 4, 32, 0, s>>>(x, out, G);
      } else {
        if (G % 8) return static_cast<int>(cudaErrorInvalidValue);
        tma_copy_kernel<8><<<G / 8, 32, 0, s>>>(x, out, G);
      }
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Frame `frame` of probe `op` (0 copy .. 5 reduce16) on x, out
// [G, 8, 128] float32, 16-byte aligned.
XPIC_API int xpic_prims_frame(int frame, int op, const float* x, float* out,
                              int G, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto xi = reinterpret_cast<const float4*>(x);
  const auto xo = reinterpret_cast<float4*>(out);
  switch (op) {
    case kCopy: return launch_frame<kCopy>(frame, xi, xo, G, s);
    case kFma16: return launch_frame<kFma16>(frame, xi, xo, G, s);
    case kFma64: return launch_frame<kFma64>(frame, xi, xo, G, s);
    case kRoll8: return launch_frame<kRoll8>(frame, xi, xo, G, s);
    case kSelect16: return launch_frame<kSelect16>(frame, xi, xo, G, s);
    case kReduce16: return launch_frame<kReduce16>(frame, xi, xo, G, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
