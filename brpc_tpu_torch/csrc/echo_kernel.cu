// K1: the fused echo pass for Hopper (sm_90a) — copy a uint32 payload and
// take its wrapping 32-bit sum in the same read.
//
// Replaces brpc_tpu/ops/echo_kernel.py::_kernel (the Pallas echo kernel that
// brpc_tpu.ops.echo_kernel.echo_fused launches).  It computes what that
// kernel computes: out[i] = in[i] for every lane, and *acc += sum(in) mod
// 2^32.  It is not carried over block by block: the TPU grid runs in order
// and carries the sum in one SMEM scalar; here the blocks run in parallel
// with nothing carried between them, so each block reduces its share and
// adds it to *acc with one atomicAdd.  Addition mod 2^32 is associative and
// commutative, so the checksum is bit-exact and the same on every run.
//
// Bound: device-memory bytes, 2 x payload (each lane read once, written
// once); the n integer adds are ~1% of that time.  At 64 MiB that is
// 134.2 MB, 40 us at the H100 SXM's published 3.35 TB/s (67 us on a PCIe
// card at 2.0 TB/s).  Design against that bound: 16-byte loads and stores
// (uint4), neighbouring threads on neighbouring addresses, kUnroll
// independent loads in flight per thread before any store, streaming cache
// hints (the payload is touched once), a grid of kBlocksPerSm full blocks
// per SM, a warp-shuffle then shared-memory reduction, one atomic per block.
//
// Interface: a plain C function, loaded with ctypes.  It launches on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().  The caller zeroes *acc and passes 16-byte-aligned
// pointers.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
    echo_fused_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                      const unsigned* __restrict__ in_lanes,
                      unsigned* __restrict__ out_lanes, size_t n_lanes,
                      unsigned* __restrict__ acc) {
  const size_t n_vec = n_lanes / 4;
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  const size_t first = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  unsigned sum = 0;  // wraps mod 2^32 natively
  size_t i = first;
  for (; i + (kUnroll - 1) * stride < n_vec; i += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      v[u] = __ldcs(in + i + u * stride);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      __stcs(out + i + u * stride, v[u]);
      sum += v[u].x + v[u].y + v[u].z + v[u].w;
    }
  }
  for (; i < n_vec; i += stride) {
    const uint4 v = __ldcs(in + i);
    __stcs(out + i, v);
    sum += v.x + v.y + v.z + v.w;
  }
  // Lanes after the last whole uint4 (only when n_lanes % 4 != 0).
  for (size_t j = n_vec * 4 + first; j < n_lanes; j += stride) {
    const unsigned v = in_lanes[j];
    out_lanes[j] = v;
    sum += v;
  }

  __shared__ unsigned warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  sum = warp_sum(sum);
  if (lane == 0) {
    warp_sums[warp] = sum;
  }
  __syncthreads();
  if (warp == 0) {
    sum = lane < kThreads / 32 ? warp_sums[lane] : 0u;
    sum = warp_sum(sum);
    if (lane == 0) {
      atomicAdd(acc, sum);
    }
  }
}

}  // namespace

extern "C" int brpc_echo_fused(const void* in, void* out, void* acc,
                               size_t n_lanes, void* stream) {
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  // Enough blocks to give every thread at least one uint4, at most
  // kBlocksPerSm per SM; the grid-stride loop covers the rest.
  const size_t want = (n_lanes / 4 + kThreads - 1) / kThreads;
  const size_t cap = static_cast<size_t>(sms) * kBlocksPerSm;
  const unsigned grid =
      static_cast<unsigned>(want == 0 ? 1 : (want < cap ? want : cap));
  echo_fused_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(in), static_cast<uint4*>(out),
      static_cast<const unsigned*>(in), static_cast<unsigned*>(out), n_lanes,
      static_cast<unsigned*>(acc));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The geometry entry: the same pass at a launch geometry the caller picks,
// for the launch-geometry sweep (brpc_tpu_torch/tools/tune_echo.py).  It
// leaves brpc_echo_fused above, and its geometry, as they are.  Threads per
// block and loads in flight per thread are compiled in (kGeomThreads x
// kGeomUnrolls); the grid is blocks_per_sm full blocks per SM, capped, as
// brpc_echo_fused caps its own, at enough blocks to give every thread one
// uint4.  Same contract: the caller's stream, no synchronisation, no
// allocation, *acc zeroed by the caller, cudaGetLastError() returned; an
// unsupported geometry returns cudaErrorInvalidValue and launches nothing.

namespace {

template <int Threads, int Unroll>
__global__ void __launch_bounds__(Threads)
    echo_geom_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                     const unsigned* __restrict__ in_lanes,
                     unsigned* __restrict__ out_lanes, size_t n_lanes,
                     unsigned* __restrict__ acc) {
  const size_t n_vec = n_lanes / 4;
  const size_t stride = static_cast<size_t>(gridDim.x) * Threads;
  const size_t first = static_cast<size_t>(blockIdx.x) * Threads + threadIdx.x;
  unsigned sum = 0;
  size_t i = first;
  for (; i + (Unroll - 1) * stride < n_vec; i += Unroll * stride) {
    uint4 v[Unroll];
#pragma unroll
    for (int u = 0; u < Unroll; ++u) {
      v[u] = __ldcs(in + i + u * stride);
    }
#pragma unroll
    for (int u = 0; u < Unroll; ++u) {
      __stcs(out + i + u * stride, v[u]);
      sum += v[u].x + v[u].y + v[u].z + v[u].w;
    }
  }
  for (; i < n_vec; i += stride) {
    const uint4 v = __ldcs(in + i);
    __stcs(out + i, v);
    sum += v.x + v.y + v.z + v.w;
  }
  for (size_t j = n_vec * 4 + first; j < n_lanes; j += stride) {
    const unsigned v = in_lanes[j];
    out_lanes[j] = v;
    sum += v;
  }

  __shared__ unsigned warp_sums[Threads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  sum = warp_sum(sum);
  if (lane == 0) {
    warp_sums[warp] = sum;
  }
  __syncthreads();
  if (warp == 0) {
    sum = lane < Threads / 32 ? warp_sums[lane] : 0u;
    sum = warp_sum(sum);
    if (lane == 0) {
      atomicAdd(acc, sum);
    }
  }
}

template <int Threads, int Unroll>
int launch_geom(const void* in, void* out, void* acc, size_t n_lanes,
                unsigned grid, cudaStream_t stream) {
  echo_geom_kernel<Threads, Unroll><<<grid, Threads, 0, stream>>>(
      static_cast<const uint4*>(in), static_cast<uint4*>(out),
      static_cast<const unsigned*>(in), static_cast<unsigned*>(out), n_lanes,
      static_cast<unsigned*>(acc));
  return static_cast<int>(cudaGetLastError());
}

template <int Threads>
int launch_unroll(int unroll, const void* in, void* out, void* acc,
                  size_t n_lanes, unsigned grid, cudaStream_t stream) {
  switch (unroll) {
    case 2: return launch_geom<Threads, 2>(in, out, acc, n_lanes, grid, stream);
    case 4: return launch_geom<Threads, 4>(in, out, acc, n_lanes, grid, stream);
    case 8: return launch_geom<Threads, 8>(in, out, acc, n_lanes, grid, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Threads per block in {128, 256, 512, 1024}, loads in flight per thread
// in {2, 4, 8}, blocks_per_sm >= 1.
extern "C" int brpc_echo_fused_geom(const void* in, void* out, void* acc,
                                    size_t n_lanes, int threads, int unroll,
                                    int blocks_per_sm, void* stream) {
  if (blocks_per_sm < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const size_t per_block = threads > 0 ? static_cast<size_t>(threads) : 1;
  const size_t want = (n_lanes / 4 + per_block - 1) / per_block;
  const size_t cap = static_cast<size_t>(sms) * blocks_per_sm;
  const unsigned grid =
      static_cast<unsigned>(want == 0 ? 1 : (want < cap ? want : cap));
  const auto s = static_cast<cudaStream_t>(stream);
  switch (threads) {
    case 128: return launch_unroll<128>(unroll, in, out, acc, n_lanes, grid, s);
    case 256: return launch_unroll<256>(unroll, in, out, acc, n_lanes, grid, s);
    case 512: return launch_unroll<512>(unroll, in, out, acc, n_lanes, grid, s);
    case 1024:
      return launch_unroll<1024>(unroll, in, out, acc, n_lanes, grid, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
