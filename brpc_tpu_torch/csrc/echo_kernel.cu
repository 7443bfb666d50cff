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
// Alignment: the pointers need only be 4-byte aligned; the launch reads
// their 16-byte phases.  Where in and out share a phase (the wrapper
// allocates its copy so), the lanes before in's first 16-byte boundary (at
// most 3) move as scalars, then the uint4 body, then the tail.  Where they
// differ no uint4 load pairs with a uint4 store, and every lane moves as a
// coalesced scalar with 4 x kUnroll loads in flight per thread (the ragged
// path, as K2's in ring_kernel.cu).  brpc_tpu_torch/ops/echo_kernel.py's
// phase_split states the same split in Python.
//
// Interface: a plain C function, loaded with ctypes.  It launches on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (cudaErrorMisalignedAddress, launching nothing, for a
// pointer that is not 4-byte aligned).  The caller zeroes *acc.

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

// The block's sum of every thread's `sum`, added to *acc by one atomic.
template <int Threads>
__device__ __forceinline__ void add_block_sum(unsigned sum, unsigned* acc) {
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

// in and out in one 16-byte phase: `head` scalar lanes, the uint4 body,
// the tail lanes.
template <int Threads, int Unroll>
__global__ void __launch_bounds__(Threads)
    echo_kernel(const unsigned* __restrict__ in, unsigned* __restrict__ out,
                size_t n_lanes, size_t head, unsigned* __restrict__ acc) {
  const uint4* in4 = reinterpret_cast<const uint4*>(in + head);
  uint4* out4 = reinterpret_cast<uint4*>(out + head);
  const size_t n_vec = (n_lanes - head) / 4;
  const size_t stride = static_cast<size_t>(gridDim.x) * Threads;
  const size_t first = static_cast<size_t>(blockIdx.x) * Threads + threadIdx.x;
  unsigned sum = 0;  // wraps mod 2^32 natively
  size_t i = first;
  for (; i + (Unroll - 1) * stride < n_vec; i += Unroll * stride) {
    uint4 v[Unroll];
#pragma unroll
    for (int u = 0; u < Unroll; ++u) {
      v[u] = __ldcs(in4 + i + u * stride);
    }
#pragma unroll
    for (int u = 0; u < Unroll; ++u) {
      __stcs(out4 + i + u * stride, v[u]);
      sum += v[u].x + v[u].y + v[u].z + v[u].w;
    }
  }
  for (; i < n_vec; i += stride) {
    const uint4 v = __ldcs(in4 + i);
    __stcs(out4 + i, v);
    sum += v.x + v.y + v.z + v.w;
  }
  // The head, and the lanes after the last whole uint4.
  if (first < head) {
    const unsigned v = in[first];
    out[first] = v;
    sum += v;
  }
  for (size_t j = head + n_vec * 4 + first; j < n_lanes; j += stride) {
    const unsigned v = in[j];
    out[j] = v;
    sum += v;
  }
  add_block_sum<Threads>(sum, acc);
}

// in and out in different phases: every lane a scalar, neighbouring threads
// on neighbouring lanes, 4 x Unroll loads in flight per thread (the bytes
// in flight of the uint4 body).
template <int Threads, int Unroll>
__global__ void __launch_bounds__(Threads)
    echo_ragged_kernel(const unsigned* __restrict__ in,
                       unsigned* __restrict__ out, size_t n_lanes,
                       unsigned* __restrict__ acc) {
  constexpr int kLanes = 4 * Unroll;
  const size_t stride = static_cast<size_t>(gridDim.x) * Threads;
  const size_t first = static_cast<size_t>(blockIdx.x) * Threads + threadIdx.x;
  unsigned sum = 0;
  size_t i = first;
  for (; i + (kLanes - 1) * stride < n_lanes; i += kLanes * stride) {
    unsigned v[kLanes];
#pragma unroll
    for (int u = 0; u < kLanes; ++u) {
      v[u] = __ldcs(in + i + u * stride);
    }
#pragma unroll
    for (int u = 0; u < kLanes; ++u) {
      __stcs(out + i + u * stride, v[u]);
      sum += v[u];
    }
  }
  for (; i < n_lanes; i += stride) {
    const unsigned v = __ldcs(in + i);
    __stcs(out + i, v);
    sum += v;
  }
  add_block_sum<Threads>(sum, acc);
}

// Both pointers' 16-byte phases pick the kernel; see the header.
template <int Threads, int Unroll>
int launch_geom(const void* in, void* out, void* acc, size_t n_lanes,
                unsigned grid, cudaStream_t stream) {
  const auto a = reinterpret_cast<uintptr_t>(in);
  const auto b = reinterpret_cast<uintptr_t>(out);
  if (a % 4 != 0 || b % 4 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const auto* src = static_cast<const unsigned*>(in);
  auto* dst = static_cast<unsigned*>(out);
  auto* sum = static_cast<unsigned*>(acc);
  if (a % 16 == b % 16) {
    const size_t head = (16 - a % 16) % 16 / 4;
    echo_kernel<Threads, Unroll><<<grid, Threads, 0, stream>>>(
        src, dst, n_lanes, head < n_lanes ? head : n_lanes, sum);
  } else {
    echo_ragged_kernel<Threads, Unroll><<<grid, Threads, 0, stream>>>(
        src, dst, n_lanes, sum);
  }
  return static_cast<int>(cudaGetLastError());
}

// The number of SMs of the current device, or a CUDA error below 0.
int sm_count() {
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return err == cudaSuccess ? sms : -static_cast<int>(err);
}

// Enough blocks of `threads` to give every thread at least one uint4, at
// most blocks_per_sm per SM; the grid-stride loops cover the rest.
unsigned grid_for(size_t n_lanes, size_t threads, int sms, int blocks_per_sm) {
  const size_t want = (n_lanes / 4 + threads - 1) / threads;
  const size_t cap = static_cast<size_t>(sms) * blocks_per_sm;
  return static_cast<unsigned>(want == 0 ? 1 : (want < cap ? want : cap));
}

}  // namespace

extern "C" int brpc_echo_fused(const void* in, void* out, void* acc,
                               size_t n_lanes, void* stream) {
  const int sms = sm_count();
  if (sms < 0) {
    return -sms;
  }
  return launch_geom<kThreads, kUnroll>(
      in, out, acc, n_lanes, grid_for(n_lanes, kThreads, sms, kBlocksPerSm),
      static_cast<cudaStream_t>(stream));
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
  const int sms = sm_count();
  if (sms < 0) {
    return -sms;
  }
  const size_t per_block = threads > 0 ? static_cast<size_t>(threads) : 1;
  const unsigned grid = grid_for(n_lanes, per_block, sms, blocks_per_sm);
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
