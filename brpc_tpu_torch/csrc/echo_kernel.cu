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
//
// The batched landing (brpc_echo_land_batch, at the end of this file): the
// same pass over up to kLandMaxCalls responses of one size that landed in
// device-mapped host memory (pinned, or registered with cudaHostRegister),
// read in place.  One launch on the caller's stream copies call c's lanes
// into row c of one device output and writes its wrapping sum to sums[c].
// It stands in, for each call, for an H2D copy, the zero fill of *acc and
// a K1 launch: at 1 KiB those cost the host far more than the bytes cost
// the link.  Bound: the PCIe link (~50 GB/s one way on an H100 SXM host),
// not HBM; design against it: a grid of (blocks per call, calls) so every
// call's loads are in flight at once, uint4 loads that neighbouring
// threads issue on neighbouring addresses, kUnroll of them in flight per
// thread, and loads that bypass the caches (ld.global.cv), since the host
// rewrites a landing buffer between launches.  Where one block covers a
// call (up to kThreads x kUnroll uint4, 16 KiB) it stores the call's sum
// plainly and needs no zero fill; where several do, the C call zeroes the
// k sums with one cudaMemsetAsync and the blocks add theirs atomically.
// The k landing addresses travel by value in the kernel's parameters: no
// device allocation, no copy of a pointer table.  Every landing address
// and the output need 16-byte alignment and the lanes a multiple of 4, or
// the entry launches nothing and returns cudaErrorMisalignedAddress.
// brpc_echo_mapped_ptr tells the caller, once per landing buffer, whether
// and where the current device reads it.

#include <cuda_runtime.h>

#include <atomic>
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

// The block's sum of every thread's `sum`, valid in thread 0.
template <int Threads>
__device__ __forceinline__ unsigned block_sum(unsigned sum) {
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
  }
  return sum;
}

// The block's sum of every thread's `sum`, added to *acc by one atomic.
template <int Threads>
__device__ __forceinline__ void add_block_sum(unsigned sum, unsigned* acc) {
  sum = block_sum<Threads>(sum);
  if (threadIdx.x == 0) {
    atomicAdd(acc, sum);
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

// ---------------------------------------------------------------------------
// The batched landing; see the header.

namespace {

constexpr int kLandMaxCalls = 64;
constexpr int kMaxDevices = 64;

// The landing addresses of one launch, in the kernel's parameters.
struct LandCalls {
  const uint4* src[kLandMaxCalls];
};

// Call blockIdx.y: its n_vec uint4 from host memory into its row of out,
// its wrapping sum into sums[blockIdx.y] (stored by a lone block, added
// by each of several).
template <int Threads, int Unroll>
__global__ void __launch_bounds__(Threads)
    echo_land_kernel(const __grid_constant__ LandCalls calls,
                     uint4* __restrict__ out, size_t n_vec,
                     unsigned* __restrict__ sums) {
  const unsigned call = blockIdx.y;
  const uint4* in = calls.src[call];
  uint4* dst = out + call * n_vec;
  const size_t stride = static_cast<size_t>(gridDim.x) * Threads;
  size_t i = static_cast<size_t>(blockIdx.x) * Threads + threadIdx.x;
  unsigned sum = 0;
  for (; i + (Unroll - 1) * stride < n_vec; i += Unroll * stride) {
    uint4 v[Unroll];
#pragma unroll
    for (int u = 0; u < Unroll; ++u) {
      v[u] = __ldcv(in + i + u * stride);
    }
#pragma unroll
    for (int u = 0; u < Unroll; ++u) {
      __stcs(dst + i + u * stride, v[u]);
      sum += v[u].x + v[u].y + v[u].z + v[u].w;
    }
  }
  for (; i < n_vec; i += stride) {
    const uint4 v = __ldcv(in + i);
    __stcs(dst + i, v);
    sum += v.x + v.y + v.z + v.w;
  }
  sum = block_sum<Threads>(sum);
  if (threadIdx.x == 0) {
    if (gridDim.x == 1) {
      sums[call] = sum;
    } else {
      atomicAdd(sums + call, sum);
    }
  }
}

// The number of SMs of the current device, asked of CUDA once per
// device; a CUDA error below 0.
int cached_sm_count() {
  static std::atomic<int> cached[kMaxDevices];
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) {
    return -static_cast<int>(err);
  }
  if (dev < 0 || dev >= kMaxDevices) {
    return sm_count();
  }
  // relaxed: every thread that races here stores the same count.
  int sms = cached[dev].load(std::memory_order_relaxed);
  if (sms <= 0) {
    sms = sm_count();
    if (sms > 0) {
      cached[dev].store(sms, std::memory_order_relaxed);
    }
  }
  return sms;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// k (1 to kLandMaxCalls) calls of n_lanes uint32 lanes each, landed at the
// device-readable addresses srcs[0..k), into out (k rows of n_lanes) and
// sums (k uint32) on the current device, on `stream`.
extern "C" int brpc_echo_land_batch(const void* const* srcs, int k,
                                    void* out, void* sums, size_t n_lanes,
                                    void* stream) {
  if (k < 1 || k > kLandMaxCalls || n_lanes == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!aligned16(out) || n_lanes % 4 != 0 ||
      reinterpret_cast<uintptr_t>(sums) % 4 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  LandCalls calls{};
  for (int c = 0; c < k; ++c) {
    if (!aligned16(srcs[c])) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
    calls.src[c] = static_cast<const uint4*>(srcs[c]);
  }
  const int sms = cached_sm_count();
  if (sms < 0) {
    return -sms;
  }
  const size_t n_vec = n_lanes / 4;
  const size_t per_block = static_cast<size_t>(kThreads) * kUnroll;
  const size_t want = (n_vec + per_block - 1) / per_block;
  const size_t fill = static_cast<size_t>(sms) * kBlocksPerSm / k;
  const size_t cap = fill > 0 ? fill : 1;
  const unsigned blocks = static_cast<unsigned>(want < cap ? want : cap);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* sum = static_cast<unsigned*>(sums);
  if (blocks > 1) {
    const cudaError_t err =
        cudaMemsetAsync(sum, 0, static_cast<size_t>(k) * sizeof(unsigned), s);
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  echo_land_kernel<kThreads, kUnroll>
      <<<dim3(blocks, static_cast<unsigned>(k)), kThreads, 0, s>>>(
          calls, static_cast<uint4*>(out), n_vec, sum);
  return static_cast<int>(cudaGetLastError());
}

// Where the current device reads the host memory at `host`: *dev gets the
// address, or null where the memory is not device-mapped (pageable).
extern "C" int brpc_echo_mapped_ptr(const void* host, void** dev) {
  cudaPointerAttributes attr{};
  const cudaError_t err = cudaPointerGetAttributes(&attr, host);
  if (err == cudaErrorInvalidValue) {  // memory CUDA does not know
    cudaGetLastError();
    *dev = nullptr;
    return 0;
  }
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  *dev = attr.type == cudaMemoryTypeHost ? attr.devicePointer : nullptr;
  return 0;
}
