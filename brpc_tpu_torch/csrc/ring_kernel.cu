// K2: the all-gather of one chunk per peer, for Hopper (sm_90a), over
// peers that share a card or sit on cards of one host.
//
// Replaces brpc_tpu/ops/ring_kernel.py::_ring_kernel (:37, the Pallas
// kernel that ring_all_gather_pallas launches).  It computes that kernel's
// function, not its schedule:
//
//   out[r][j*C : (j+1)*C] = local[j]   for every peer r and source j.
//
// The TPU kernel forwards each chunk around a ring of chips, one ICI hop at
// a time, because a chip reaches only its neighbours.  On Hopper every
// peer's buffer is in the card's own HBM or, over NVLink, in a card the
// launch reaches all to all (peer access enabled), so a ring that emulates
// ICI hops buys nothing: it moves each chunk through comm buffers n times
// over and makes every hop wait for the one before.  Here each source byte
// is read once and each output byte written once, and no CTA waits on
// another.  One launch serves the sources of one device (all n on one
// card) and writes them to all n outputs, wherever those lie; the wrapper
// (ops/ring_kernel.py) makes one launch per device that holds sources,
// each on a stream of that device, and fences the peers' streams around
// them with events.
//
// Bound on one card: device-memory bytes, (n + n^2) * C (read n chunks,
// write n replicated outputs): at n = 8 and C = 8 MiB that is 576 MiB,
// 0.180 ms at the H100 SXM's published 3.35 TB/s.  Across cards, per card:
// the larger of its HBM bytes ((1 + n) * C) at 3.35 TB/s and its NVLink
// egress ((n - 1) * C) at 450 GB/s a direction (0.130 ms at n = 8).  The
// function does no arithmetic.
//
// Bulk path (C and every pointer 16-byte aligned): a persistent grid, one
// CTA per SM, walks work units (source slot k, tile t) with a grid stride.
// One thread drives everything with Hopper's bulk copy engine (TMA, 1-D
// form, raw pointers, no tensor map): a bulk load of the tile into a stage
// of a ring in shared memory completes on that stage's mbarrier; then n
// bulk stores of the stage, one to each peer's output, form one bulk
// group.  kStages - 1 loads stay in flight while a tile's stores drain, and
// a stage is reloaded only after the stores that read it have read it
// (wait_group.read).  The stores carry an L2 evict-first hint: the outputs
// (n^2 * C) stream through the 50 MB L2 and are not read again here.
//
// The bulk stores reach another card's output through its NVLink mapping
// (peer access enabled); four H100s of one host gathered bit-exact that
// way, no slower at 8 MiB chunks than thread stores.
//
// Ragged path (C or a pointer not 16-byte aligned, as a narrow view of an
// odd-sized chunk is): the CTA's threads copy at the widest width w in
// {8, 4, 2, 1} that divides C and every address; each element is read
// once and stored n times.  The wrapper's plan (plan_gather,
// plan_launches) chooses the path, the tile and the grid.
//
// Interface: plain C functions, loaded with ctypes.  brpc_ring_all_gather
// launches on the stream it is given (of the current device), does not
// synchronise, allocates nothing, and returns the launch's cudaError_t.
// brpc_ring_enable_peers enables peer access between the cards a gather
// spans.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxPeers = 64;
constexpr int kStages = 4;                 // bulk path: tiles in flight
constexpr unsigned kMaxTile = 32 * 1024;   // bulk path: bytes per stage
constexpr int kBulkThreads = 32;           // one warp; lane 0 drives
constexpr int kRaggedThreads = 256;
constexpr size_t kBulkSmem = static_cast<size_t>(kStages) * kMaxTile;

struct GatherArgs {
  const unsigned char* local[kMaxPeers];  // this launch's m sources
  int slot[kMaxPeers];                    // source k is chunk slot[k]
  unsigned char* out[kMaxPeers];          // every peer's output
  unsigned long long chunk_bytes;  // C
  unsigned long long tile_bytes;   // T: C is cut into ceil(C / T) tiles
  unsigned long long units;        // m * tiles; u = (u / tiles, u % tiles)
  int n;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        " .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Bulk load of `bytes` from global memory into shared memory; completion
// is counted on the mbarrier at `bar`, which expects exactly these bytes.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Bulk store of `bytes` from shared memory to global memory, in the open
// bulk group, with an L2 cache policy.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint "
      "[%0], [%1], %2, %3;" ::"l"(dst),
      "r"(src), "r"(bytes), "l"(policy)
      : "memory");
}

__global__ void __launch_bounds__(kBulkThreads)
    bulk_gather(const __grid_constant__ GatherArgs a) {
  extern __shared__ __align__(128) unsigned char stage[];
  __shared__ __align__(8) uint64_t full[kStages];
  const unsigned long long first = blockIdx.x;
  const unsigned long long stride = gridDim.x;
  if (threadIdx.x != 0 || first >= a.units) {
    return;
  }
  const unsigned long long C = a.chunk_bytes;
  const unsigned long long T = a.tile_bytes;
  const unsigned long long tiles = (C + T - 1) / T;
  const unsigned long long count = (a.units - first + stride - 1) / stride;
  const uint32_t stage0 = smem_addr(stage);
  const uint32_t full0 = smem_addr(full);
  for (int s = 0; s < kStages; ++s) {
    mbar_init(full0 + 8 * s);
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  uint64_t evict_first;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(evict_first));

  // Unit k of this CTA: source slot j, byte offset `off` into the chunk,
  // bytes.
  auto unit = [&](unsigned long long k, int* j, unsigned long long* off,
                  uint32_t* bytes) {
    const unsigned long long u = first + k * stride;
    *j = static_cast<int>(u / tiles);
    *off = (u % tiles) * T;
    *bytes = static_cast<uint32_t>(C - *off < T ? C - *off : T);
  };
  auto load = [&](unsigned long long k) {
    int j;
    unsigned long long off;
    uint32_t bytes;
    unit(k, &j, &off, &bytes);
    const int s = static_cast<int>(k % kStages);
    bulk_load(stage0 + s * kMaxTile, a.local[j] + off, bytes, full0 + 8 * s);
  };

  for (unsigned long long k = 0; k < count && k < kStages; ++k) {
    load(k);
  }
  for (unsigned long long k = 0; k < count; ++k) {
    const int s = static_cast<int>(k % kStages);
    mbar_wait(full0 + 8 * s, static_cast<uint32_t>((k / kStages) & 1));
    int j;
    unsigned long long off;
    uint32_t bytes;
    unit(k, &j, &off, &bytes);
    const unsigned long long dst = a.slot[j] * C + off;
    for (int r = 0; r < a.n; ++r) {
      bulk_store(a.out[r] + dst, stage0 + s * kMaxTile, bytes, evict_first);
    }
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    // Refill the stage of unit k - 1 once its stores have read it; unit
    // k's stores stay in flight meanwhile.
    if (k >= 1 && k - 1 + kStages < count) {
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      load(k - 1 + kStages);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

template <typename V>
__global__ void __launch_bounds__(kRaggedThreads)
    ragged_gather(const __grid_constant__ GatherArgs a) {
  const unsigned long long C = a.chunk_bytes;
  const unsigned long long T = a.tile_bytes;
  const unsigned long long tiles = (C + T - 1) / T;
  for (unsigned long long u = blockIdx.x; u < a.units; u += gridDim.x) {
    const int j = static_cast<int>(u / tiles);
    const unsigned long long off = (u % tiles) * T;
    const unsigned long long len = (C - off < T ? C - off : T) / sizeof(V);
    const V* src = reinterpret_cast<const V*>(a.local[j] + off);
    const unsigned long long dst = a.slot[j] * C + off;
    for (unsigned long long i = threadIdx.x; i < len; i += kRaggedThreads) {
      const V v = __ldcs(src + i);
      for (int r = 0; r < a.n; ++r) {
        __stcs(reinterpret_cast<V*>(a.out[r] + dst) + i, v);
      }
    }
  }
}

template <typename V>
cudaError_t launch_ragged(const GatherArgs& a, int grid, cudaStream_t st) {
  ragged_gather<V><<<grid, kRaggedThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// local: m device pointers (this launch's sources, on the current device),
// slots: the chunk index of each; out: n device pointers (every peer's
// output, on this device or a peer-accessible one).  Every pointer is
// aligned to `width` bytes and chunk_bytes is a multiple of `width`.
// width 16 takes the bulk path (tile_bytes a multiple of 16, at most 32
// KiB); width 8, 4, 2 or 1 the ragged path (tile_bytes a multiple of
// width).  grid: CTAs to launch.
extern "C" int brpc_ring_all_gather(const uint64_t* local, const int* slots,
                                    int m, const uint64_t* out, int n,
                                    unsigned long long chunk_bytes, int width,
                                    unsigned long long tile_bytes, int grid,
                                    void* stream) {
  const bool bulk = width == 16;
  if (n < 2 || n > kMaxPeers || m < 1 || m > n || grid < 1 ||
      chunk_bytes == 0 || tile_bytes == 0 || (width & (width - 1)) != 0 ||
      width < 1 || width > 16 || chunk_bytes % width != 0 ||
      tile_bytes % width != 0 || (bulk && tile_bytes > kMaxTile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GatherArgs a = {};
  for (int k = 0; k < m; ++k) {
    if (local[k] % width != 0 || slots[k] < 0 || slots[k] >= n) {
      return static_cast<int>(local[k] % width != 0
                                  ? cudaErrorMisalignedAddress
                                  : cudaErrorInvalidValue);
    }
    a.local[k] = reinterpret_cast<const unsigned char*>(local[k]);
    a.slot[k] = slots[k];
  }
  for (int r = 0; r < n; ++r) {
    if (out[r] % width != 0) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
    a.out[r] = reinterpret_cast<unsigned char*>(out[r]);
  }
  a.n = n;
  a.chunk_bytes = chunk_bytes;
  a.tile_bytes = tile_bytes;
  a.units = static_cast<unsigned long long>(m) *
            ((chunk_bytes + tile_bytes - 1) / tile_bytes);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!bulk) {
    switch (width) {
      case 8:
        return static_cast<int>(
            launch_ragged<unsigned long long>(a, grid, st));
      case 4:
        return static_cast<int>(launch_ragged<unsigned>(a, grid, st));
      case 2:
        return static_cast<int>(launch_ragged<unsigned short>(a, grid, st));
      default:
        return static_cast<int>(launch_ragged<unsigned char>(a, grid, st));
    }
  }
  // Above 48 KB a block's dynamic shared memory must be asked for; the
  // attribute is per device, so it is set before every launch.
  cudaError_t e = cudaFuncSetAttribute(
      bulk_gather, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kBulkSmem));
  if (e != cudaSuccess) {
    return static_cast<int>(e);
  }
  bulk_gather<<<grid, kBulkThreads, kBulkSmem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Enables peer access from every device of `devs` (k of them) to every
// other, tolerating access already enabled; the current device is kept.
// Returns 0, a cudaError_t, or -1 with bad[0], bad[1] set to the first
// pair (from, to) for which cudaDeviceCanAccessPeer says no.
extern "C" int brpc_ring_enable_peers(const int* devs, int k, int* bad) {
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) {
    return static_cast<int>(e);
  }
  for (int a = 0; a < k; ++a) {
    for (int b = 0; b < k; ++b) {
      if (devs[a] == devs[b]) {
        continue;
      }
      int can = 0;
      e = cudaDeviceCanAccessPeer(&can, devs[a], devs[b]);
      if (e != cudaSuccess) {
        cudaSetDevice(current);
        return static_cast<int>(e);
      }
      if (!can) {
        bad[0] = devs[a];
        bad[1] = devs[b];
        cudaSetDevice(current);
        return -1;
      }
      e = cudaSetDevice(devs[a]);
      if (e == cudaSuccess) {
        e = cudaDeviceEnablePeerAccess(devs[b], 0);
      }
      if (e == cudaErrorPeerAccessAlreadyEnabled) {
        cudaGetLastError();  // clear the sticky-free error state
        e = cudaSuccess;
      }
      if (e != cudaSuccess) {
        cudaSetDevice(current);
        return static_cast<int>(e);
      }
    }
  }
  return static_cast<int>(cudaSetDevice(current));
}
