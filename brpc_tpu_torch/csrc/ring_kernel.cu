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
// each on a stream of that device.
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
// Fenced launches (brpc_ring_all_gather_xcard: one launch per card, or
// several on one card's streams) order themselves on the card, not with
// events between streams: a barrier over flags in peer-mapped device
// memory, one BarrierFlags block per launch ("participant").  Every CTA
// first tells every other participant that its launch has started
// (system-scope release stores into their blocks: its stream has made its
// chunk and freed its output), issues its first loads, and waits with
// acquire loads until every other participant has started; only then does
// it store into their outputs.  After its stores have landed (bulk groups
// complete, fence.acq_rel.sys) it counts itself in; the launch's last CTA
// tells every other participant "done" and waits for all of theirs before
// it exits, so the kernel ends only when every write into this
// participant's output has landed, and the stream that reads that output
// is ordered behind this one launch.  The generation ("epoch") lives in
// the block and the kernel advances it, so a CUDA graph replays the same
// arguments.  A wait that spins longer than timeout_ns (counted in SM
// clocks) traps: a peer that never starts shows as a CUDA error, not a
// hang.  The barrier needs every participant running at once: one launch
// per card always is; launches that share a card must fit on it
// together, which the wrapper checks.  Two fenced gathers over the same
// cards must not run at once (they would share flag blocks, and each
// could hold SMs the other's launch waits for), so the wrapper makes
// them take turns on each card.
//
// The fenced bulk path cuts the work into (destination, tile) units, each
// loaded and stored to one output, so that at 4 cards x 8 MiB every CTA
// holds 7 or 8 units and its kStages-deep ring fills (one store stream
// of (source, tile) units left it 2, and the CTAs waited on remote
// completions instead).  Consecutive units go to consecutive
// destinations, starting at the next peer: with a grid that is a
// multiple of n each CTA streams to one card (its stores stay on one
// link), and the cards' first stores go to different cards.  On four
// H100s this ordering beat destination-major units (PERF.md).
//
// Ragged path (C or a pointer not 16-byte aligned, as a narrow view of an
// odd-sized chunk is): the CTA's threads copy at the widest width w in
// {8, 4, 2, 1} that divides C and every address; each element is read
// once and stored n times.  The wrapper's plan (plan_gather,
// plan_launches) chooses the path, the tile and the grid.
//
// Interface: plain C functions, loaded with ctypes.  brpc_ring_all_gather
// launches on the stream it is given (of the current device), and
// brpc_ring_all_gather_xcard makes every fenced launch of a gather, each
// on its device and stream; neither synchronises or allocates device
// memory, and each returns a cudaError_t.  brpc_ring_enable_peers enables
// peer access between the cards a gather spans; brpc_ring_barrier_bytes
// is the size of one participant's flag block (allocated zeroed by the
// wrapper, once per set of participants); brpc_ring_xcard_blocks_per_sm
// is a fenced kernel's residency per SM.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

constexpr int kMaxPeers = 64;
constexpr int kStages = 4;                 // bulk path: tiles in flight
constexpr unsigned kMaxTile = 32 * 1024;   // bulk path: bytes per stage
constexpr int kBulkThreads = 32;           // one warp; lane 0 drives
constexpr int kRaggedThreads = 256;
constexpr int kRaggedCtasPerSm = 8;        // fenced ragged: 2048 threads
constexpr size_t kBulkSmem = static_cast<size_t>(kStages) * kMaxTile;

// One participant's barrier words, in its own device's memory; the other
// participants write `ready` and `done`, the participant polls them.
struct BarrierFlags {
  unsigned epoch;    // gathers this participant has finished
  unsigned arrived;  // CTAs of its running launch past their stores
  unsigned pad[30];  // the words peers write start on their own 128 bytes
  unsigned ready[kMaxPeers];  // [q]: the epoch participant q has started
  unsigned done[kMaxPeers];   // [q]: the epoch whose stores q has landed
};

struct GatherArgs {
  const unsigned char* local[kMaxPeers];  // this launch's m sources
  int slot[kMaxPeers];                    // source k is chunk slot[k]
  unsigned char* out[kMaxPeers];          // every peer's output
  unsigned long long chunk_bytes;  // C
  unsigned long long tile_bytes;   // T: C is cut into ceil(C / T) tiles
  // m * tiles, u = (u / tiles, u % tiles); on the fenced bulk path
  // n * m * tiles, u = (the rest as above of u / n, destination u % n)
  unsigned long long units;
  int n;
  // Fenced launches only: every participant's flags, this launch's index
  // among them, their count, the bulk path's destination of unit 0, and
  // the longest wait before a trap.
  BarrierFlags* flags[kMaxPeers];
  int self;
  int parties;
  int rot;
  unsigned long long timeout_cycles;
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

__device__ __forceinline__ void store_release_sys(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned load_acquire_sys(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Stores `epoch` into this participant's word of every other
// participant's `ready` (or `done`) array.
__device__ void signal_peers(const GatherArgs& a, bool done,
                             unsigned epoch) {
  for (int q = 0; q < a.parties; ++q) {
    if (q != a.self) {
      BarrierFlags* f = a.flags[q];
      store_release_sys((done ? f->done : f->ready) + a.self, epoch);
    }
  }
}

// Waits until every other participant has stored `epoch` (or a later
// one) into this participant's `ready` (or `done`) array; traps once the
// wait has spun a.timeout_cycles clocks of its SM.
__device__ void wait_peers(const GatherArgs& a, bool done, unsigned epoch) {
  const BarrierFlags* me = a.flags[a.self];
  const unsigned* words = done ? me->done : me->ready;
  const long long start = clock64();
  for (int q = 0; q < a.parties; ++q) {
    if (q == a.self) {
      continue;
    }
    while (static_cast<int>(load_acquire_sys(words + q) - epoch) < 0) {
      if (static_cast<unsigned long long>(clock64() - start) >
          a.timeout_cycles) {
        __trap();
      }
    }
  }
}

// A fenced CTA's first step (one thread): the gather's epoch, announced
// to every other participant.
__device__ unsigned fenced_begin(const GatherArgs& a) {
  const unsigned epoch =
      *reinterpret_cast<volatile unsigned*>(&a.flags[a.self]->epoch) + 1;
  signal_peers(a, false, epoch);
  return epoch;
}

// A fenced CTA's last step (one thread, its stores complete): count the
// CTA in; the launch's last CTA announces "done", waits for every other
// participant's, and advances the epoch.
__device__ void fenced_end(const GatherArgs& a, unsigned epoch) {
  asm volatile("fence.acq_rel.sys;" ::: "memory");
  BarrierFlags* me = a.flags[a.self];
  unsigned before;
  asm volatile("atom.add.acq_rel.sys.global.u32 %0, [%1], 1;"
               : "=r"(before)
               : "l"(&me->arrived)
               : "memory");
  if (before + 1 != gridDim.x) {
    return;
  }
  *reinterpret_cast<volatile unsigned*>(&me->arrived) = 0;
  signal_peers(a, true, epoch);
  wait_peers(a, true, epoch);
  *reinterpret_cast<volatile unsigned*>(&me->epoch) = epoch;
}

template <bool kFenced>
__global__ void __launch_bounds__(kBulkThreads)
    bulk_gather(const __grid_constant__ GatherArgs a) {
  extern __shared__ __align__(128) unsigned char stage[];
  __shared__ __align__(8) uint64_t full[kStages];
  const unsigned long long first = blockIdx.x;
  const unsigned long long stride = gridDim.x;
  // A fenced CTA counts itself in even with no unit.
  if (threadIdx.x != 0 || (!kFenced && first >= a.units)) {
    return;
  }
  const unsigned long long C = a.chunk_bytes;
  const unsigned long long T = a.tile_bytes;
  const unsigned long long tiles = (C + T - 1) / T;
  const unsigned long long count =
      first < a.units ? (a.units - first + stride - 1) / stride : 0;
  const uint32_t stage0 = smem_addr(stage);
  const uint32_t full0 = smem_addr(full);
  for (int s = 0; s < kStages; ++s) {
    mbar_init(full0 + 8 * s);
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  uint64_t evict_first;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(evict_first));
  unsigned epoch = 0;
  if constexpr (kFenced) {
    epoch = fenced_begin(a);
  }

  // Unit k of this CTA: source slot j, byte offset `off` into the chunk,
  // bytes, and on the fenced path its one destination r.
  auto unit = [&](unsigned long long k, int* j, unsigned long long* off,
                  uint32_t* bytes, int* r) {
    const unsigned long long u = first + k * stride;
    const unsigned long long v = kFenced ? u / a.n : u;
    *r = kFenced ? static_cast<int>((u % a.n + a.rot) % a.n) : 0;
    *j = static_cast<int>(v / tiles);
    *off = (v % tiles) * T;
    *bytes = static_cast<uint32_t>(C - *off < T ? C - *off : T);
  };
  auto load = [&](unsigned long long k) {
    int j, r;
    unsigned long long off;
    uint32_t bytes;
    unit(k, &j, &off, &bytes, &r);
    const int s = static_cast<int>(k % kStages);
    bulk_load(stage0 + s * kMaxTile, a.local[j] + off, bytes, full0 + 8 * s);
  };

  for (unsigned long long k = 0; k < count && k < kStages; ++k) {
    load(k);
  }
  if constexpr (kFenced) {
    // No store into a peer's output before that peer has started; the
    // proxy fence orders the acquire before the bulk (async-proxy) stores.
    wait_peers(a, false, epoch);
    asm volatile("fence.proxy.async.global;" ::: "memory");
  }
  for (unsigned long long k = 0; k < count; ++k) {
    const int s = static_cast<int>(k % kStages);
    mbar_wait(full0 + 8 * s, static_cast<uint32_t>((k / kStages) & 1));
    int j, r;
    unsigned long long off;
    uint32_t bytes;
    unit(k, &j, &off, &bytes, &r);
    const unsigned long long dst = a.slot[j] * C + off;
    if constexpr (kFenced) {
      bulk_store(a.out[r] + dst, stage0 + s * kMaxTile, bytes, evict_first);
    } else {
      for (r = 0; r < a.n; ++r) {
        bulk_store(a.out[r] + dst, stage0 + s * kMaxTile, bytes,
                   evict_first);
      }
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
  if constexpr (kFenced) {
    asm volatile("fence.proxy.async.global;" ::: "memory");
    fenced_end(a, epoch);
  }
}

template <typename V, bool kFenced>
__global__ void __launch_bounds__(kRaggedThreads,
                                  kFenced ? kRaggedCtasPerSm : 1)
    ragged_gather(const __grid_constant__ GatherArgs a) {
  const unsigned long long C = a.chunk_bytes;
  const unsigned long long T = a.tile_bytes;
  const unsigned long long tiles = (C + T - 1) / T;
  unsigned epoch = 0;  // thread 0's
  if constexpr (kFenced) {
    if (threadIdx.x == 0) {
      epoch = fenced_begin(a);
      wait_peers(a, false, epoch);
    }
    __syncthreads();
  }
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
  if constexpr (kFenced) {
    __syncthreads();
    if (threadIdx.x == 0) {
      fenced_end(a, epoch);
    }
  }
}

template <typename V, bool kFenced>
cudaError_t launch_ragged(const GatherArgs& a, int grid, cudaStream_t st) {
  ragged_gather<V, kFenced><<<grid, kRaggedThreads, 0, st>>>(a);
  return cudaGetLastError();
}

// Validates the arguments common to both entries and fills `a` (all but
// the fenced fields and `units`); returns 0 or a cudaError_t.
int fill_args(const uint64_t* local, const int* slots, int m,
              const uint64_t* out, int n, unsigned long long chunk_bytes,
              int width, unsigned long long tile_bytes, int grid,
              GatherArgs* a) {
  const bool bulk = width == 16;
  if (n < 2 || n > kMaxPeers || m < 1 || m > n || grid < 1 ||
      chunk_bytes == 0 || tile_bytes == 0 || (width & (width - 1)) != 0 ||
      width < 1 || width > 16 || chunk_bytes % width != 0 ||
      tile_bytes % width != 0 || (bulk && tile_bytes > kMaxTile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int k = 0; k < m; ++k) {
    if (local[k] % width != 0 || slots[k] < 0 || slots[k] >= n) {
      return static_cast<int>(local[k] % width != 0
                                  ? cudaErrorMisalignedAddress
                                  : cudaErrorInvalidValue);
    }
    a->local[k] = reinterpret_cast<const unsigned char*>(local[k]);
    a->slot[k] = slots[k];
  }
  for (int r = 0; r < n; ++r) {
    if (out[r] % width != 0) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
    a->out[r] = reinterpret_cast<unsigned char*>(out[r]);
  }
  a->n = n;
  a->chunk_bytes = chunk_bytes;
  a->tile_bytes = tile_bytes;
  a->units = static_cast<unsigned long long>(m) *
             ((chunk_bytes + tile_bytes - 1) / tile_bytes);
  return 0;
}

template <bool kFenced>
int launch(const GatherArgs& a, int width, int grid, cudaStream_t st) {
  switch (width) {
    case 16:
      break;
    case 8:
      return static_cast<int>(
          launch_ragged<unsigned long long, kFenced>(a, grid, st));
    case 4:
      return static_cast<int>(launch_ragged<unsigned, kFenced>(a, grid, st));
    case 2:
      return static_cast<int>(
          launch_ragged<unsigned short, kFenced>(a, grid, st));
    default:
      return static_cast<int>(
          launch_ragged<unsigned char, kFenced>(a, grid, st));
  }
  // Above 48 KB a block's dynamic shared memory must be asked for; the
  // attribute is per device, so it is set before every launch.
  cudaError_t e = cudaFuncSetAttribute(
      bulk_gather<kFenced>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kBulkSmem));
  if (e != cudaSuccess) {
    return static_cast<int>(e);
  }
  bulk_gather<kFenced><<<grid, kBulkThreads, kBulkSmem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
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
  GatherArgs a = {};
  const int rc = fill_args(local, slots, m, out, n, chunk_bytes, width,
                           tile_bytes, grid, &a);
  if (rc != 0) {
    return rc;
  }
  return launch<false>(a, width, grid, static_cast<cudaStream_t>(stream));
}

// Every fenced launch of one gather (`parties` of them, each on its own
// stream, of one card or of several cards of the host), validated
// together and then made one after another; the current device is kept.
// Launch k runs on device devices[k] and stream streams[k] and reads m[k]
// sources, the next m[k] entries of local and slots; width[k],
// tile_bytes[k] and grid[k] are as for brpc_ring_all_gather, and out, n
// and chunk_bytes are shared.  flags: every launch's BarrierFlags block
// (brpc_ring_barrier_bytes, zeroed once, on its own device, each
// reachable from every launch's device); timeout_ns: the longest wait for
// another launch before a trap.  On the bulk path a unit is one
// (destination, tile) pair, so there are n times the units.  Returns 0,
// or the first cudaError_t: no launch is made when any is invalid, and
// when launch k is refused, launches 0..k-1 trap after timeout_ns.
extern "C" int brpc_ring_all_gather_xcard(
    int parties, const int* devices, const uint64_t* streams,
    const uint64_t* local, const int* slots, const int* m,
    const uint64_t* out, int n, unsigned long long chunk_bytes,
    const int* width, const unsigned long long* tile_bytes, const int* grid,
    const uint64_t* flags, unsigned long long timeout_ns) {
  if (parties < 2 || parties > kMaxPeers || timeout_ns == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  std::vector<GatherArgs> args(parties);
  int first = 0;  // this launch's first entry of local and slots
  for (int k = 0; k < parties; ++k) {
    GatherArgs& a = args[k];
    if (m[k] < 1 || first + m[k] > n) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int rc = fill_args(local + first, slots + first, m[k], out, n,
                             chunk_bytes, width[k], tile_bytes[k], grid[k],
                             &a);
    if (rc != 0) {
      return rc;
    }
    for (int q = 0; q < parties; ++q) {
      if (flags[q] == 0 || flags[q] % alignof(BarrierFlags) != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      a.flags[q] = reinterpret_cast<BarrierFlags*>(flags[q]);
    }
    a.self = k;
    a.parties = parties;
    a.rot = (slots[first] + 1) % n;
    // SM clocks for a wait: 2 a nanosecond is at least timeout_ns up to
    // 2 GHz (the H100 SXM boosts to 1.98).
    a.timeout_cycles = 2 * timeout_ns;
    if (width[k] == 16) {
      a.units *= static_cast<unsigned long long>(n);
    }
    first += m[k];
  }
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) {
    return static_cast<int>(e);
  }
  int rc = 0;
  for (int k = 0; k < parties && rc == 0; ++k) {
    rc = static_cast<int>(cudaSetDevice(devices[k]));
    if (rc == 0) {
      rc = launch<true>(args[k], width[k], grid[k],
                        reinterpret_cast<cudaStream_t>(streams[k]));
    }
  }
  const cudaError_t back = cudaSetDevice(current);
  return rc != 0 ? rc : static_cast<int>(back);
}

// Bytes of one participant's flag block.
extern "C" int brpc_ring_barrier_bytes() {
  return static_cast<int>(sizeof(BarrierFlags));
}

// CTAs of the fenced kernel of `width` that one SM of the current device
// holds at once, into *blocks; returns a cudaError_t.
extern "C" int brpc_ring_xcard_blocks_per_sm(int width, int* blocks) {
  cudaError_t e;
  switch (width) {
    case 16:
      e = cudaFuncSetAttribute(bulk_gather<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kBulkSmem));
      if (e == cudaSuccess) {
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks, bulk_gather<true>, kBulkThreads, kBulkSmem);
      }
      break;
    case 8:
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, ragged_gather<unsigned long long, true>, kRaggedThreads, 0);
      break;
    case 4:
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, ragged_gather<unsigned, true>, kRaggedThreads, 0);
      break;
    case 2:
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, ragged_gather<unsigned short, true>, kRaggedThreads, 0);
      break;
    case 1:
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, ragged_gather<unsigned char, true>, kRaggedThreads, 0);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
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
