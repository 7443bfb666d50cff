// K2: the ring all-gather for Hopper (sm_90a), over the logical peers of
// one card.
//
// Replaces brpc_tpu/ops/ring_kernel.py::_ring_kernel (the Pallas kernel that
// ring_all_gather_pallas launches).  It keeps that kernel's schedule: an
// entry barrier to both neighbours; the own chunk into its slot of the output
// and into comm[0]; then N-1 hops, each of which waits for the arrival in
// comm[(step+1)%2], grants the left neighbour cap[step%2], waits for the
// right neighbour's grant of the same slot, forwards the arrival into the
// right neighbour's comm[step%2] (hop step+1) and only then copies the
// arrival to out[src], src = (r - step - 1) mod n; and an exit barrier.
// The TPU's remote DMA becomes a push: the sending CTA writes into the
// neighbour's comm slot and then raises the neighbour's arrival flag.
//
// Form: one launch serves all n peers.  Each peer's buffers come in through
// per-peer pointers (local[r], out[r], comm[r] with its two slots) and each
// peer has a flag pad; a later multi-GPU form changes only the pointers (to
// peer-mapped memory) and the scope of the flags (system instead of gpu).
// Each chunk is cut into `stripes` stripes and every stripe is a ring of its
// own with its own flags, one CTA per (peer, stripe), so no CTA waits on
// another CTA of its own peer.  Flags count monotonically (arrivals per
// slot, grants per slot, barrier signals), are zeroed by a stream-ordered
// memset before each launch, and are raised with red.release.gpu after a
// __syncthreads() and read with ld.acquire.gpu; comm slots are read and
// written through L2 (.cg), never a stale L1 line.
//
// Co-residency: every CTA spins on its neighbours, so all must be resident
// at once.  The kernel is launched cooperatively, which CUDA refuses
// (cudaErrorCooperativeLaunchTooLarge) for a grid that cannot be resident;
// the wrapper sizes the grid from brpc_ring_capacity and raises before that.
// Every spin is bounded by the global timer (kSpinNs): a CTA that waits
// longer records (kind, peer, hop, stripe) in the error words and returns,
// and a CTA that sees an error recorded stops waiting; the wrapper raises.
//
// Bound on one card: device-memory bytes.  The function must read the n
// chunks and write n replicated outputs, (n + n^2) * C bytes: at n = 8 and
// C = 8 MiB that is 576 MiB, 0.180 ms at the H100 SXM's published 3.35 TB/s.
// The schedule moves more: per peer it reads its chunk once and writes it
// twice, and per hop writes the forwarded chunk and copies the arrival out,
// n * (4n - 1) * C bytes in all (2.0 GiB at the same size, 0.64 ms), so this
// faithful port can reach at most ~0.28 of the function's bound.  Design
// against the schedule's own bytes: 16-byte loads and stores, neighbouring
// threads on neighbouring addresses, four loads in flight per thread before
// any store, one wait and one signal per hop for a whole stripe.
//
// Interface: plain C functions, loaded with ctypes.  brpc_ring_all_gather
// zeroes the flag pad and error words on the caller's stream, launches, does
// not synchronise, allocates nothing, and returns the launch's cudaError_t.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPeers = 64;
constexpr int kFlagWords = 8;  // per (peer, stripe); 5 used, padded
constexpr int kRecv0 = 0;      // arrivals into comm[0], comm[1]
constexpr int kCap0 = 2;       // grants of comm[0], comm[1]
constexpr int kBarrier = 4;    // entry + exit barrier signals
constexpr unsigned long long kSpinNs = 5ull * 1000 * 1000 * 1000;

// What a stalled CTA was waiting for (error word 0).
constexpr int kWaitEntry = 1;
constexpr int kWaitArrival = 2;
constexpr int kWaitGrant = 3;
constexpr int kWaitExit = 4;

struct RingArgs {
  const uint4* local[kMaxPeers];
  uint4* out[kMaxPeers];
  uint4* comm[kMaxPeers];  // two slots of chunk_vecs each
  unsigned* flags;         // [n][stripes][kFlagWords]
  int* err;                // kind, peer, hop, stripe
  int n;
  int stripes;
  size_t chunk_vecs;   // uint4 per chunk
  size_t stripe_vecs;  // uint4 per stripe
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void red_release_add(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;"
               :
               : "l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned* flag(const RingArgs& a, int peer,
                                          int stripe, int word) {
  return a.flags +
         (static_cast<size_t>(peer) * a.stripes + stripe) * kFlagWords + word;
}

// Thread 0 only, after the block's writes are done (__syncthreads()).
__device__ __forceinline__ void signal(unsigned* f) {
  __threadfence();
  red_release_add(f, 1u);
}

// Thread 0 only: waits until *f >= want.  False when the wait ran past
// kSpinNs (recording why) or another CTA recorded an error first.
__device__ bool wait_at_least(const RingArgs& a, const unsigned* f,
                              unsigned want, int kind, int peer, int hop,
                              int stripe) {
  if (ld_acquire(f) >= want) {
    return true;
  }
  const unsigned long long start = global_ns();
  for (;;) {
    if (ld_acquire(f) >= want) {
      __threadfence();
      return true;
    }
    if (*reinterpret_cast<volatile int*>(a.err) != 0) {
      return false;
    }
    if (global_ns() - start > kSpinNs) {
      if (atomicCAS(a.err, 0, kind) == 0) {
        a.err[1] = peer;
        a.err[2] = hop;
        a.err[3] = stripe;
        __threadfence();
      }
      return false;
    }
    __nanosleep(64);
  }
}

// dst[i] = src[i] for a stripe, through L2 on both sides.
__device__ __forceinline__ void copy_stripe(uint4* dst, const uint4* src,
                                            size_t n) {
  size_t i = threadIdx.x;
  for (; i + 3 * kThreads < n; i += 4 * kThreads) {
    const uint4 v0 = __ldcg(src + i);
    const uint4 v1 = __ldcg(src + i + kThreads);
    const uint4 v2 = __ldcg(src + i + 2 * kThreads);
    const uint4 v3 = __ldcg(src + i + 3 * kThreads);
    __stcg(dst + i, v0);
    __stcg(dst + i + kThreads, v1);
    __stcg(dst + i + 2 * kThreads, v2);
    __stcg(dst + i + 3 * kThreads, v3);
  }
  for (; i < n; i += kThreads) {
    __stcg(dst + i, __ldcg(src + i));
  }
}

// dst0[i] = dst1[i] = src[i]: one read, two writes.
__device__ __forceinline__ void copy_stripe2(uint4* dst0, uint4* dst1,
                                             const uint4* src, size_t n) {
  for (size_t i = threadIdx.x; i < n; i += kThreads) {
    const uint4 v = __ldcg(src + i);
    __stcg(dst0 + i, v);
    __stcg(dst1 + i, v);
  }
}

__global__ void __launch_bounds__(kThreads)
    ring_all_gather_kernel(const RingArgs a) {
  __shared__ int ok;
  const int n = a.n;
  const int r = blockIdx.x / a.stripes;
  const int s = blockIdx.x % a.stripes;
  const int left = (r + n - 1) % n;
  const int right = (r + 1) % n;
  const size_t sv = a.stripe_vecs;
  const size_t off = static_cast<size_t>(s) * sv;
  uint4* const mine = a.comm[r] + off;        // my slot 0 of this stripe
  uint4* const theirs = a.comm[right] + off;  // the right neighbour's
  const size_t slot = a.chunk_vecs;           // slot 1 = slot 0 + slot
  const bool lead = threadIdx.x == 0;

  // Entry barrier: both neighbours are inside the kernel before any
  // hop-0 write lands.
  if (lead) {
    signal(flag(a, left, s, kBarrier));
    signal(flag(a, right, s, kBarrier));
    ok = wait_at_least(a, flag(a, r, s, kBarrier), 2, kWaitEntry, r, -1, s);
  }
  __syncthreads();
  if (!ok) {
    return;
  }

  // Own chunk into its slot of the output and into comm[0]; hop 0 pushes
  // comm[0] into the right neighbour's comm[1].
  copy_stripe2(a.out[r] + r * a.chunk_vecs + off, mine, a.local[r] + off, sv);
  __syncthreads();
  copy_stripe(theirs + slot, mine, sv);
  __syncthreads();
  if (lead) {
    signal(flag(a, right, s, kRecv0 + 1));
  }

  for (int step = 0; step < n - 1; ++step) {
    const int recv_slot = (step + 1) & 1;
    const int parity = step & 1;
    const int src = (r - step - 1 + 2 * n) % n;
    const unsigned nth = static_cast<unsigned>(step / 2 + 1);
    // This hop's chunk has landed in comm[recv_slot] (our own push from
    // comm[parity] finished before the last __syncthreads()).
    if (lead) {
      ok = wait_at_least(a, flag(a, r, s, kRecv0 + recv_slot), nth,
                         kWaitArrival, r, step, s);
    }
    __syncthreads();
    if (!ok) {
      return;
    }
    if (step + 1 < n - 1) {
      // Grant left our comm[parity] (drained: sent from and copied out),
      // wait for right's grant of its comm[parity], forward hop step+1.
      if (lead) {
        signal(flag(a, left, s, kCap0 + parity));
        ok = wait_at_least(a, flag(a, r, s, kCap0 + parity), nth, kWaitGrant,
                           r, step, s);
      }
      __syncthreads();
      if (!ok) {
        return;
      }
      copy_stripe(theirs + parity * slot, mine + recv_slot * slot, sv);
      __syncthreads();
      if (lead) {
        signal(flag(a, right, s, kRecv0 + parity));
      }
    }
    copy_stripe(a.out[r] + src * a.chunk_vecs + off, mine + recv_slot * slot,
                sv);
    __syncthreads();
  }

  // Exit barrier: neighbours are done with our buffers.
  if (lead) {
    signal(flag(a, left, s, kBarrier));
    signal(flag(a, right, s, kBarrier));
    wait_at_least(a, flag(a, r, s, kBarrier), 4, kWaitExit, r, n - 1, s);
  }
}

}  // namespace

// The most CTAs of ring_all_gather_kernel that can be resident at once on
// the current device (occupancy x SMs); 0 when the device has no
// cooperative launch.  Returns a cudaError_t.
extern "C" int brpc_ring_capacity(int* ctas) {
  int dev = 0;
  int sms = 0;
  int coop = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ring_all_gather_kernel, kThreads, 0);
  }
  *ctas = coop ? per_sm * sms : 0;
  return static_cast<int>(err);
}

extern "C" int brpc_ring_max_peers() { return kMaxPeers; }

// local/out/comm: n device pointers each, 16-byte aligned; comm[r] holds
// 2 * chunk_bytes.  flags: n * stripes * 8 words; err: 4 words.
extern "C" int brpc_ring_all_gather(const uint64_t* local, const uint64_t* out,
                                    const uint64_t* comm, int n, int stripes,
                                    size_t chunk_bytes, void* flags,
                                    void* err, void* stream) {
  if (n < 2 || n > kMaxPeers || stripes < 1 ||
      chunk_bytes % (sizeof(uint4) * stripes) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  RingArgs a = {};
  for (int r = 0; r < n; ++r) {
    a.local[r] = reinterpret_cast<const uint4*>(local[r]);
    a.out[r] = reinterpret_cast<uint4*>(out[r]);
    a.comm[r] = reinterpret_cast<uint4*>(comm[r]);
  }
  a.flags = static_cast<unsigned*>(flags);
  a.err = static_cast<int*>(err);
  a.n = n;
  a.stripes = stripes;
  a.chunk_vecs = chunk_bytes / sizeof(uint4);
  a.stripe_vecs = a.chunk_vecs / stripes;
  cudaError_t e = cudaMemsetAsync(
      flags, 0, sizeof(unsigned) * kFlagWords * n * stripes, st);
  if (e == cudaSuccess) {
    e = cudaMemsetAsync(err, 0, 4 * sizeof(int), st);
  }
  if (e != cudaSuccess) {
    return static_cast<int>(e);
  }
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(ring_all_gather_kernel),
      dim3(static_cast<unsigned>(n * stripes)), dim3(kThreads), params, 0, st);
  if (e != cudaSuccess) {
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}
