// The pipeline step's microbatch producer for Hopper (sm_90a): an iterated
// uint32 linear congruential map over a seeded vector.
//
// Replaces the jitted jnp loop of tools/pipeline_step.py:63-80 (not a Pallas
// kernel): `_piece_seed` builds v[i] = i * 2654435761 + base (mod 2^32) and
// `_make_kernel(iters)` runs `fori_loop(0, iters, v * 1664525 + 1013904223)`
// over it as one XLA dispatch.  Eager PyTorch would launch about three
// kernels per iteration, so the step's compute lane would become a loop of
// host launches; this kernel keeps it one launch per piece.  Each thread
// makes its own word's seed from (i, base) and iterates in a register;
// uint32 arithmetic wraps mod 2^32 natively, as jnp's uint32 does.
//
// Bound: integer operations.  words x iters dependent multiply-adds (one
// IMAD each), against the H100 SXM's 64 IMAD lanes per SM (132 SMs,
// 1.98 GHz boost): 16.7e12 a second.  The output, 4 x words bytes, is
// written once.  Design against that bound: one word per thread, so a piece
// of 65536 words (256 KiB) gives 16 warps per SM, enough to cover the IMAD
// latency; the loop unrolled by 8, so the counter's add and branch are a
// small share of the issued instructions.  Each step is an opaque
// `mad.lo.u32`.  Written as C++ (`v = v * kMul + kAdd`), the loop ran 2.0x
// faster than one IMAD a step allows on an H100: the compiler had folded
// unrolled steps of the constant affine map together, and the kernel no
// longer did the work the step's compute lane stands for (the jitted loop
// runs every iteration, and the pipeline calibrates `iters` against it).
//
// Interface: a plain C function, loaded with ctypes.  It launches on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kSeedMul = 2654435761u;
constexpr uint32_t kMul = 1664525u;
constexpr uint32_t kAdd = 1013904223u;

__global__ void __launch_bounds__(kThreads)
    lcg_kernel(uint32_t* __restrict__ out, size_t words, uint32_t base,
               uint32_t iters) {
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < words; i += stride) {
    uint32_t v = static_cast<uint32_t>(i) * kSeedMul + base;
#pragma unroll 8
    for (uint32_t k = 0; k < iters; ++k) {
      asm volatile("mad.lo.u32 %0, %0, %1, %2;"
                   : "+r"(v)
                   : "r"(kMul), "r"(kAdd));
    }
    out[i] = v;
  }
}

}  // namespace

extern "C" int brpc_lcg(void* out, size_t words, uint32_t base,
                        uint32_t iters, void* stream) {
  // One word per thread; the grid-stride loop covers pieces larger than
  // 2^31 threads.
  const size_t want = (words + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(
      want == 0 ? 1 : (want < (1u << 31) ? want : (1u << 31) - 1));
  lcg_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), words, base, iters);
  return static_cast<int>(cudaGetLastError());
}
