// Batched dot-seen test against a dense interval clock, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/dot_seen/kernel.py
// (dot_seen_pallas -> _kernel).  For every dot i:
//
//   seen[i] = any_r( starts[a_i, r] <= c_i <= ends[a_i, r] )
//
// with a_i = actors[i], c_i = counters[i].  Empty run slots are (1, 0) and
// counter 0 is the "unseen" sentinel, so neither can match.  An actor
// outside [0, A) reads as unseen and its row is never read.
//
// Design.  The TPU kernel gathers each dot's actor row through an f32
// one-hot matmul, because a TPU has no gather; that is exact only below
// 2^24.  Here each thread owns one dot, reads its actor's row directly and
// compares int32s, which is exact over all of int32.  It scans the R runs
// in order and stops at the first hit, so rows may be unsorted.  The dots
// of a warp mostly share one row (the serve path has A = 1), so a load is a
// broadcast that the L1 cache serves after the first warp.
//
// Bound.  At the serve path's shapes (A = 1, R ~ 2000, N <= 1024) a launch
// moves A*R*8 + N*9 bytes (< 30 KB) and does at most 2*N*R int compares
// (~4M), under a microsecond of the card's memory and ALU time; launch
// latency and the per-query host-to-device copy of the tombstone dominate.
// Binary search over sorted rows and shared-memory staging of the clock
// are left for later.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
dot_seen_kernel(const int32_t* __restrict__ starts,
                const int32_t* __restrict__ ends,
                const int32_t* __restrict__ actors,
                const int32_t* __restrict__ counters,
                uint8_t* __restrict__ out,
                int n_actors, int n_runs, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t a = actors[i];
  const int32_t c = counters[i];
  uint8_t seen = 0;
  if (a >= 0 && a < n_actors) {
    const int32_t* s = starts + static_cast<int64_t>(a) * n_runs;
    const int32_t* e = ends + static_cast<int64_t>(a) * n_runs;
    for (int r = 0; r < n_runs; ++r) {
      if (__ldg(s + r) <= c && c <= __ldg(e + r)) {
        seen = 1;
        break;
      }
    }
  }
  out[i] = seen;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  All
// pointers are device pointers to contiguous int32 data, `out` to N bytes
// (a torch.bool tensor).
extern "C" int dot_seen_launch(const void* starts, const void* ends,
                               const void* actors, const void* counters,
                               void* out, int n_actors, int n_runs, int n,
                               void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (n + kThreads - 1) / kThreads;
  dot_seen_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(ends),
      static_cast<const int32_t*>(actors),
      static_cast<const int32_t*>(counters), static_cast<uint8_t*>(out),
      n_actors, n_runs, n);
  return static_cast<int>(cudaGetLastError());
}
