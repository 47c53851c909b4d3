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
// 2^24.  Here int32s are compared, exact over all of int32, and rows may
// be unsorted and overlap, so every run of a row may have to be read.
// - A warp owns a dot.  Its lanes stride the row together, 4 runs a lane
//   between votes, so each load of the warp is one coalesced row segment,
//   and a vote after every 128 runs lets it stop at its first hit.  1,024
//   dots of the serve path are 1,024 warps, 128 blocks.
// - Where both arrays fit 48 KB (A * R <= 6,144; the serve path's
//   tombstone is A = 1, R = 2,000, 16 KB) the block stages them in shared
//   memory once and every warp reads them there.
//
// Bound.  At the serve path's shape (A = 1, R = 2000, N = 1024) a launch
// moves A*R*8 + N*9 bytes (< 30 KB) and does ~4 M int compares (a miss
// reads the whole row): 60 ns of the card's ALU time, far below one
// launch's latency (an empty kernel in a CUDA graph), which is the floor
// this kernel can reach.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps, 8 dots
constexpr int kUnroll = 4;  // runs a lane reads between two votes
constexpr int kStageInts = 48 * 1024 / 4;  // starts and ends, staged

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
dot_seen_kernel(const int32_t* __restrict__ starts,
                const int32_t* __restrict__ ends,
                const int32_t* __restrict__ actors,
                const int32_t* __restrict__ counters,
                uint8_t* __restrict__ out,
                int n_actors, int n_runs, int n) {
  __shared__ int32_t rows[kStaged ? kStageInts : 1];
  const int32_t* s_rows = starts;
  const int32_t* e_rows = ends;
  if constexpr (kStaged) {
    const int total = n_actors * n_runs;
    for (int i = threadIdx.x; i < total; i += kThreads) {
      rows[i] = __ldg(starts + i);
      rows[total + i] = __ldg(ends + i);
    }
    __syncthreads();
    s_rows = rows;
    e_rows = rows + total;
  }
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  int32_t a = 0, c = 0;
  bool done = true;  // out of range, unknown actor, or found
  if (i < n) {
    a = actors[i];
    c = counters[i];
    done = a < 0 || a >= n_actors;
  }
  const int32_t* s = s_rows + static_cast<int64_t>(done ? 0 : a) * n_runs;
  const int32_t* e = e_rows + static_cast<int64_t>(done ? 0 : a) * n_runs;
  bool seen = false;
  if (!done) {
    for (int base = 0; base < n_runs; base += 32 * kUnroll) {
      bool hit = false;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = base + u * 32 + lane;
        if (r < n_runs) hit |= (s[r] <= c) & (c <= e[r]);
      }
      if (__any_sync(0xffffffffu, hit)) {
        seen = true;
        break;
      }
    }
  }
  if (i < n && lane == 0) out[i] = seen;
}

}  // namespace

// Launch `blocks` blocks on `stream`, a warp a dot (a block holds 8 dots),
// with the rows staged in shared memory if `staged` (2 * A * R ints must
// fit 48 KB); returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for rows too large to stage or too few blocks for
// N dots.  All pointers are device pointers to contiguous int32 data,
// `out` to N bytes (a torch.bool tensor).
extern "C" int dot_seen_launch(const void* starts, const void* ends,
                               const void* actors, const void* counters,
                               void* out, int n_actors, int n_runs, int n,
                               int staged, int blocks, void* stream) {
  if (staged && 2 * static_cast<int64_t>(n_actors) * n_runs > kStageInts)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(blocks) * (kThreads / 32) < n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const auto* s = static_cast<const int32_t*>(starts);
  const auto* e = static_cast<const int32_t*>(ends);
  const auto* a = static_cast<const int32_t*>(actors);
  const auto* c = static_cast<const int32_t*>(counters);
  auto* o = static_cast<uint8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (staged)
    dot_seen_kernel<true><<<blocks, kThreads, 0, st>>>(s, e, a, c, o,
                                                       n_actors, n_runs, n);
  else
    dot_seen_kernel<false><<<blocks, kThreads, 0, st>>>(s, e, a, c, o,
                                                        n_actors, n_runs, n);
  return static_cast<int>(cudaGetLastError());
}
