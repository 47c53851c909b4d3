// Interval clock-lattice kernels, for Hopper (sm_90a): the boundary-sweep
// run merge (join / subtract / intersect) and run-length popcount over the
// int32[A, R] run arrays of a dense interval clock.
//
// Replaces the Pallas TPU kernels repro/kernels/clock_ops/kernel.py:
// join_pallas, subtract_pallas and intersect_pallas (-> _merge_op ->
// _merge_kernel), and popcount_pallas (-> _popcount_kernel).
//
// Merge.  For each actor row, with A's runs (a_s, a_e)[Ra] and B's runs
// (b_s, b_e)[Rb], P = Ra + Rb candidates, and a counter live under the
// mode's predicate over (in A, in B) -- or: a | b, andnot: a & !b,
// and: a & b:
//
//   candidate p      = A's run p, or B's run p - Ra; starts (s_p) and ends
//                      (e_p) are the run's edges, except that andnot takes
//                      b_e + 1 and b_s - 1 from B's runs;
//   is_end[p]        = valid_p & live(e_p) & !live(e_p + 1)
//   is_start[p]      = valid_p & live(s_p) & !live(s_p - 1)
//                      & no earlier valid candidate q < p has s_q == s_p
//   out[p]           = (s_p, min{ e_q : is_end[q], e_q >= s_p })  if is_start
//                      (1, 0)                                      otherwise
//
// where valid_p is "the source run is not empty" (s <= e).  Outputs are the
// unsorted int32[A, P] pair, in the same slots as the plain version
// (repro_torch.core.vclock._interval_merge), which the wrapper sorts.
// Inputs may be unsorted, overlapping, duplicated and hold empty slots
// anywhere.  The duplicate test needs no flag of the other candidate: two
// equal start values have equal liveness, so an earlier equal candidate
// starts a run exactly when its source run is valid.
//
// Candidates are int64, as in the plain version: b_e + 1, b_s - 1 and the
// neighbours s_p - 1, e_p + 1 may leave int32 (signed int32 overflow is
// undefined here, and the JAX reference wraps and drops runs that start at
// INT32_MIN).  A value outside int32 lies in no run, so the membership
// test compares int32s once the value is known to fit.
//
// Design.  The TPU kernel broadcasts [8, P, P] compare masks per block of
// 8 actors, one grid step after another.  Here a block of 256 threads owns
// 256 candidates of one actor row (grid: rows x ceil(P / 256) chunks), so
// a single wide row -- the bigset path's tombstone is one actor of 2,000
// runs -- still spreads over many SMs.  Two launches:
//   pass 1 tests each candidate's four points (e, e + 1, s, s - 1) in one
//     walk over the row's runs, which every lane of a warp reads at the
//     same address (a broadcast), four runs between two exit tests and no
//     branch among them, so the loads overlap; it writes the candidate's
//     end value to a scratch row (int64, INT64_MAX for "not an end") and
//     parks a start in the candidate's own output slot (out_s = s, out_e =
//     1 marks a start);
//   pass 2 drops duplicate starts and gives each start the nearest end,
//     reading the whole scratch row.
// A block stages the row's runs as (start, end) int2 pairs -- and in pass
// 2 the scratch row -- in shared memory, 16 P bytes at most; a row too
// wide for a block's shared memory is read from global memory instead.
//
// Bound.  The merge reads 4 * A * R * 4 bytes and writes 2 * A * P * 4:
// 2 MiB at A = 512, Ra = Rb = 128 (0.63 us at 3.35 TB/s), 16 MiB at
// Ra = Rb = 1024 (5.0 us) and 64 KB at the tombstone's A = 1, Ra = Rb =
// 2000 (0.019 us).  The sweep does O(P^2) compares a row (four membership
// tests of up to P runs per candidate, P more for the duplicate test and P
// for the end), ~6 P^2: 2.0e8 at the first shape, 1.3e10 at the second,
// which is what the kernel's time follows; sorted rows would allow binary
// search and a linear merge, left for later.
//
// Popcount.  out[a] = sum_r max(e - s + 1, 0), with the span and the sum in
// int32 that wraps, as the plain version's int32 arithmetic does: computed
// in uint32 and cast back, so a run (0, 2^31 - 1) counts 0.  One warp per
// row, lanes strided over R, an xor-shuffle sum.  Bound: reads 2 * A * R *
// 4 bytes (0.5 MiB at A = 512, R = 128: 0.16 us).
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOr = 0, kAndNot = 1, kAnd = 2;

constexpr int kUnroll = 4;  // runs compared between two exit tests

__host__ __device__ constexpr int padded(int n) {
  return (n + kUnroll - 1) / kUnroll * kUnroll;
}

// One side's runs as (start, end) pairs.  Staged: int2s in shared memory,
// padded with empty (1, 0) runs to a multiple of kUnroll.  Global: the two
// int32 rows, read through the read-only cache, empty past the end.
struct SharedRuns {
  const int2* r;
  int n;
  __device__ __forceinline__ int2 at(int i) const { return r[i]; }
};
struct GlobalRuns {
  const int32_t* s;
  const int32_t* e;
  int n;
  __device__ __forceinline__ int2 at(int i) const {
    return i < n ? make_int2(__ldg(s + i), __ldg(e + i)) : make_int2(1, 0);
  }
};

__device__ __forceinline__ bool fits_int32(int64_t x) {
  return x >= INT32_MIN && x <= INT32_MAX;
}

// hit[k] = active[k] and x[k] lies inside one of the runs.  The K points
// walk the runs together, kUnroll runs at a time with no branch between
// them, and stop once every active point has been found.  An inactive
// point, or one outside int32 (which no run holds), is never tested.
template <int K, class Runs>
__device__ __forceinline__ void contains(const Runs& runs, const int64_t* x,
                                         const bool* active, bool* hit) {
  int32_t v[K];
  bool todo[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    todo[k] = active[k] && fits_int32(x[k]);
    v[k] = todo[k] ? static_cast<int32_t>(x[k]) : 0;
    hit[k] = false;
  }
  const int n = padded(runs.n);
  for (int r = 0; r < n; r += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int2 q = runs.at(r + u);
#pragma unroll
      for (int k = 0; k < K; ++k) hit[k] |= (q.x <= v[k]) & (v[k] <= q.y);
    }
    bool done = true;
#pragma unroll
    for (int k = 0; k < K; ++k) done &= hit[k] || !todo[k];
    if (done) break;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) hit[k] &= todo[k];
}

// live[k] = x[k] is live under mode M (x[k] tested only where active[k]).
// B's runs are walked only for the points whose answer they can change.
template <int M, int K, class Runs>
__device__ __forceinline__ void live(const Runs& a, const Runs& b,
                                     const int64_t* x, const bool* active,
                                     bool* out) {
  bool in_a[K], need_b[K], in_b[K];
  contains<K>(a, x, active, in_a);
#pragma unroll
  for (int k = 0; k < K; ++k) need_b[k] = M == kOr ? active[k] && !in_a[k]
                                                   : in_a[k];
  contains<K>(b, x, need_b, in_b);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    out[k] = M == kOr ? in_a[k] || in_b[k]
                      : in_a[k] && (M == kAnd ? in_b[k] : !in_b[k]);
  }
}

// Candidate p's start and end value, and whether its source run is valid.
template <int M, class Runs>
__device__ __forceinline__ bool candidate(const Runs& a, const Runs& b, int p,
                                          int64_t* s, int64_t* e) {
  if (p < a.n) {
    const int2 q = a.at(p);
    *s = q.x;
    *e = q.y;
    return q.x <= q.y;
  }
  const int2 q = b.at(p - a.n);
  if (M == kAndNot) {
    *s = static_cast<int64_t>(q.y) + 1;
    *e = static_cast<int64_t>(q.x) - 1;
  } else {
    *s = q.x;
    *e = q.y;
  }
  return q.x <= q.y;
}

// Pass 1 for candidate p of a row: tests e and e + 1 (does it end a run?)
// and s and s - 1 (does it start one?) in one walk; publishes the end value
// in ends[p] and parks the start in the candidate's own output slot.
template <int M, class Runs>
__device__ __forceinline__ void edges(const Runs& a, const Runs& b, int p,
                                      int64_t* ends, int32_t* os,
                                      int32_t* oe) {
  int64_t s, e;
  const bool valid = candidate<M>(a, b, p, &s, &e);
  const int64_t x[4] = {e, e + 1, s, s - 1};
  const bool active[4] = {valid, valid, valid, valid};
  bool l[4];
  live<M, 4>(a, b, x, active, l);
  ends[p] = l[0] && !l[1] ? e : INT64_MAX;
  const bool is_start = l[2] && !l[3];
  os[p] = is_start ? static_cast<int32_t>(s) : 1;
  oe[p] = is_start ? 1 : 0;
}

// Pass 2 for candidate p of a row: a start is kept unless an earlier
// candidate has the same start value -- two equal start values are equally
// live, so an earlier one starts a run exactly when its source run is
// valid -- and ends at the smallest end value >= it.
template <int M, class Runs>
__device__ __forceinline__ void pair_ends(const Runs& a, const Runs& b,
                                          int p, const int64_t* ends,
                                          int32_t* os, int32_t* oe) {
  if (oe[p] == 0) return;
  const int64_t s = os[p];
  bool first = true;
  for (int q = 0; first && q < p; ++q) {
    int64_t sq, eq;
    if (candidate<M>(a, b, q, &sq, &eq) && sq == s) first = false;
  }
  int64_t end = INT32_MAX;
  const int p_all = a.n + b.n;
  for (int q = 0; q < p_all; ++q) {
    const int64_t v = ends[q];
    end = v >= s && v < end ? v : end;
  }
  os[p] = first ? static_cast<int32_t>(s) : 1;
  oe[p] = first ? static_cast<int32_t>(end) : 0;
}

// Bytes of shared memory a staged block of pass 2 takes (pass 1 takes
// less): one int64 end value per candidate and both sides' runs as padded
// int2s.
__host__ __device__ constexpr size_t staged_bytes(int ra, int rb) {
  return 8 * static_cast<size_t>(ra + rb) +
         8 * static_cast<size_t>(padded(ra) + padded(rb));
}

// Copies a row's runs into shared memory as int2 pairs, padded with empty
// (1, 0) runs to a multiple of kUnroll.
__device__ __forceinline__ void stage(const int32_t* s, const int32_t* e,
                                      int n, int2* out) {
  for (int i = threadIdx.x; i < padded(n); i += kThreads) {
    out[i] = i < n ? make_int2(s[i], e[i]) : make_int2(1, 0);
  }
}

// Block (row, chunk) of either pass: candidates chunk * kThreads + tid of
// row `row`.  kPass 1 writes the scratch row `ends`, kPass 2 reads it.
template <int M, bool kStaged, int kPass>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const int32_t* __restrict__ a_s, const int32_t* __restrict__ a_e,
             const int32_t* __restrict__ b_s, const int32_t* __restrict__ b_e,
             int32_t* __restrict__ out_s, int32_t* __restrict__ out_e,
             int64_t* __restrict__ scratch, int ra, int rb) {
  const int64_t row = blockIdx.x;
  const int p_all = ra + rb;
  const int p = blockIdx.y * kThreads + threadIdx.x;
  a_s += row * ra;
  a_e += row * ra;
  b_s += row * rb;
  b_e += row * rb;
  int32_t* os = out_s + row * p_all;
  int32_t* oe = out_e + row * p_all;
  int64_t* ends = scratch + row * p_all;
  if (!kStaged) {
    const GlobalRuns a{a_s, a_e, ra}, b{b_s, b_e, rb};
    if (p >= p_all) return;
    if (kPass == 1) {
      edges<M>(a, b, p, ends, os, oe);
    } else {
      pair_ends<M>(a, b, p, ends, os, oe);
    }
    return;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  int2* runs_a = reinterpret_cast<int2*>(smem);
  int2* runs_b = runs_a + padded(ra);
  stage(a_s, a_e, ra, runs_a);
  stage(b_s, b_e, rb, runs_b);
  int64_t* ends_smem = reinterpret_cast<int64_t*>(runs_b + padded(rb));
  if (kPass == 2) {
    for (int i = threadIdx.x; i < p_all; i += kThreads) ends_smem[i] = ends[i];
  }
  __syncthreads();
  if (p >= p_all) return;
  const SharedRuns a{runs_a, ra}, b{runs_b, rb};
  if (kPass == 1) {
    edges<M>(a, b, p, ends, os, oe);
  } else {
    pair_ends<M>(a, b, p, ends_smem, os, oe);
  }
}

template <int M, bool kStaged, int kPass>
cudaError_t launch_pass(const int32_t* as, const int32_t* ae,
                        const int32_t* bs, const int32_t* be, int32_t* os,
                        int32_t* oe, int64_t* scratch, int n_actors, int ra,
                        int rb, cudaStream_t stream) {
  size_t smem = 0;
  if (kStaged) {
    smem = kPass == 1 ? 8 * static_cast<size_t>(padded(ra) + padded(rb))
                      : staged_bytes(ra, rb);
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_kernel<M, kStaged, kPass>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n_actors, (ra + rb + kThreads - 1) / kThreads);
  merge_kernel<M, kStaged, kPass><<<grid, kThreads, smem, stream>>>(
      as, ae, bs, be, os, oe, scratch, ra, rb);
  return cudaGetLastError();
}

template <int M, bool kStaged>
cudaError_t launch_merge(const int32_t* as, const int32_t* ae,
                         const int32_t* bs, const int32_t* be, int32_t* os,
                         int32_t* oe, int64_t* scratch, int n_actors, int ra,
                         int rb, cudaStream_t stream) {
  const cudaError_t err = launch_pass<M, kStaged, 1>(
      as, ae, bs, be, os, oe, scratch, n_actors, ra, rb, stream);
  if (err != cudaSuccess) return err;
  return launch_pass<M, kStaged, 2>(as, ae, bs, be, os, oe, scratch,
                                    n_actors, ra, rb, stream);
}

template <bool kStaged>
cudaError_t launch_mode(int mode, const int32_t* as, const int32_t* ae,
                        const int32_t* bs, const int32_t* be, int32_t* os,
                        int32_t* oe, int64_t* scratch, int n_actors, int ra,
                        int rb, cudaStream_t stream) {
  switch (mode) {
    case kOr:
      return launch_merge<kOr, kStaged>(as, ae, bs, be, os, oe, scratch,
                                        n_actors, ra, rb, stream);
    case kAndNot:
      return launch_merge<kAndNot, kStaged>(as, ae, bs, be, os, oe, scratch,
                                            n_actors, ra, rb, stream);
    case kAnd:
      return launch_merge<kAnd, kStaged>(as, ae, bs, be, os, oe, scratch,
                                         n_actors, ra, rb, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

__global__ void __launch_bounds__(kThreads)
popcount_kernel(const int32_t* __restrict__ starts,
                const int32_t* __restrict__ ends, int32_t* __restrict__ out,
                int n_actors, int n_runs) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (row >= n_actors) return;  // a whole warp leaves together
  const int32_t* s = starts + row * n_runs;
  const int32_t* e = ends + row * n_runs;
  uint32_t acc = 0;
  for (int r = lane; r < n_runs; r += 32) {
    const uint32_t span = static_cast<uint32_t>(__ldg(e + r)) -
                          static_cast<uint32_t>(__ldg(s + r)) + 1u;
    acc += static_cast<int32_t>(span) > 0 ? span : 0u;
  }
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) out[row] = static_cast<int32_t>(acc);
}

}  // namespace

// The merge's route for rows of Ra + Rb runs on `device`: 1 when a row
// fits a block's shared memory (staged), 0 when it does not (the runs are
// read from global memory), or the negated CUDA error.
extern "C" int clock_merge_route(int ra, int rb, int device) {
  int limit = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return staged_bytes(ra, rb) <= static_cast<size_t>(limit) ? 1 : 0;
}

// Merge on `stream` of `device` (two launches); returns cudaGetLastError()
// (0 on success).  mode: 0 or, 1 andnot, 2 and.  a_* are int32[A, Ra],
// b_* int32[A, Rb], out_* int32[A, Ra + Rb] and scratch int64[A, Ra + Rb],
// all contiguous device pointers.
extern "C" int clock_merge_launch(const void* a_s, const void* a_e,
                                  const void* b_s, const void* b_e,
                                  void* out_s, void* out_e, void* scratch,
                                  int n_actors, int ra, int rb, int mode,
                                  int device, void* stream) {
  if (n_actors <= 0 || ra + rb <= 0) return static_cast<int>(cudaSuccess);
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int staged = clock_merge_route(ra, rb, device);
  if (staged < 0) return -staged;
  const auto* as = static_cast<const int32_t*>(a_s);
  const auto* ae = static_cast<const int32_t*>(a_e);
  const auto* bs = static_cast<const int32_t*>(b_s);
  const auto* be = static_cast<const int32_t*>(b_e);
  auto* os = static_cast<int32_t*>(out_s);
  auto* oe = static_cast<int32_t*>(out_e);
  auto* sc = static_cast<int64_t*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      staged ? launch_mode<true>(mode, as, ae, bs, be, os, oe, sc, n_actors,
                                 ra, rb, st)
             : launch_mode<false>(mode, as, ae, bs, be, os, oe, sc, n_actors,
                                  ra, rb, st);
  return static_cast<int>(err);
}

// Popcount on `stream`; returns cudaGetLastError().  starts/ends are
// int32[A, R], out int32[A].
extern "C" int clock_popcount_launch(const void* starts, const void* ends,
                                     void* out, int n_actors, int n_runs,
                                     void* stream) {
  if (n_actors <= 0) return static_cast<int>(cudaSuccess);
  constexpr int kRowsPerBlock = kThreads / 32;
  const int blocks = (n_actors + kRowsPerBlock - 1) / kRowsPerBlock;
  popcount_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(ends),
      static_cast<int32_t*>(out), n_actors, n_runs);
  return static_cast<int>(cudaGetLastError());
}
