// Interval clock-lattice kernels, for Hopper (sm_90a): the run merge (join /
// subtract / intersect) as one sorted pass that writes canonical rows, and
// the run-length popcount, over the int32[A, R] run arrays of a dense
// interval clock.
//
// Replaces the Pallas TPU kernels repro/kernels/clock_ops/kernel.py:
// join_pallas, subtract_pallas and intersect_pallas (-> _merge_op ->
// _merge_kernel), and popcount_pallas (-> _popcount_kernel).
//
// Merge.  A counter is live under the mode's predicate over (in A, in B) --
// or: a | b, andnot: a & !b, and: a & b.  The result is a function of the
// two sets alone: its row is the sorted maximal runs of the live counters,
// padded with (1, 0) to P = Ra + Rb slots, which is what the plain version
// (repro_torch.core.vclock._interval_merge) gives once its unsorted slots
// are sorted (sort_runs).  This kernel writes that canonical row directly,
// in one launch, one block per actor row:
//
//   1. stage each side's starts and ends and test, block-wide, whether
//      its valid runs (s <= e) come first, sorted by start and disjoint
//      (s_i > e_{i-1}).  Rows built by from_clock and every merge's output
//      pass, so on the bigset path this is the whole of step 1.  A side
//      that fails is sorted (a bitonic sort keyed on the start, empty slots
//      last) and its overlapping runs coalesced (a block prefix max of the
//      ends, a block scan of the run heads, a compaction);
//   2. each run's start is placed in the other side by a binary search
//      (O(log R)) and its end by a galloping search from there (one load
//      when no run of the other side starts in between); the edge's own
//      run gives its place in its own side.  That gives "is x live" and
//      "is x -/+ 1 live", so whether the edge starts or ends an output
//      run, and its place among the other side's candidates of its kind,
//      kept for step 3.  Candidate starts are A's starts and B's starts
//      (andnot: b_e + 1); candidate ends are A's ends and B's ends
//      (andnot: b_s - 1).  A value both sides offer counts once, as A's.
//      Edges and their neighbours are int64, so nothing wraps at the int32
//      edges (the JAX reference wraps at INT32_MIN, ROADMAP C8);
//   3. an output start's slot is the number of output starts below it: a
//      block exclusive scan of the start flags on its own side, plus the
//      scan of the other side's flags at its place from step 2.  Ends are
//      ranked the same way, and the k-th start pairs with the k-th end.
//      Slots [n, P) get (1, 0).
//
// A block keeps a row's workspace -- both sides' starts and ends, the four
// flag scans and the places, 24 P + 16 bytes, all int arrays, so a search's
// lanes spread over all 32 banks -- in shared memory; a row too wide for a
// block's shared memory runs the same code on a workspace the wrapper
// allocates in global memory.
//
// Bound.  The merge reads 4 * A * R * 4 bytes and writes 2 * A * P * 4:
// 64 KB at the tombstone's A = 1, Ra = Rb = 2000 (0.019 us at 3.35 TB/s),
// 2 MiB at A = 512, Ra = Rb = 128 (0.63 us), 16 MiB at Ra = Rb = 1024
// (5.0 us).  On sorted rows it does O(P log P) compares a row, one binary
// search an input run, where the two-pass sweep it replaces did ~6 P^2; at
// A = 1 one block on one SM does it, so the time follows the searches'
// shared-memory latency and the block's barriers, not bytes.
//
// Popcount.  out[a] = sum_r max(e - s + 1, 0), with the span and the sum in
// int32 that wraps, as the plain version's int32 arithmetic does: computed
// in uint32 and cast back, so a run (0, 2^31 - 1) counts 0.  A group of G
// threads (a power of two, R / 4 up to 1,024) sums a row, each thread one
// 16-byte load of each array (four runs a load): a long row gets a block
// of its own and short rows share a block of 256 threads by groups of
// lanes.  Rows that start on 16 bytes are read by 16-byte loads; the head
// and tail, and rows whose starts and ends lie differently against 16
// bytes, by scalar loads in the same pass.  Rows past 4,096 runs loop,
// unrolled four times.  Groups combine by warp shuffles, then in shared
// memory.  The code a thread runs is kept short: at the small shapes a
// launch costs little more than fetching its instructions.  Bound: reads
// 2 * A * R * 4 bytes (16 KB at the tombstone's row: 0.0048 us).
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kOr = 0, kAndNot = 1, kAnd = 2;
constexpr int kMaxThreads = 1024;
// Static shared memory a merge block takes beside its staged row, rounded
// up: the scan's warp totals (32 x 16 bytes) and two counts.
constexpr int kStaticBytes = 1024;

// ------------------------------------------------------------ block scan
template <int K>
struct Ints {
  int v[K];
};

struct Sum {
  __device__ __forceinline__ static int id() { return 0; }
  __device__ __forceinline__ static int op(int a, int b) { return a + b; }
};

struct Max {
  __device__ __forceinline__ static int id() { return INT_MIN; }
  __device__ __forceinline__ static int op(int a, int b) {
    return a > b ? a : b;
  }
};

// K int arrays scanned together: p[k][0, n[k]).
template <int K>
struct Arrays {
  int* p[K];
  int n[K];
};

template <int K, class Op>
__device__ __forceinline__ Ints<K> combine(Ints<K> a, const Ints<K>& b) {
#pragma unroll
  for (int k = 0; k < K; ++k) a.v[k] = Op::op(a.v[k], b.v[k]);
  return a;
}

template <int K, class Op>
__device__ __forceinline__ Ints<K> identity() {
  Ints<K> x;
#pragma unroll
  for (int k = 0; k < K; ++k) x.v[k] = Op::id();
  return x;
}

template <int K, class Op>
__device__ __forceinline__ Ints<K> warp_inclusive(Ints<K> x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int y = __shfl_up_sync(0xffffffffu, x.v[k], d);
      if (lane >= d) x.v[k] = Op::op(x.v[k], y);
    }
  }
  return x;
}

// Scans the K arrays in place by Op, chunk by chunk of blockDim.x: an
// exclusive scan writes p[k][i] = Op over [0, i) and p[k][n[k]] = Op over
// all of it; an inclusive one p[k][i] = Op over [0, i].  Every thread of
// the block calls it, after a barrier that publishes the arrays; it ends
// on a barrier.  `totals` is 32 entries of shared memory.
template <int K, bool kExclusive, class Op>
__device__ void block_scan(const Arrays<K>& x, Ints<K>* totals) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int n = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) n = x.n[k] > n ? x.n[k] : n;
  Ints<K> carry = identity<K, Op>();
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    Ints<K> v;
#pragma unroll
    for (int k = 0; k < K; ++k) v.v[k] = i < x.n[k] ? x.p[k][i] : Op::id();
    const Ints<K> inc = warp_inclusive<K, Op>(v);
    Ints<K> mine = inc;
    if (kExclusive) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int y = __shfl_up_sync(0xffffffffu, inc.v[k], 1);
        mine.v[k] = lane == 0 ? Op::id() : y;
      }
    }
    if (lane == 31) totals[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      Ints<K> t = lane < n_warps ? totals[lane] : identity<K, Op>();
      totals[lane] = warp_inclusive<K, Op>(t);
    }
    __syncthreads();
    Ints<K> before = carry;
    if (warp > 0) before = combine<K, Op>(before, totals[warp - 1]);
    mine = combine<K, Op>(before, mine);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (i < x.n[k]) x.p[k][i] = mine.v[k];
    }
    carry = combine<K, Op>(carry, totals[n_warps - 1]);
    __syncthreads();
  }
  if (kExclusive && threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) x.p[k][x.n[k]] = carry.v[k];
  }
  __syncthreads();
}

// ------------------------------------------------------------ one side
__device__ __forceinline__ int highest_pow2(int n) {
  return n > 0 ? 1 << (31 - __clz(n)) : 0;
}

// One side's runs, sorted by start and disjoint, as two int arrays.  k below
// is always "the number of runs whose start is <= x" for the x in question,
// so run k - 1 is the only one that can hold x.
struct Runs {
  const int* s;
  const int* e;
  int n;

  // k for x, by binary search
  __device__ __forceinline__ int upto(int64_t x) const {
    int k = 0;
    for (int step = highest_pow2(n); step > 0; step >>= 1) {
      if (k + step <= n && s[k + step - 1] <= x) k += step;
    }
    return k;
  }
  // k for x, given k0, the k of a value <= x: a galloping search from k0,
  // one load when no start lies in between
  __device__ __forceinline__ int upto_from(int k0, int64_t x) const {
    int k = k0, step = 1;
    while (k + step <= n && s[k + step - 1] <= x) {
      k += step;
      step <<= 1;
    }
    for (step >>= 1; step > 0; step >>= 1) {
      if (k + step <= n && s[k + step - 1] <= x) k += step;
    }
    return k;
  }
  __device__ __forceinline__ bool starts_at(int k, int64_t x) const {
    return k > 0 && s[k - 1] == x;
  }
  __device__ __forceinline__ bool ends_at(int k, int64_t x) const {
    return k > 0 && e[k - 1] == x;
  }
  __device__ __forceinline__ bool holds(int k, int64_t x) const {
    return k > 0 && x <= e[k - 1];
  }
  // is x - 1 held?  (the k of x - 1 is k, or k - 1 when a run starts at x)
  __device__ __forceinline__ bool holds_prev(int k, int64_t x) const {
    return holds(k - starts_at(k, x), x - 1);
  }
  // is x + 1 held?
  __device__ __forceinline__ bool holds_next(int k, int64_t x) const {
    return holds(k + (k < n && s[k] == x + 1), x + 1);
  }
  // the number of starts < x, and of ends < x
  __device__ __forceinline__ int starts_below(int k, int64_t x) const {
    return k - starts_at(k, x);
  }
  __device__ __forceinline__ int ends_below(int k, int64_t x) const {
    return k > 0 ? k - 1 + (e[k - 1] < x) : 0;
  }
};

__device__ __forceinline__ int64_t sort_key(int s, int e) {
  return s <= e ? static_cast<int64_t>(s) : INT64_MAX;
}

// Sorts the runs (s, e)[0, n) by sort_key, ascending: the bitonic network in
// the form whose comparators all put the smaller key low (the first step of
// each merge compares mirrored pairs), padded to a power of two with virtual
// keys above every real one, so a comparator that reaches past n is
// skipped.
__device__ void bitonic_sort(int* s, int* e, int n) {
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < n2 / 2; t += blockDim.x) {
        const int lo = 2 * j * (t / j) + t % j;
        const int hi = j == k >> 1 ? lo ^ (k - 1) : lo + j;
        if (hi < n) {
          const int ls = s[lo], le = e[lo], hs = s[hi], he = e[hi];
          if (sort_key(ls, le) > sort_key(hs, he)) {
            s[lo] = hs;
            e[lo] = he;
            s[hi] = ls;
            e[hi] = le;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Brings a side that is not sorted and disjoint to sorted, disjoint runs in
// (s, e)[0, m) and returns m.  t1 and t2 (n + 1 ints each) are scratch: t1
// the prefix max of the ends, t2 the exclusive count of run heads (a run
// that starts past every earlier end).  n_valid runs are valid.  Not
// inlined: both sides run one copy of the code, which the second finds in
// the instruction cache.
__device__ __noinline__ int canonicalise(int* s, int* e, int n, int n_valid,
                                        int* t1, int* t2, Ints<1>* totals) {
  bitonic_sort(s, e, n);
  for (int i = threadIdx.x; i < n_valid; i += blockDim.x) t1[i] = e[i];
  __syncthreads();
  block_scan<1, false, Max>(Arrays<1>{{t1}, {n_valid}}, totals);
  for (int i = threadIdx.x; i < n_valid; i += blockDim.x) {
    t2[i] = i == 0 || s[i] > t1[i - 1];
  }
  __syncthreads();
  block_scan<1, true, Sum>(Arrays<1>{{t2}, {n_valid}}, totals);
  // run i moves to slot g <= i; a chunk reads all its runs before any of
  // its threads writes, and no write reaches a later chunk
  for (int base = 0; base < n_valid; base += blockDim.x) {
    const int i = base + threadIdx.x;
    int start = 0, end = 0, g = 0;
    bool head = false, last = false;
    if (i < n_valid) {
      start = s[i];
      end = t1[i];
      g = t2[i + 1] - 1;
      head = t2[i + 1] != t2[i];
      last = i + 1 == n_valid || t2[i + 2] != t2[i + 1];
    }
    __syncthreads();
    if (head) s[g] = start;
    if (last) e[g] = end;
    __syncthreads();
  }
  return t2[n_valid];
}

// ------------------------------------------------------------ the merge
template <int M>
__device__ __forceinline__ bool live(bool in_a, bool in_b) {
  return M == kOr ? in_a || in_b : M == kAnd ? in_a && in_b : in_a && !in_b;
}

// x (in A at place ka, in B at place kb) starts an output run.
template <int M>
__device__ __forceinline__ bool starts_run(const Runs& a, const Runs& b,
                                           int64_t x, int ka, int kb) {
  return live<M>(a.holds(ka, x), b.holds(kb, x)) &&
         !live<M>(a.holds_prev(ka, x), b.holds_prev(kb, x));
}

// x (in A at place ka, in B at place kb) ends an output run.
template <int M>
__device__ __forceinline__ bool ends_run(const Runs& a, const Runs& b,
                                         int64_t x, int ka, int kb) {
  return live<M>(a.holds(ka, x), b.holds(kb, x)) &&
         !live<M>(a.holds_next(ka, x), b.holds_next(kb, x));
}

// B's candidate start and end of run j: its edges, or for andnot the
// counters just past them.
template <int M>
__device__ __forceinline__ int64_t b_start(const Runs& b, int j) {
  return M == kAndNot ? static_cast<int64_t>(b.e[j]) + 1 : b.s[j];
}
template <int M>
__device__ __forceinline__ int64_t b_end(const Runs& b, int j) {
  return M == kAndNot ? static_cast<int64_t>(b.s[j]) - 1 : b.e[j];
}

// A row's workspace, all int arrays: each side's starts and ends; the
// exclusive scans of each side's start and end flags (R + 1 each); and each
// flagged edge's place among the other side's candidates of its kind.
struct Workspace {
  int *as, *ae, *bs, *be;
  int *fas, *fae, *fbs, *fbe;
  int *pas, *pae, *pbs, *pbe;
};

__host__ __device__ constexpr size_t workspace_bytes(int ra, int rb) {
  return (4 * (6 * static_cast<size_t>(ra + rb) + 4) + 15) / 16 * 16;
}

__device__ __forceinline__ Workspace carve(unsigned char* base, int ra,
                                           int rb) {
  Workspace w;
  w.as = reinterpret_cast<int*>(base);
  w.ae = w.as + ra;
  w.bs = w.ae + ra;
  w.be = w.bs + rb;
  w.fas = w.be + rb;
  w.fae = w.fas + ra + 1;
  w.fbs = w.fae + ra + 1;
  w.fbe = w.fbs + rb + 1;
  w.pas = w.fbe + rb + 1;
  w.pae = w.pas + ra;
  w.pbs = w.pae + ra;
  w.pbe = w.pbs + rb;
  return w;
}

// Copies run i of a side (s, e) into (os, oe); returns whether it keeps the
// side sorted and disjoint: an empty run, or a valid one after a valid run
// that ends below its start.  Counts a valid run into *valid.
__device__ __forceinline__ bool stage_one(const int32_t* __restrict__ s,
                                          const int32_t* __restrict__ e,
                                          int i, int* os, int* oe,
                                          int* valid) {
  const int qs = __ldg(s + i), qe = __ldg(e + i);
  const int j = i > 0 ? i - 1 : 0;
  const int ps = __ldg(s + j), pe = __ldg(e + j);
  os[i] = qs;
  oe[i] = qe;
  if (qs > qe) return true;
  ++*valid;
  return i == 0 || (ps <= pe && qs > pe);
}

// One block per actor row; kStaged keeps the row's workspace in shared
// memory, else in `scratch` (workspace_bytes a row).
template <int M, bool kStaged>
__global__ void __launch_bounds__(kMaxThreads)
clock_merge_kernel(const int32_t* __restrict__ a_s,
                   const int32_t* __restrict__ a_e,
                   const int32_t* __restrict__ b_s,
                   const int32_t* __restrict__ b_e,
                   int32_t* __restrict__ out_s, int32_t* __restrict__ out_e,
                   unsigned char* scratch, int ra, int rb) {
  __shared__ Ints<4> totals[32];
  __shared__ int counts[2], unsorted[2];
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t row = blockIdx.x;
  const int p_all = ra + rb;
  unsigned char* base =
      kStaged ? smem : scratch + row * workspace_bytes(ra, rb);
  const Workspace w = carve(base, ra, rb);
  a_s += row * ra;
  a_e += row * ra;
  b_s += row * rb;
  b_e += row * rb;
  out_s += row * p_all;
  out_e += row * p_all;
  if (threadIdx.x < 2) counts[threadIdx.x] = unsorted[threadIdx.x] = 0;
  __syncthreads();

  // 1. each side to sorted, disjoint runs
  int valid_a = 0, valid_b = 0;
  bool ok_a = true, ok_b = true;
  const int r_max = ra > rb ? ra : rb;
  for (int i = threadIdx.x; i < r_max; i += blockDim.x) {
    if (i < ra) ok_a &= stage_one(a_s, a_e, i, w.as, w.ae, &valid_a);
    if (i < rb) ok_b &= stage_one(b_s, b_e, i, w.bs, w.be, &valid_b);
  }
  if (valid_a) atomicAdd(&counts[0], valid_a);
  if (valid_b) atomicAdd(&counts[1], valid_b);
  if (!ok_a) unsorted[0] = 1;
  if (!ok_b) unsorted[1] = 1;
  __syncthreads();
  int na = counts[0], nb = counts[1];
  auto* totals1 = reinterpret_cast<Ints<1>*>(totals);
  if (unsorted[0]) {
    na = canonicalise(w.as, w.ae, ra, na, w.fas, w.fae, totals1);
  }
  if (unsorted[1]) {
    nb = canonicalise(w.bs, w.be, rb, nb, w.fbs, w.fbe, totals1);
  }
  const Runs a{w.as, w.ae, na}, b{w.bs, w.be, nb};

  // 2. flag the edges that start or end an output run, and place each
  // among the other side's candidates of its kind
  for (int i = threadIdx.x; i < na; i += blockDim.x) {
    const int64_t s = a.s[i], e = a.e[i];
    const int kbs = b.upto(s), kbe = b.upto_from(kbs, e);
    w.fas[i] = starts_run<M>(a, b, s, i + 1, kbs);
    w.fae[i] = ends_run<M>(a, b, e, i + 1, kbe);
    if (M == kAndNot) {
      // B's starts are b_e + 1 < s, that is b_e < s - 1; its ends b_s - 1
      // < e, that is b_s <= e
      w.pas[i] = b.ends_below(kbs - b.starts_at(kbs, s), s - 1);
      w.pae[i] = kbe;
    } else {
      w.pas[i] = b.starts_below(kbs, s);
      w.pae[i] = b.ends_below(kbe, e);
    }
  }
  for (int j = threadIdx.x; j < nb; j += blockDim.x) {
    const int64_t s = b_start<M>(b, j), e = b_end<M>(b, j);
    // B's own places: run j; for andnot b_e + 1 also passes the next run
    // where it starts there, and b_s - 1 only the runs before j
    const int kbs = M == kAndNot ? j + 1 + (j + 1 < nb && b.s[j + 1] == s)
                                 : j + 1;
    const int kbe = M == kAndNot ? j : j + 1;
    // for andnot e < s
    int kas, kae;
    if (M == kAndNot) {
      kae = a.upto(e);
      kas = a.upto_from(kae, s);
    } else {
      kas = a.upto(s);
      kae = a.upto_from(kas, e);
    }
    w.fbs[j] = starts_run<M>(a, b, s, kas, kbs) && !a.starts_at(kas, s);
    w.fbe[j] = ends_run<M>(a, b, e, kae, kbe) && !a.ends_at(kae, e);
    w.pbs[j] = a.starts_below(kas, s);
    w.pbe[j] = a.ends_below(kae, e);
  }
  __syncthreads();
  block_scan<4, true, Sum>(
      Arrays<4>{{w.fas, w.fae, w.fbs, w.fbe}, {na, na, nb, nb}}, totals);

  // 3. an edge's slot: the flagged edges of its kind below it on both
  // sides; the k-th start and the k-th end make the k-th run
  for (int i = threadIdx.x; i < na; i += blockDim.x) {
    if (w.fas[i + 1] != w.fas[i]) out_s[w.fas[i] + w.fbs[w.pas[i]]] = a.s[i];
    if (w.fae[i + 1] != w.fae[i]) out_e[w.fae[i] + w.fbe[w.pae[i]]] = a.e[i];
  }
  for (int j = threadIdx.x; j < nb; j += blockDim.x) {
    if (w.fbs[j + 1] != w.fbs[j]) {
      out_s[w.fbs[j] + w.fas[w.pbs[j]]] =
          static_cast<int32_t>(b_start<M>(b, j));
    }
    if (w.fbe[j + 1] != w.fbe[j]) {
      out_e[w.fbe[j] + w.fae[w.pbe[j]]] = static_cast<int32_t>(b_end<M>(b, j));
    }
  }
  for (int p = w.fas[na] + w.fbs[nb] + threadIdx.x; p < p_all;
       p += blockDim.x) {
    out_s[p] = 1;
    out_e[p] = 0;
  }
}

int merge_threads(int ra, int rb) {
  const int r = ra > rb ? ra : rb;
  const int t = (r + 31) / 32 * 32;
  return t < 64 ? 64 : t > kMaxThreads ? kMaxThreads : t;
}

template <int M, bool kStaged>
cudaError_t launch_merge(const int32_t* as, const int32_t* ae,
                         const int32_t* bs, const int32_t* be, int32_t* os,
                         int32_t* oe, unsigned char* scratch, int n_actors,
                         int ra, int rb, cudaStream_t stream) {
  const size_t smem = kStaged ? workspace_bytes(ra, rb) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        clock_merge_kernel<M, kStaged>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  clock_merge_kernel<M, kStaged>
      <<<n_actors, merge_threads(ra, rb), smem, stream>>>(
          as, ae, bs, be, os, oe, scratch, ra, rb);
  return cudaGetLastError();
}

template <bool kStaged>
cudaError_t launch_mode(int mode, const int32_t* as, const int32_t* ae,
                        const int32_t* bs, const int32_t* be, int32_t* os,
                        int32_t* oe, unsigned char* scratch, int n_actors,
                        int ra, int rb, cudaStream_t stream) {
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

// ------------------------------------------------------------ popcount

__device__ __forceinline__ uint32_t span(int32_t s, int32_t e) {
  const uint32_t n = static_cast<uint32_t>(e) - static_cast<uint32_t>(s) + 1u;
  return static_cast<int32_t>(n) > 0 ? n : 0u;
}

__device__ __forceinline__ uint32_t span4(int4 s, int4 e) {
  return span(s.x, e.x) + span(s.y, e.y) + span(s.z, e.z) + span(s.w, e.w);
}

// A group of 2^lg_group threads per row, blockDim.x >> lg_group rows a
// block.  kAligned: every row starts on 16 bytes and holds a multiple of
// four runs (the host checks the two base pointers and R), so a row is all
// 16-byte loads; else each row finds its own 16-byte span.  A pass of the
// loop issues all its loads before it sums.
template <bool kAligned>
__global__ void __launch_bounds__(kMaxThreads)
clock_popcount_kernel(const int32_t* __restrict__ starts,
                      const int32_t* __restrict__ ends,
                      int32_t* __restrict__ out, int n_actors, int n_runs,
                      int lg_group) {
  __shared__ uint32_t warp_sums[kMaxThreads / 32];
  const int group = 1 << lg_group;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x >> lg_group) +
      (threadIdx.x >> lg_group);
  const int g = threadIdx.x & (group - 1);
  uint32_t acc = 0;
  if (row < n_actors) {
    const int32_t* s = starts + row * n_runs;
    const int32_t* e = ends + row * n_runs;
    // n4 16-byte loads over runs [head, tail); scalar loads for [0, head)
    // and [tail, n_runs)
    int head = 0, n4 = n_runs >> 2;
    if (!kAligned) {
      const uintptr_t off = reinterpret_cast<uintptr_t>(s) & 15;
      head = n_runs;
      n4 = 0;
      if (off == (reinterpret_cast<uintptr_t>(e) & 15)) {
        head = static_cast<int>((16 - off) & 15) >> 2;
        head = head < n_runs ? head : n_runs;
        n4 = (n_runs - head) >> 2;
      }
    }
    const int tail = head + 4 * n4;
    const int n_scalar = kAligned ? 0 : n_runs - 4 * n4;
    const int4* s4 = reinterpret_cast<const int4*>(s + head);
    const int4* e4 = reinterpret_cast<const int4*>(e + head);
    const int steps = n4 > n_scalar ? n4 : n_scalar;
    // one pass for rows of up to 4 * 1,024 runs; for longer rows the loop,
    // unrolled, issues the loads of four passes before their sums
#pragma unroll 4
    for (int v = g; v < steps; v += group) {
      const int r = v < head ? v : tail + v - head;
      const int4 qs = v < n4 ? __ldg(s4 + v) : make_int4(1, 1, 1, 1);
      const int4 qe = v < n4 ? __ldg(e4 + v) : make_int4(0, 0, 0, 0);
      const int32_t ss = !kAligned && v < n_scalar ? __ldg(s + r) : 1;
      const int32_t se = !kAligned && v < n_scalar ? __ldg(e + r) : 0;
      acc += span4(qs, qe) + span(ss, se);
    }
  }
  const int width = group < 32 ? group : 32;
  for (int o = width >> 1; o > 0; o >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  }
  if (group > 32) {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) warp_sums[warp] = acc;
    __syncthreads();
    if (g == 0) {
      for (int w = 1; w < group >> 5; ++w) acc += warp_sums[warp + w];
    }
  }
  if (g == 0 && row < n_actors) out[row] = static_cast<int32_t>(acc);
}

// log2 of the threads per row: one 16-byte load of each array a thread,
// up to 1,024 threads.
int popcount_lg_group(int n_runs) {
  int lg = 0;
  while ((1 << lg) < kMaxThreads && 4L * (1 << lg) < n_runs) ++lg;
  return lg;
}

}  // namespace

// Bytes of workspace a row of Ra + Rb runs takes (in shared memory on the
// staged route, in the wrapper's scratch otherwise).
extern "C" long long clock_merge_workspace_bytes(int ra, int rb) {
  return static_cast<long long>(workspace_bytes(ra, rb));
}

// The merge's route for rows of Ra + Rb runs on `device`: 1 when a row
// fits a block's shared memory (staged), 0 when it does not (its workspace
// is the wrapper's scratch in global memory), or the negated CUDA error.
extern "C" int clock_merge_route(int ra, int rb, int device) {
  int limit = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return workspace_bytes(ra, rb) + kStaticBytes <= static_cast<size_t>(limit)
             ? 1 : 0;
}

// Merge on `stream` of `device` (one launch); returns cudaGetLastError()
// (0 on success).  mode: 0 or, 1 andnot, 2 and.  a_* are int32[A, Ra],
// b_* int32[A, Rb], out_* int32[A, Ra + Rb], all contiguous device
// pointers; scratch holds A * clock_merge_workspace_bytes(Ra, Rb) bytes
// when the route is global and may be null when it is staged.
extern "C" int clock_merge_launch(const void* a_s, const void* a_e,
                                  const void* b_s, const void* b_e,
                                  void* out_s, void* out_e, void* scratch,
                                  int n_actors, int ra, int rb, int mode,
                                  int device, void* stream) {
  if (n_actors <= 0 || ra + rb <= 0) return static_cast<int>(cudaSuccess);
  const int staged = clock_merge_route(ra, rb, device);
  if (staged < 0) return -staged;
  if (!staged && scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* as = static_cast<const int32_t*>(a_s);
  const auto* ae = static_cast<const int32_t*>(a_e);
  const auto* bs = static_cast<const int32_t*>(b_s);
  const auto* be = static_cast<const int32_t*>(b_e);
  auto* os = static_cast<int32_t*>(out_s);
  auto* oe = static_cast<int32_t*>(out_e);
  auto* sc = static_cast<unsigned char*>(scratch);
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
  const int lg_group = popcount_lg_group(n_runs);
  const int threads = 1 << (lg_group > 8 ? lg_group : 8);
  const int rows_per_block = threads >> lg_group;
  const int blocks = (n_actors + rows_per_block - 1) / rows_per_block;
  const auto* s = static_cast<const int32_t*>(starts);
  const auto* e = static_cast<const int32_t*>(ends);
  auto* o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const bool aligned = ((reinterpret_cast<uintptr_t>(s) |
                         reinterpret_cast<uintptr_t>(e)) & 15) == 0 &&
                       n_runs % 4 == 0;
  if (aligned) {
    clock_popcount_kernel<true><<<blocks, threads, 0, st>>>(
        s, e, o, n_actors, n_runs, lg_group);
  } else {
    clock_popcount_kernel<false><<<blocks, threads, 0, st>>>(
        s, e, o, n_actors, n_runs, lg_group);
  }
  return static_cast<int>(cudaGetLastError());
}
