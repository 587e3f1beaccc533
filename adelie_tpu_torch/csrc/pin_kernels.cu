// Covariance-form lasso pin-solve kernels for Hopper (sm_90a).
//
// Two kernels, each templated on float and double (the H100 has native
// FP64), with a plain C interface loaded by ctypes from
// adelie_tpu_torch/solver/pin_kernels.py: K1 solves at S <= 1024, K2 above.
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().
//
// Both kernels run Gauss-Seidel coordinate descent on the screen Gram A
// (S x S, symmetric, row-major): update i needs the gradient that every
// earlier update left behind, so one solve is one serial chain of scalar
// updates, each followed by a row AXPY  grad -= delta * A[i, :].  That chain
// is the design constraint: ONE THREAD BLOCK PER SOLVE, on one SM.  Per
// update the block reads one row of A, which a producer warp has copied
// into shared memory ahead of the chain, and crosses one barrier; nothing
// else is O(S).  Both kernels take the screen's slot buffers as they are
// and walk lists of positions built by a block prefix sum.  K2's notes come
// first; K1 is K2's design at S <= 1024.  The scalar results of an update
// (delta, its rsq and convergence terms) go through a double-buffered slot
// in shared memory, so a single barrier per update orders both the
// broadcast and the reuse of the slot two updates later.
//
// The update contract (both kernels) is the guarded soft threshold
//     u  = g_i + a_ii b_i
//     b' = sign(u) max(|u| - l1 p_i, 0) / (a_ii + l2 p_i)   if a_ii + l2 p_i > 0
//     b' = b_i                                              otherwise
// followed by  grad -= (b' - b_i) A[i, :],
//              rsq  += d (2 g_i - d a_ii),  convg = max(convg, a_ii d^2).

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstddef>
#include <cstdint>

#include "async_copy.cuh"

namespace {

template <typename T> struct Eps;
template <> struct Eps<float> {
  static __device__ __forceinline__ float value() { return FLT_EPSILON; }
};
template <> struct Eps<double> {
  static __device__ __forceinline__ double value() { return DBL_EPSILON; }
};

// max that propagates NaN (fmax drops it), as jnp.maximum does
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  if (a != a || b != b) return a + b;
  return a > b ? a : b;
}

template <typename T>
__device__ __forceinline__ T sign_of(T u) {
  if (u != u) return u;
  return u > T(0) ? T(1) : (u < T(0) ? T(-1) : T(0));
}

template <typename T>
__device__ __forceinline__ T soft_update(T b, T g, T akk, T pk, T l1, T l2) {
  const T u = g + akk * b;
  const T mag = nan_max(fabs(u) - l1 * pk, T(0));
  const T den = akk + l2 * pk;
  return den > T(0) ? sign_of(u) * mag / den : b;
}

// ------------------------------------------------------------------------ //
// K2: pin_lasso_solve_rows                                                 //
// ------------------------------------------------------------------------ //
//
// Replaces adelie_tpu/solver/pin_pallas.py:cd_sweep_rows_pallas
// (_cd_sweep_rows_kernel, one Gauss-Seidel pass over a list of updates
// with the Gram in HBM) together with the loop around it in
// adelie_tpu/solver/pin.py:pin_cov_solve: the whole q = 1 pin solve at one
// lambda for S > 1024, in one launch.  The active phase compacts
// is_active & valid into an ascending list once and sweeps it (at least
// once, then until convg < tol_f, a floor-gated stall or max_iters); the
// filtered full sweep proposes a soft threshold at the sweep-entry gradient
// for every valid slot and runs the sequential pass over the slots whose
// proposal differs from beta; both repeat until a full sweep's
// convg < tol_f.  Moved slots of a full sweep become active.  Lists are
// built by a block-wide prefix sum (warp ballots), into shared memory when
// it leaves room for a ring of two whole rows, else into a global scratch
// buffer, so any S runs.
//
// What bounds it here: the serial chain, not bytes.  Every update needs the
// gradient the update before it left, so one solve is one block, and each
// update costs one barrier (the delta's broadcast through a double-buffered
// shared slot) plus a row of A.  Read after the barrier, that row would put
// a full L2/HBM latency on the chain for every update; so the list of a
// pass, known before the pass begins, drives a ring of rows in shared
// memory, the TPU kernel's row DMA ring done Hopper's way: a producer warp,
// outside the consumers' barrier, issues one bulk copy (TMA) a row into
// the next free slot, completing on the slot's "full" mbarrier, and
// refills a slot once its "empty" mbarrier says the row was read; an
// update waits on its row only if its delta is not 0.  A row too wide for
// two slots is streamed in the fewest equal segments of which two fit (two
// at S = 16384 in float64), with a barrier between segments.
// The consumers take one named barrier an update.  Consumer thread t owns
// the 16-byte vectors v = t (mod NT) of grad and beta (the owner rule of
// K1): it is their only writer, so the owner of update k reads current
// values with no extra barrier; it loads the update's beta, a_kk, p_k and
// slot PREFETCH updates ahead, which no update before k can change (a pass
// lists distinct positions).  grad stays in shared memory when it leaves
// room for a ring of two whole rows, else in global memory.  On this card the
// chain costs about 0.4 us an update with no arithmetic at all (the
// floor chip_smoke.py measures), and most of an update beside it.

template <typename T> struct Vec;
template <> struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <> struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
};

__device__ __forceinline__ void sub_scaled(float4& g, const float4& a,
                                           float d) {
  g.x = g.x - d * a.x;
  g.y = g.y - d * a.y;
  g.z = g.z - d * a.z;
  g.w = g.w - d * a.w;
}
__device__ __forceinline__ void sub_scaled(double2& g, const double2& a,
                                           double d) {
  g.x = g.x - d * a.x;
  g.y = g.y - d * a.y;
}

// barrier 1: the NT consumer threads only (barrier 0, __syncthreads, also
// takes the producer warp)
template <int NT>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");
}

// The valid slots s < G with keep(s, p), p their position, ascending in
// s: put(at, s, p) stores entry `at` of the list, by a block prefix sum
// over the NT consumer threads (warp ballots, then one warp scans the warp
// counts); returns the count.  It starts with a consumer barrier, so the
// updates and reads of the pass before are done.  More listed slots than
// positions means two valid slots share one: the list keeps the first S.
template <int NT, typename Valid, typename Keep, typename Put>
__device__ __forceinline__ int build_slot_list(int G, int S,
                                               const int64_t* slot_begin,
                                               Valid valid, Keep keep,
                                               Put put, int* s_scan) {
  constexpr int NWARPS = NT / 32;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  consumer_sync<NT>();
  int count = 0;
  for (int base = 0; base < G; base += NT) {
    const int s = base + t;
    bool f = false;
    int p = 0;
    if (s < G && valid(s)) {
      p = (int)slot_begin[s];
      f = keep(s, p);
    }
    const unsigned bal = __ballot_sync(0xffffffffu, f);
    if (lane == 0) s_scan[warp] = __popc(bal);
    consumer_sync<NT>();
    if (warp == 0) {
      const int x = lane < NWARPS ? s_scan[lane] : 0;
      int incl = x;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      if (lane < NWARPS) s_scan[lane] = incl - x;
      if (lane == 31) s_scan[32] = incl;
    }
    consumer_sync<NT>();
    const int at = count + s_scan[warp] + __popc(bal & ((1u << lane) - 1u));
    if (f && at < S) put(at, s, p);
    count += s_scan[32];
    consumer_sync<NT>();  // s_scan is rewritten by the next tile
  }
  return min(count, S);
}

// 227 KB: the most shared memory one block may have on sm_90; the static
// part of the kernel stays under the margin
constexpr int SMEM_LIMIT = 232448;
constexpr int SMEM_STATIC_MARGIN = 1024;
// consumer threads of a block (a producer warp comes on top): of 128, 256
// and 512, measured at S = 2048 and 8192, 256 was the best or within noise
// at both (PERF.md)
constexpr int ROWS_NT = 256;
constexpr int RING_MAX = 16;     // ring units at most (the TPU kernel: 4)
constexpr int PREFETCH = 4;      // updates the owner loads ahead
constexpr int AXPY_BATCH = 4;    // vectors a thread loads before it stores
constexpr int SCAN_INTS = 64;    // warp counts of a list build, and a total

struct RowsLayout {
  int grad_smem;  // grad in shared memory (else global)
  int plan_smem;  // a pass's list in shared memory (else a global scratch)
  int depth;      // ring units
  int chunk;      // 16-byte vectors a thread copies per unit
  int nch;        // units per row
  int nvt;        // vectors of a row a thread owns
  int bytes;      // dynamic shared memory
  int grad_off, plan_off, scan_off;
};

inline long long align16(long long x) { return (x + 15) / 16 * 16; }

// The shared-memory plan, [ring | grad | list | scan], with as few units a
// row as the budget allows, since every unit past the first costs the
// consumers one more barrier an update: whole rows in a ring of at least
// two, with grad and then the list in shared memory while they leave room
// for it; else each row in the fewest equal segments of which two fit.
// The ring takes whatever is left, up to RING_MAX units.  0 on success.
inline int rows_layout(int S, int itemsize, RowsLayout* L) {
  if (S < 4 || S % 4 || (itemsize != 4 && itemsize != 8)) return 1;
  const long long piece = ROWS_NT * 16LL;  // one vector a thread
  const long long nvec = S / (16 / itemsize);
  const long long nvt = (nvec + ROWS_NT - 1) / ROWS_NT;
  const long long row = nvt * piece;
  const long long scan = align16(4LL * SCAN_INTS);
  const long long budget = SMEM_LIMIT - SMEM_STATIC_MARGIN - scan;
  const long long grad = align16((long long)S * itemsize);
  const long long plan = align16(4LL * S);
  L->grad_smem = 1;
  L->plan_smem = 1;
  long long ring = budget - grad - plan;
  if (ring < 2 * row) {
    L->grad_smem = 0;
    ring = budget - plan;
  }
  if (ring < 2 * row) {
    L->plan_smem = 0;
    ring = budget;
  }
  long long nch = 1, chunk = nvt;
  if (ring < 2 * row) {
    const long long most = ring / (2 * piece);  // the widest of two units
    nch = (nvt + most - 1) / most;
    chunk = (nvt + nch - 1) / nch;
  }
  long long depth = ring / (chunk * piece);
  if (depth > RING_MAX) depth = RING_MAX;
  L->depth = (int)depth;
  L->chunk = (int)chunk;
  L->nch = (int)nch;
  L->nvt = (int)nvt;
  L->grad_off = (int)(depth * chunk * piece);
  L->plan_off = L->grad_off + (L->grad_smem ? (int)grad : 0);
  L->scan_off = L->plan_off + (L->plan_smem ? (int)plan : 0);
  L->bytes = L->scan_off + (int)scan;
  return 0;
}

template <typename T>
struct RowsArgs {
  const T* A;
  const T* beta0;
  const T* grad0;
  const int64_t* slot_begin;
  const int32_t* slot_size;
  const T* eigvals;  // (G, 1)
  const T* penalty;
  const uint8_t* active0;
  T* beta;           // (S,) output and working state
  T* grad;           // (S,) output; working state when not in shared memory
  uint8_t* active;   // (G,) output and working state
  T* info;           // (rsq, iters, done)
  T* akk_p;          // (S,) scratch: a_kk, p_k and slot by position
  T* pk_p;
  int32_t* slot_p;
  int32_t* plan;     // (S,) scratch: a pass's list, unless in shared memory
  int S, G;
  T l1, l2, tol, rsq0;
  int max_iters;
  RowsLayout L;
};

template <typename T, bool GRAD_SMEM>
__global__ void __launch_bounds__(ROWS_NT + 32)
    pin_lasso_solve_rows_kernel(const RowsArgs<T> a) {
  constexpr int NT = ROWS_NT;
  using V = typename Vec<T>::type;
  constexpr int VEC = Vec<T>::n;
  constexpr int NWARPS = NT / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T s_delta[2];
  __shared__ T s_drsq[2];
  __shared__ T s_dconv[2];
  __shared__ T s_red[32];
  __shared__ uint64_t s_full[RING_MAX];   // a slot's row has landed
  __shared__ uint64_t s_empty[RING_MAX];  // a slot's row has been read
  __shared__ int s_cmd;                   // units of the next pass; < 0: exit

  const RowsLayout L = a.L;
  V* ring = reinterpret_cast<V*>(smem);
  T* grad = GRAD_SMEM ? reinterpret_cast<T*>(smem + L.grad_off) : a.grad;
  V* gvec = reinterpret_cast<V*>(grad);
  int* plan = L.plan_smem ? reinterpret_cast<int*>(smem + L.plan_off)
                          : a.plan;
  int* s_scan = reinterpret_cast<int*>(smem + L.scan_off);

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int S = a.S;
  const int G = a.G;
  const int nvec = S / VEC;
  const int nvt = L.nvt;
  const int D = L.depth;
  const int chunk = L.chunk;
  const int nch = L.nch;

  if (t == 0) {
    for (int i = 0; i < D; ++i) {
      mbar_init(&s_full[i], 1);
      mbar_init(&s_empty[i], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // The producer warp: for each pass, one bulk copy (TMA) a unit (segment
  // u % nch of the row of update u / nch) into slot u % D of the ring,
  // completing on s_full; a slot is refilled once s_empty says its last
  // unit was read.  A slot's mbarriers complete once a use, so their
  // parity flips each wrap.
  if (t >= NT) {
    unsigned p_slot = 0, p_par = 0, p_used = 0;
    while (true) {
      __syncthreads();  // the consumers' command
      const int units = s_cmd;
      if (units < 0) break;
      if (t == NT) {
        int pk = 0, pc = 0;
        for (int u = 0; u < units; ++u) {
          if (p_used >= (unsigned)D) mbar_wait(&s_empty[p_slot], p_par ^ 1u);
          const int v0 = pc * chunk * NT;
          const unsigned bytes = (unsigned)min(chunk * NT, nvec - v0) * 16u;
          fence_proxy_async();
          mbar_expect_tx(&s_full[p_slot], bytes);
          bulk_copy(ring + (size_t)p_slot * chunk * NT,
                    a.A + (size_t)plan[pk] * S + (size_t)v0 * VEC, bytes,
                    &s_full[p_slot]);
          if (++pc == nch) {
            pc = 0;
            ++pk;
          }
          ++p_used;
          if (++p_slot == (unsigned)D) {
            p_slot = 0;
            p_par ^= 1u;
          }
        }
      }
      __syncwarp();
    }
    return;
  }

  // The consumers: NT threads, thread t owning the vectors v = t (mod NT)
  const T l1 = a.l1;
  const T l2 = a.l2;
  auto owns = [&](int p) { return ((p / VEC) & (NT - 1)) == t; };

  // working state: each thread copies the elements it owns
  for (int i = 0; i < nvt; ++i) {
    const int v = t + i * NT;
    if (v < nvec) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        grad[v * VEC + e] = a.grad0[v * VEC + e];
        a.beta[v * VEC + e] = a.beta0[v * VEC + e];
      }
    }
  }
  // a valid slot names a position of A; the wrapper's contract, checked
  // here only so that malformed buffers cannot write out of bounds
  auto valid = [&](int s) {
    return a.slot_size[s] > 0 && a.slot_begin[s] >= 0 && a.slot_begin[s] < S;
  };
  T lam = T(0);
  for (int s = t; s < G; s += NT) {
    a.active[s] = a.active0[s];
    lam = nan_max(lam, T(fabs(a.eigvals[s])));
    if (valid(s)) {
      const int p = (int)a.slot_begin[s];
      a.akk_p[p] = a.eigvals[s];
      a.pk_p[p] = a.penalty[s];
      a.slot_p[p] = s;
    }
  }
  // lam_max = max(max |eigvals|, 1), NaN propagating
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    lam = nan_max(lam, __shfl_xor_sync(0xffffffffu, lam, off));
  if (lane == 0) s_red[warp] = lam;
  consumer_sync<NT>();
  lam = T(0);
  for (int w = 0; w < NWARPS; ++w) lam = nan_max(lam, s_red[w]);
  lam = nan_max(lam, T(1));

  // dtype-feasibility floor and floor-gated stall, as K1
  const T eps = Eps<T>::value();
  const T tol_f =
      nan_max(a.tol, T(100) * lam * ((T(10) * eps) * (T(10) * eps)));
  const T stall_floor = T(1e8) * lam * eps * eps;

  T rsq = a.rsq0;
  unsigned step = 0;  // updates so far: parity picks the shared slot

  // The list of a pass into plan, ascending in slot: the active slots
  // (full == false) or the slots whose proposal at the sweep-entry
  // gradient differs from beta (full == true).  Returns its length.
  auto build_list = [&](bool full) -> int {
    return build_slot_list<NT>(
        G, S, a.slot_begin, valid,
        [&](int s, int p) {
          if (!full) return a.active[s] != 0;
          const T bk = a.beta[p];
          const T akk = a.eigvals[s];
          const T pk = a.penalty[s];
          const T u = grad[p] + akk * bk;
          const T vthr = fabs(u) - l1 * pk;
          const T den = akk + l2 * pk;
          const T bnew =
              vthr > T(0) ? sign_of(u) * vthr / (den > T(0) ? den : T(1))
                          : T(0);
          return bnew != bk;
        },
        [&](int at, int, int p) { plan[at] = p; }, s_scan);
  };

  unsigned c_slot = 0, c_par = 0;  // the ring slot of the next unit to read
  unsigned r_slot = 0, r_par = 0;  // the ring slot of the next to release
  // After a consumer barrier, the unit before it has been read.  Its copy
  // may not have landed yet (an update whose delta is 0 reads nothing), so
  // thread 0 waits for it first: the ring's two mbarriers then stay in
  // step, and every copy of a pass has landed when the pass ends.
  auto release = [&]() {
    if (t == 0) {
      mbar_wait(&s_full[r_slot], r_par);
      mbar_arrive(&s_empty[r_slot]);
    }
    if (++r_slot == (unsigned)D) {
      r_slot = 0;
      r_par ^= 1u;
    }
  };

  // One Gauss-Seidel pass over the n listed positions; returns its convg.
  auto run_pass = [&](int n, bool full) -> T {
    T convg = T(0);
    if (n == 0) return convg;
    if (t == 0) s_cmd = n * nch;
    __syncthreads();  // hand the list to the producer

    // the owner's loads, PREFETCH updates ahead
    int ppos[PREFETCH];
    T pb[PREFETCH], pa[PREFETCH], pp[PREFETCH];
    int ps[PREFETCH];
    auto prefetch = [&](int q, int k) {
      const int p = plan[k];
      ppos[q] = p;
      if (owns(p)) {
        pb[q] = a.beta[p];
        pa[q] = a.akk_p[p];
        pp[q] = a.pk_p[p];
        ps[q] = a.slot_p[p];
      }
    };
#pragma unroll
    for (int q = 0; q < PREFETCH; ++q)
      if (q < n) prefetch(q, q);

    for (int k0 = 0; k0 < n; k0 += PREFETCH) {
#pragma unroll
      for (int q = 0; q < PREFETCH; ++q) {
        const int k = k0 + q;
        if (k >= n) break;
        const int p = ppos[q];
        const unsigned par = step & 1u;
        if (owns(p)) {
          const T g = grad[p];
          const T b = pb[q];
          const T akk = pa[q];
          const T bnew = soft_update(b, g, akk, pp[q], l1, l2);
          const T d = bnew - b;
          s_delta[par] = d;
          s_drsq[par] = d * (T(2) * g - d * akk);
          s_dconv[par] = akk * d * d;
          a.beta[p] = bnew;
          if (full && d != T(0)) a.active[ps[q]] = 1;
        }
        consumer_sync<NT>();
        if (k > 0) release();  // the last unit of update k - 1
        const T d = s_delta[par];
        const T drsq = s_drsq[par];
        const T dconv = s_dconv[par];
        // the owner's loads for update k + PREFETCH (this update's are used)
        if (k + PREFETCH < n) prefetch(q, k + PREFETCH);
        if (d != T(0)) {
          rsq = rsq + drsq;
          convg = nan_max(convg, dconv);
        }
        for (int c = 0; c < nch; ++c) {
          // a row in segments: the segment before was read by everyone
          if (c > 0) {
            consumer_sync<NT>();
            release();
          }
          if (d != T(0)) {
            mbar_wait(&s_full[c_slot], c_par);
            const V* src = ring + (size_t)c_slot * chunk * NT;
            const int i0 = c * chunk;
            const int i1 = min(i0 + chunk, nvt);
            // AXPY_BATCH vectors at a time, every load issued before the
            // first store, so their latencies overlap
            for (int ib = i0; ib < i1; ib += AXPY_BATCH) {
              V gv[AXPY_BATCH], av[AXPY_BATCH];
#pragma unroll
              for (int j = 0; j < AXPY_BATCH; ++j) {
                const int i = ib + j;
                const int v = t + i * NT;
                if (i < i1 && v < nvec) {
                  gv[j] = gvec[v];
                  av[j] = src[(i - i0) * NT + t];
                }
              }
#pragma unroll
              for (int j = 0; j < AXPY_BATCH; ++j) {
                const int i = ib + j;
                const int v = t + i * NT;
                if (i < i1 && v < nvec) {
                  sub_scaled(gv[j], av[j], d);
                  gvec[v] = gv[j];
                }
              }
            }
          }
          if (++c_slot == (unsigned)D) {
            c_slot = 0;
            c_par ^= 1u;
          }
        }
        ++step;
      }
    }
    consumer_sync<NT>();
    release();  // the last unit of the pass
    return convg;
  };

  auto next_slow = [](int slow, T convg, T prev) {
    return convg >= T(0.99) * prev ? slow + 1 : 0;
  };
  auto stalled = [&](int slow, T convg) {
    return slow >= 3 && convg <= stall_floor;
  };

  T convg = T(INFINITY);
  int slow = 0;
  int iters = 0;
  bool done = false;
  const int max_iters = a.max_iters;
  while (!done && iters < max_iters && !stalled(slow, convg) &&
         convg == convg) {
    const T prev = convg;
    // active phase: the list is fixed, so it is built once
    const int na = build_list(false);
    T c = run_pass(na, false);
    int a_slow = 0;
    int it = iters + 1;
    while (c >= tol_f && it < max_iters && !stalled(a_slow, c)) {
      const T a_prev = c;
      c = run_pass(na, false);
      a_slow = next_slow(a_slow, c, a_prev);
      ++it;
    }
    iters = it;
    const int nf = build_list(true);
    convg = run_pass(nf, true);
    slow = next_slow(slow, convg, prev);
    ++iters;
    done = convg < tol_f;
  }
  // a floor-gated stall is convergence at the dtype's floor; NaN is failure
  done = (done || stalled(slow, convg)) && convg == convg;

  if (t == 0) s_cmd = -1;
  __syncthreads();  // the producer stops
  if (GRAD_SMEM) {
    for (int i = 0; i < nvt; ++i) {
      const int v = t + i * NT;
      if (v < nvec) reinterpret_cast<V*>(a.grad)[v] = gvec[v];
    }
  }
  if (t == 0) {
    a.info[0] = rsq;
    a.info[1] = T(iters);
    a.info[2] = done ? T(1) : T(0);
  }
}

// ------------------------------------------------------------------------ //
// K1: pin_lasso_solve                                                      //
// ------------------------------------------------------------------------ //
//
// Replaces adelie_tpu/solver/pin_pallas.py:pin_lasso_solve_pallas
// (_pin_kernel): the whole q = 1 pin solve at one lambda, S <= 1024, on
// the screen's slot buffers as K2 takes them.  Active-phase sweeps over the
// valid active slots (at least one, then until convg < tol_f, a
// floor-gated stall or max_iters), then one full sweep over every valid
// slot at the current gradient (K2 filters that sweep; K1, as the TPU
// kernel, does not); repeat until a full sweep's convg < tol_f.  Moved
// slots of a full sweep become active.  A NaN iterate ends the solve as a
// failure.
//
// What bounds it here: the serial chain, as for K2.  At S <= 1024 all but
// the Gram fits in shared memory, and the design is K2's at K1's sizes:
//  * lists: the valid slots' positions, ascending, built once a launch by
//    a block prefix sum (build_slot_list), and the active ones once an
//    active phase; a sweep walks its list only, not all S slots;
//  * rows: a producer warp copies each listed row into shared memory by a
//    TMA bulk copy.  A pass whose rows all fit (49 rows of 4 KB at
//    S = 1024 in float32, 22 of 8 KB in float64) has them copied once,
//    behind one mbarrier, and an active phase keeps them resident across
//    its sweeps; a longer pass streams through K2's ring, so no update
//    waits on a row's latency after its barrier;
//  * 256 consumer threads (fewer at small S measured no faster): thread t
//    owns the 16-byte vectors v = t (mod 256) of grad and beta,
//    both in shared memory beside each position's a_kk, p_k and slot, so
//    the owner of an update reads current values with no extra barrier;
//    one named barrier an update;
//  * lam_cap by a block reduction over the slots.
// The same update order and arithmetic as the twin: bit-equal to it.  On
// this card an update costs about 0.47 us in float32 (PERF.md): the
// owner's soft threshold and the reads after the barrier, not the rows.

constexpr int K1_MAX_S = 1024;

struct K1Layout {
  int rows;       // whole rows the ring holds: a pass this long is resident
  int depth;      // ring slots of a streamed pass, at most RING_MAX
  int row;        // bytes a row
  int state_off;  // grad, beta, a_kk, p_k (S each), slot and two lists
  int scan_off;
  int bytes;      // dynamic shared memory
};

// [ring | grad beta a_kk p_k | slot, active list, valid list | scan]: the
// ring takes what the state leaves.  0 on success.
inline int k1_layout(int S, int itemsize, K1Layout* L) {
  if (S < 4 || S > K1_MAX_S || S % 4 || (itemsize != 4 && itemsize != 8))
    return 1;
  const long long row = (long long)S * itemsize;
  const long long state = 4 * row + align16(3LL * 4 * S);
  const long long scan = align16(4LL * SCAN_INTS);
  const long long rows =
      (SMEM_LIMIT - SMEM_STATIC_MARGIN - state - scan) / row;
  if (rows < 2) return 1;
  L->rows = (int)rows;
  L->depth = (int)(rows < RING_MAX ? rows : RING_MAX);
  L->row = (int)row;
  L->state_off = (int)(rows * row);
  L->scan_off = L->state_off + (int)state;
  L->bytes = L->scan_off + (int)scan;
  return 0;
}

template <typename T>
struct K1Args {
  const T* A;
  const T* beta0;
  const T* grad0;
  const int64_t* slot_begin;
  const int32_t* slot_size;
  const T* eigvals;  // (G, 1)
  const T* penalty;
  const uint8_t* active0;
  T* beta;           // (S,) output
  T* grad;           // (S,) output
  uint8_t* active;   // (G,) output and working state
  T* info;           // (rsq, iters, done)
  int S, G;
  T l1, l2, tol, rsq0;
  int max_iters;
  K1Layout L;
};

template <typename T>
__global__ void __launch_bounds__(ROWS_NT + 32)
    pin_lasso_solve_kernel(const K1Args<T> a) {
  constexpr int NT = ROWS_NT;
  using V = typename Vec<T>::type;
  constexpr int VEC = Vec<T>::n;
  constexpr int NWARPS = NT / 32;
  constexpr int NVT = (K1_MAX_S / VEC + NT - 1) / NT;  // vectors a thread
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T s_delta[2];
  __shared__ T s_drsq[2];
  __shared__ T s_dconv[2];
  __shared__ T s_red[32];
  __shared__ uint64_t s_full[RING_MAX];   // a streamed slot's row has landed
  __shared__ uint64_t s_empty[RING_MAX];  // a streamed slot's row was read
  __shared__ uint64_t s_res;              // a resident pass's rows landed
  __shared__ int s_cmd;                   // rows of the next pass; < 0: exit
  __shared__ int s_how;                   // 1: the valid list; 2: resident

  const K1Layout L = a.L;
  const int S = a.S;
  const int G = a.G;
  const int nvec = S / VEC;
  const int D = L.depth;
  const unsigned row_bytes = (unsigned)L.row;
  unsigned char* ring = smem;
  T* grad = reinterpret_cast<T*>(smem + L.state_off);
  T* beta = grad + S;
  T* akk_p = beta + S;
  T* pk_p = akk_p + S;
  int* slot_p = reinterpret_cast<int*>(pk_p + S);
  int* list_a = slot_p + S;
  int* list_v = list_a + S;
  int* s_scan = reinterpret_cast<int*>(smem + L.scan_off);
  V* gvec = reinterpret_cast<V*>(grad);

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  if (t == 0) {
    for (int i = 0; i < D; ++i) {
      mbar_init(&s_full[i], 1);
      mbar_init(&s_empty[i], 1);
    }
    mbar_init(&s_res, 1);
    mbar_init_fence();
  }
  __syncthreads();

  // The producer warp, for each pass: a resident pass's n rows into the
  // ring's first n rows, all completing on s_res; a streamed pass's rows
  // one a slot, as K2's producer does.
  if (t >= NT) {
    unsigned p_slot = 0, p_par = 0, p_used = 0;
    while (true) {
      __syncthreads();  // the consumers' command
      const int n = s_cmd;
      if (n < 0) break;
      const int* list = (s_how & 1) ? list_v : list_a;
      if (t == NT) {
        if (s_how & 2) {
          fence_proxy_async();
          mbar_expect_tx(&s_res, (unsigned)n * row_bytes);
          for (int u = 0; u < n; ++u)
            bulk_copy(ring + (size_t)u * row_bytes,
                      a.A + (size_t)list[u] * S, row_bytes, &s_res);
        } else {
          for (int u = 0; u < n; ++u) {
            if (p_used >= (unsigned)D) mbar_wait(&s_empty[p_slot], p_par ^ 1u);
            fence_proxy_async();
            mbar_expect_tx(&s_full[p_slot], row_bytes);
            bulk_copy(ring + (size_t)p_slot * row_bytes,
                      a.A + (size_t)list[u] * S, row_bytes, &s_full[p_slot]);
            ++p_used;
            if (++p_slot == (unsigned)D) {
              p_slot = 0;
              p_par ^= 1u;
            }
          }
        }
      }
      __syncwarp();
    }
    return;
  }

  // The consumers: NT threads, thread t owning the vectors v = t (mod NT)
  const T l1 = a.l1;
  const T l2 = a.l2;
  auto owns = [&](int p) {
    return (((unsigned)p / VEC) & (NT - 1)) == (unsigned)t;
  };

  for (int i = 0; i < NVT; ++i) {
    const int v = t + i * NT;
    if (v < nvec) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        grad[v * VEC + e] = a.grad0[v * VEC + e];
        beta[v * VEC + e] = a.beta0[v * VEC + e];
      }
    }
  }
  // a valid slot names a position of A; the wrapper's contract, checked
  // here only so that malformed buffers cannot write out of bounds
  auto valid = [&](int s) {
    return a.slot_size[s] > 0 && a.slot_begin[s] >= 0 && a.slot_begin[s] < S;
  };
  T lam = T(0);
  for (int s = t; s < G; s += NT) {
    a.active[s] = a.active0[s];
    lam = nan_max(lam, T(fabs(a.eigvals[s])));
    if (valid(s)) {
      const int p = (int)a.slot_begin[s];
      akk_p[p] = a.eigvals[s];
      pk_p[p] = a.penalty[s];
      slot_p[p] = s;
    }
  }
  // lam_cap = max(max |eigvals|, 1), NaN propagating
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    lam = nan_max(lam, __shfl_xor_sync(0xffffffffu, lam, off));
  if (lane == 0) s_red[warp] = lam;
  consumer_sync<NT>();
  lam = T(0);
  for (int w = 0; w < NWARPS; ++w) lam = nan_max(lam, s_red[w]);
  lam = nan_max(lam, T(1));

  // dtype-feasibility floor and floor-gated stall (pin_pallas.py:56-112)
  const T eps = Eps<T>::value();
  const T tol_f =
      nan_max(a.tol, T(100) * lam * ((T(10) * eps) * (T(10) * eps)));
  const T stall_floor = T(1e8) * lam * eps * eps;

  T rsq = a.rsq0;
  unsigned step = 0;  // updates so far: parity picks the shared slot

  unsigned c_slot = 0, c_par = 0;  // the ring slot of the next unit to read
  unsigned r_slot = 0, r_par = 0;  // the ring slot of the next to release
  unsigned res_par = 0;            // the phase of s_res to wait for
  // K2's release: after a consumer barrier the row before it has been
  // read; thread 0 waits for its copy and frees its slot
  auto release = [&]() {
    if (t == 0) {
      mbar_wait(&s_full[r_slot], r_par);
      mbar_arrive(&s_empty[r_slot]);
    }
    if (++r_slot == (unsigned)D) {
      r_slot = 0;
      r_par ^= 1u;
    }
  };

  // One Gauss-Seidel pass over the n positions of list; returns its convg.
  // mode 0: the rows stream through the ring; 1: they are copied for this
  // pass and stay resident; 2: they are resident from the pass before.
  auto run_pass = [&](const int* list, int n, bool full, int mode) -> T {
    T convg = T(0);
    if (n == 0) return convg;
    if (mode != 2) {
      if (t == 0) {
        s_cmd = n;
        s_how = (full ? 1 : 0) | (mode == 1 ? 2 : 0);
      }
      __syncthreads();  // hand the list to the producer
      if (mode == 1) mbar_wait(&s_res, res_par);
    }

    // the owner's loads, PREFETCH updates ahead
    int ppos[PREFETCH];
    T pb[PREFETCH], pa[PREFETCH], pp[PREFETCH];
    int ps[PREFETCH];
    auto prefetch = [&](int q, int k) {
      const int p = list[k];
      ppos[q] = p;
      if (owns(p)) {
        pb[q] = beta[p];
        pa[q] = akk_p[p];
        pp[q] = pk_p[p];
        ps[q] = slot_p[p];
      }
    };
#pragma unroll
    for (int q = 0; q < PREFETCH; ++q)
      if (q < n) prefetch(q, q);

    for (int k0 = 0; k0 < n; k0 += PREFETCH) {
#pragma unroll
      for (int q = 0; q < PREFETCH; ++q) {
        const int k = k0 + q;
        if (k >= n) break;
        const int p = ppos[q];
        const unsigned par = step & 1u;
        if (owns(p)) {
          const T g = grad[p];
          const T b = pb[q];
          const T akk = pa[q];
          const T bnew = soft_update(b, g, akk, pp[q], l1, l2);
          const T d = bnew - b;
          s_delta[par] = d;
          s_drsq[par] = d * (T(2) * g - d * akk);
          s_dconv[par] = akk * d * d;
          beta[p] = bnew;
          if (full && d != T(0)) a.active[ps[q]] = 1;
        }
        consumer_sync<NT>();
        if (mode == 0 && k > 0) release();  // the row of update k - 1
        const T d = s_delta[par];
        const T drsq = s_drsq[par];
        const T dconv = s_dconv[par];
        // the owner's loads for update k + PREFETCH (this update's are used)
        if (k + PREFETCH < n) prefetch(q, k + PREFETCH);
        if (d != T(0)) {
          rsq = rsq + drsq;
          convg = nan_max(convg, dconv);
          if (mode == 0) mbar_wait(&s_full[c_slot], c_par);
          const V* src = reinterpret_cast<const V*>(
              ring + (size_t)(mode == 0 ? c_slot : k) * row_bytes);
          // every load issued before the first store
          V gv[NVT], av[NVT];
#pragma unroll
          for (int i = 0; i < NVT; ++i) {
            const int v = t + i * NT;
            if (v < nvec) {
              gv[i] = gvec[v];
              av[i] = src[v];
            }
          }
#pragma unroll
          for (int i = 0; i < NVT; ++i) {
            const int v = t + i * NT;
            if (v < nvec) {
              sub_scaled(gv[i], av[i], d);
              gvec[v] = gv[i];
            }
          }
        }
        if (mode == 0 && ++c_slot == (unsigned)D) {
          c_slot = 0;
          c_par ^= 1u;
        }
        ++step;
      }
    }
    if (mode == 0) {
      consumer_sync<NT>();
      release();  // the last row of the pass
    }
    return convg;
  };

  auto next_slow = [](int slow, T convg, T prev) {
    return convg >= T(0.99) * prev ? slow + 1 : 0;
  };
  auto stalled = [&](int slow, T convg) {
    return slow >= 3 && convg <= stall_floor;
  };
  auto resident = [&](int n) { return n <= L.rows; };

  // the valid slots do not change during a solve: one list a launch
  const int nv = build_slot_list<NT>(
      G, S, a.slot_begin, valid, [](int, int) { return true; },
      [&](int at, int, int p) { list_v[at] = p; }, s_scan);

  T convg = T(INFINITY);
  int slow = 0;
  int iters = 0;
  bool done = false;
  const int max_iters = a.max_iters;
  while (!done && iters < max_iters && !stalled(slow, convg) &&
         convg == convg) {
    const T prev = convg;
    // active phase: the list is fixed, so it is built, and its rows are
    // copied when they fit, once
    const int na = build_slot_list<NT>(
        G, S, a.slot_begin, valid,
        [&](int s, int) { return a.active[s] != 0; },
        [&](int at, int, int p) { list_a[at] = p; }, s_scan);
    const bool res_a = resident(na);
    T c = run_pass(list_a, na, false, res_a ? 1 : 0);
    int a_slow = 0;
    int it = iters + 1;
    while (c >= tol_f && it < max_iters && !stalled(a_slow, c)) {
      const T a_prev = c;
      c = run_pass(list_a, na, false, res_a ? 2 : 0);
      a_slow = next_slow(a_slow, c, a_prev);
      ++it;
    }
    if (res_a && na > 0) res_par ^= 1u;
    iters = it;
    convg = run_pass(list_v, nv, true, resident(nv) ? 1 : 0);
    if (resident(nv) && nv > 0) res_par ^= 1u;
    slow = next_slow(slow, convg, prev);
    ++iters;
    done = convg < tol_f;
  }
  // a floor-gated stall is convergence at the dtype's floor; NaN is failure
  done = (done || stalled(slow, convg)) && convg == convg;

  if (t == 0) s_cmd = -1;
  __syncthreads();  // the producer stops; every update is done
  for (int i = 0; i < NVT; ++i) {
    const int v = t + i * NT;
    if (v < nvec) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        a.grad[v * VEC + e] = grad[v * VEC + e];
        a.beta[v * VEC + e] = beta[v * VEC + e];
      }
    }
  }
  if (t == 0) {
    a.info[0] = rsq;
    a.info[1] = T(iters);
    a.info[2] = done ? T(1) : T(0);
  }
}

template <typename T>
int launch_pin_lasso_solve(const void* A, const void* beta0,
                           const void* grad0, const void* slot_begin,
                           const void* slot_size, const void* eigvals,
                           const void* penalty, const void* active0,
                           void* beta, void* grad, void* active, void* info,
                           int S, int G, T l1, T l2, T tol, T rsq,
                           int max_iters, void* stream) {
  K1Args<T> args;
  if (G < 1 || ((uintptr_t)A & 15) ||
      k1_layout(S, (int)sizeof(T), &args.L) != 0)
    return (int)cudaErrorInvalidValue;
  args.A = (const T*)A;
  args.beta0 = (const T*)beta0;
  args.grad0 = (const T*)grad0;
  args.slot_begin = (const int64_t*)slot_begin;
  args.slot_size = (const int32_t*)slot_size;
  args.eigvals = (const T*)eigvals;
  args.penalty = (const T*)penalty;
  args.active0 = (const uint8_t*)active0;
  args.beta = (T*)beta;
  args.grad = (T*)grad;
  args.active = (uint8_t*)active;
  args.info = (T*)info;
  args.S = S;
  args.G = G;
  args.l1 = l1;
  args.l2 = l2;
  args.tol = tol;
  args.rsq0 = rsq;
  args.max_iters = max_iters;
  auto kernel = pin_lasso_solve_kernel<T>;
  // above 48 KB a block's dynamic shared memory must be opted into, once
  // per kernel
  static int opted_in = 0;
  if (args.L.bytes > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, args.L.bytes);
    if (e != cudaSuccess) return (int)e;
    opted_in = args.L.bytes;
  }
  kernel<<<1, ROWS_NT + 32, args.L.bytes, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

template <typename T, bool GRAD_SMEM>
int launch_rows_block(const RowsArgs<T>& args, cudaStream_t stream) {
  auto kernel = pin_lasso_solve_rows_kernel<T, GRAD_SMEM>;
  // above 48 KB a block's dynamic shared memory must be opted into, once
  // per kernel
  static int opted_in = 0;
  if (args.L.bytes > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, args.L.bytes);
    if (e != cudaSuccess) return (int)e;
    opted_in = args.L.bytes;
  }
  kernel<<<1, ROWS_NT + 32, args.L.bytes, stream>>>(args);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pin_lasso_solve_rows(
    const void* A, const void* beta0, const void* grad0,
    const void* slot_begin, const void* slot_size, const void* eigvals,
    const void* penalty, const void* active0, void* beta, void* grad,
    void* active, void* info, void* akk_p, void* pk_p, void* slot_p,
    void* plan, int S, int G, T l1, T l2, T tol, T rsq, int max_iters,
    void* stream) {
  RowsArgs<T> args;
  if (S < 1 || G < 1 || ((uintptr_t)A & 15) ||
      rows_layout(S, (int)sizeof(T), &args.L) != 0)
    return (int)cudaErrorInvalidValue;
  args.A = (const T*)A;
  args.beta0 = (const T*)beta0;
  args.grad0 = (const T*)grad0;
  args.slot_begin = (const int64_t*)slot_begin;
  args.slot_size = (const int32_t*)slot_size;
  args.eigvals = (const T*)eigvals;
  args.penalty = (const T*)penalty;
  args.active0 = (const uint8_t*)active0;
  args.beta = (T*)beta;
  args.grad = (T*)grad;
  args.active = (uint8_t*)active;
  args.info = (T*)info;
  args.akk_p = (T*)akk_p;
  args.pk_p = (T*)pk_p;
  args.slot_p = (int32_t*)slot_p;
  args.plan = (int32_t*)plan;
  args.S = S;
  args.G = G;
  args.l1 = l1;
  args.l2 = l2;
  args.tol = tol;
  args.rsq0 = rsq;
  args.max_iters = max_iters;
  cudaStream_t st = (cudaStream_t)stream;
  return args.L.grad_smem ? launch_rows_block<T, true>(args, st)
                          : launch_rows_block<T, false>(args, st);
}

}  // namespace

extern "C" {

int adelie_pin_lasso_solve_f32(
    const void* A, const void* beta0, const void* grad0,
    const void* slot_begin, const void* slot_size, const void* eigvals,
    const void* penalty, const void* active0, void* beta, void* grad,
    void* active, void* info, int S, int G, float l1, float l2, float tol,
    float rsq, int max_iters, void* stream) {
  return launch_pin_lasso_solve<float>(
      A, beta0, grad0, slot_begin, slot_size, eigvals, penalty, active0, beta,
      grad, active, info, S, G, l1, l2, tol, rsq, max_iters, stream);
}

int adelie_pin_lasso_solve_f64(
    const void* A, const void* beta0, const void* grad0,
    const void* slot_begin, const void* slot_size, const void* eigvals,
    const void* penalty, const void* active0, void* beta, void* grad,
    void* active, void* info, int S, int G, double l1, double l2, double tol,
    double rsq, int max_iters, void* stream) {
  return launch_pin_lasso_solve<double>(
      A, beta0, grad0, slot_begin, slot_size, eigvals, penalty, active0, beta,
      grad, active, info, S, G, l1, l2, tol, rsq, max_iters, stream);
}

int adelie_pin_lasso_solve_rows_f32(
    const void* A, const void* beta0, const void* grad0,
    const void* slot_begin, const void* slot_size, const void* eigvals,
    const void* penalty, const void* active0, void* beta, void* grad,
    void* active, void* info, void* akk_p, void* pk_p, void* slot_p,
    void* plan, int S, int G, float l1, float l2, float tol, float rsq,
    int max_iters, void* stream) {
  return launch_pin_lasso_solve_rows<float>(
      A, beta0, grad0, slot_begin, slot_size, eigvals, penalty, active0, beta,
      grad, active, info, akk_p, pk_p, slot_p, plan, S, G, l1, l2, tol, rsq,
      max_iters, stream);
}

int adelie_pin_lasso_solve_rows_f64(
    const void* A, const void* beta0, const void* grad0,
    const void* slot_begin, const void* slot_size, const void* eigvals,
    const void* penalty, const void* active0, void* beta, void* grad,
    void* active, void* info, void* akk_p, void* pk_p, void* slot_p,
    void* plan, int S, int G, double l1, double l2, double tol, double rsq,
    int max_iters, void* stream) {
  return launch_pin_lasso_solve_rows<double>(
      A, beta0, grad0, slot_begin, slot_size, eigvals, penalty, active0, beta,
      grad, active, info, akk_p, pk_p, slot_p, plan, S, G, l1, l2, tol, rsq,
      max_iters, stream);
}

// the rows K1 keeps resident at S and itemsize: a pass over a list this
// long has its rows copied once; a longer one streams them (0: K1 does
// not take this S)
int adelie_pin_lasso_solve_resident_rows(int S, int itemsize) {
  K1Layout L;
  return k1_layout(S, itemsize, &L) == 0 ? L.rows : 0;
}

const char* adelie_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
