// The screened coordinate-descent kernels (K7) for Hopper (sm_90a).
//
// K7 runs the whole fit of the standalone solvers' screened problem,
// templated on float and double and on the update (BVLS's box, pinball's
// asymmetric soft threshold), as segments that the host drives
// (adelie_tpu_torch/solver/screened_cd_kernels.py, through a plain C
// interface loaded by ctypes).  Three kernels: the chain (one block, a
// full sweep or a segment of an active phase), the gather (a grid, the
// active phase's block of the Gram) and the replay (a grid, the other
// slots brought up to date).  Each entry point launches on the caller's
// stream, allocates nothing and returns cudaGetLastError().
//
// What it replaces: not a Pallas kernel.  The JAX package runs this fit as
// one XLA device program, adelie_tpu/solver/screened_cd.py:screened_cd_fit
// (:45-141), a while_loop of fori_loops over the screened atoms whose body
// branches with lax.cond.
//
// The fit, on the Gram Q (S x S) of the screened atoms:
//   1. one sweep over every valid slot;
//   2. if its convergence measure max d delta^2 exceeds tol_scale, sweeps
//      over the active slots (at least one) while it does and the sweep
//      count is below max_iters;
//   3. prune the active flags (box: strictly inside the bounds; pinball:
//      nonzero);
//   4. repeat from 1 until a full sweep converges or the count reaches
//      max_iters.
// A coordinate update is
//   box:     b' = clip(b + g / d, lo, hi)      (b' = clip(b, lo, hi) if d <= 0)
//   pinball: g0 = g + d b, b' = sign(g0 + lo) max(-lo - g0, g0 - hi, 0) / d
//            (b' = b if d <= 0)
// and, when delta = b' - b is not 0 (NaN included):
//   convg = max(convg, d delta^2), loss -= delta g - 0.5 d delta^2,
//   grad -= delta Q[:, i], the slot becomes active.
// Q is not bit-symmetric (its triangles are rounded by different products),
// so the update reads column i, as the JAX loop does: the kernels take Q^T
// row-major, whose row i is column i of Q.
//
// What bounds it: the serial chain.  Update i needs the gradient every
// earlier update left, so the sweeps run in one block on one SM, and an
// update costs the latency of its own arithmetic (a division, compares,
// for pinball in float64 about 340 cycles of an H100 SM) plus whatever
// the design puts beside it on the chain.  A full sweep keeps the design
// of the first K7: every thread computes each update's scalars itself
// (an update that does not move costs no barrier), and a move costs an
// AXPY over the whole row of Q^T (S values from L2 or HBM) between two
// barriers, about 1.7 us at S = 4,096 in float64.  It runs once a round;
// the active phase runs almost every sweep (64,427 of them in one pinball
// fit of chip_smoke.py's A2), so the active phase is where the design
// goes:
//
// * Compaction.  An active phase reads and moves only its listed slots
//   (valid and active), and the list and its order are fixed for the whole
//   phase.  So the phase runs on a compact block: Qc = Q^T[list][:, list]
//   (na x na, rows padded to a multiple of 4 values), built once a phase
//   by the gather kernel on a grid, and the listed slots' grad, beta,
//   diag, lo, hi, Qc's diagonal and Qc's next element in each row, held
//   by the chain block in shared memory (in global memory when na is too
//   large for them and a ring of two rows).  A move then touches na
//   values, not S: a quarter of them on A2.
// * The ring.  The list order is fixed, so the rows a phase needs are
//   known ahead.  A producer warp keeps up to RING_MAX rows of Qc in
//   flight into a ring in shared memory, one 1-D bulk copy (TMA) a row on
//   the slot's "full" mbarrier, in list order, wrapping at each sweep; a
//   slot is refilled once its "empty" mbarrier says the row was read, or
//   has landed unread (an update that does not move reads nothing).  A
//   move's AXPY reads its row from shared memory.
// * One barrier an update, the chain beside the AXPY.  One warp runs the
//   chain; six others apply the moves.  The chain applies the previous
//   move to the position it reads (one product with Qc's next element)
//   and its own move to its own position (Qc's diagonal), so the AXPY of
//   move k, which skips those two positions, runs while the chain
//   computes update k + 1; the update's barrier publishes its delta.  On
//   the card that overlap brought a listed update from about 1.0 us (two
//   barriers a move, every thread computing the scalars) to about 0.35 us
//   in float64, of which the chain's arithmetic is half.
// * The log and the replay.  The other slots (valid but not listed, and
//   invalid) are not read during a phase.  What the twin does to each of
//   them is a fixed sequence of g[j] = g[j] - delta Q^T[i, j], one move at
//   a time in move order.  So each listed update writes its delta to a log
//   in device memory (0 when it does not move), and after the segment the
//   replay kernel, on a grid over the other slots, applies the logged
//   moves to each of them in order, each a product then a subtraction,
//   skipping a delta that is exactly 0 and applying a NaN one, as the
//   twin's "not delta != 0" does: the same operations on the same values
//   in the same order give the twin's bits.  Each slot's chain of
//   subtractions is serial, so the replay is bound by that chain's
//   latency times the logged updates, for all the slots at once.
// * Segments.  A segment of an active phase logs at most log_sweeps whole
//   sweeps and at most as many as the log holds, then writes its compact
//   state back; the replay follows, then the host reads the state (one
//   copy) and launches the next.  The host also reads the state after
//   each full sweep: a sweep that converged ends the fit with no other
//   launch, and one that opens a phase says how many slots it lists, from
//   which the host sizes Qc (na rows of cd_ldc(na)) and the log (whole
//   sweeps, at least one) before the gather.
// * The ring's end.  The producer may trail the chain (in a stretch where
//   nothing moves, the AXPY warps only wait for each row to land before
//   they release it).  So the chain publishes, with its stop, the count
//   of rows the segment's consumers read, and the producer issues every
//   row below that count before it stops.

// Rounding: every operation is the twin's (screened_cd_solve_ref) in the
// same order, one rounding each; the build has -fmad=false, so the twin
// and the kernels take the same path bit for bit.
//
// The fit's state is a double[ST_LEN] in device memory, written by the
// chain and read by the host after each segment: its first five entries
// are the fit's info (loss, sweeps with iters0, converged, moves,
// updates); the loss and the last active sweep's convg are values of T,
// exact in double.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "async_copy.cuh"

namespace {

constexpr int CD_NT = 256;                // a full sweep's threads
// an active segment's: the chain (warp 0), the AXPY warps (1-3, 5-7), two
// idle warps (4, 8) and the producer (9)
constexpr int CD_THREADS = 320;
constexpr int AXPY_NT = 192;
constexpr int SMEM_MAX = 232448;          // a block's shared memory on the H100
constexpr int SMEM_STATIC_MARGIN = 1024;  // the kernels' static shared memory
constexpr int SMEM_DYN = SMEM_MAX - SMEM_STATIC_MARGIN;
constexpr int RING_MAX = 16;              // rows of Qc in flight at most
constexpr int CD_VECS = 7;                // the active phase's compact vectors
constexpr int AXPY_BATCH = 4;             // values a thread loads before it stores
constexpr int GATHER_NT = 256;
constexpr int GATHER_BLOCKS = 1024;
constexpr int REPLAY_NT = 128;
constexpr int REPLAY_UNROLL = 8;
constexpr int REPLAY_CHUNK = 2048;        // logged deltas a replay block stages

enum { MODE_BOX = 0, MODE_PINBALL = 1 };
enum { STAGE_FULL = 0, STAGE_ACTIVE = 1 };
// where the active phase keeps its compact vectors and its rows
enum { LAYOUT_GLOBAL = 0, LAYOUT_RING = 1, LAYOUT_SMEM = 2 };

// the fit's state, shared with screened_cd_kernels.py
enum {
  ST_LOSS = 0,
  ST_ITERS,         // sweeps, iters0 included
  ST_DONE,          // 1 when a full sweep converged
  ST_MOVES,
  ST_UPDATES,
  ST_PHASE,         // 1 while an active phase is open
  ST_FRESH,         // 1 from a phase's opening to its first segment
  ST_NA,            // the open phase's listed slots
  ST_NR,            // the other slots
  ST_PHASE_SWEEPS,  // sweeps of the open phase so far
  ST_LOGGED,        // sweeps in the log for the replay
  ST_LIST_MOVES,    // moves of listed updates
  ST_LIST_UPDATES,  // listed updates
  ST_CONVG,         // the last active sweep's convg
  ST_LEN = 16
};

// max that propagates NaN, as jnp.maximum does
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  if (a != a || b != b) return a + b;
  return a > b ? a : b;
}

template <typename T, int MODE>
__device__ __forceinline__ T cd_update(T d, T g, T b, T lo, T hi) {
  if (MODE == MODE_BOX) {
    const T step = d <= T(0) ? T(0) : g / d;
    T x = b + step;
    // jnp.clip: min(max(x, lo), hi), NaN kept
    x = x < lo ? lo : x;
    return x > hi ? hi : x;
  }
  const T g0 = g + d * b;
  const T mag = nan_max(nan_max(-lo - g0, g0 - hi), T(0));
  const T sgn = g0 + lo >= T(0) ? T(1) : T(-1);
  return d <= T(0) ? b : sgn * mag / d;
}

// the prune: an active slot stays active strictly inside its bounds (box)
// or away from 0 (pinball)
template <typename T, int MODE>
__device__ __forceinline__ bool cd_keep(T b, T lo, T hi) {
  return MODE == MODE_BOX ? (b > lo && b < hi) : b != T(0);
}

// barrier 1: a full sweep's CD_NT threads only (barrier 0, __syncthreads,
// takes the whole block)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CD_NT) : "memory");
}
// barrier 1 in an active segment: the chain and the AXPY warps
__device__ __forceinline__ void active_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(AXPY_NT + 32) : "memory");
}
// barrier 2 at an active segment's end: warps 0-8 (not the producer)
__device__ __forceinline__ void tail_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(CD_THREADS - 32) : "memory");
}

// the row stride of Qc and the compact vectors: a multiple of 16 bytes
__host__ __device__ inline int cd_ldc(int n) {
  return n < 4 ? 4 : (n + 3) / 4 * 4;
}

// the full sweep's shared memory: beta, grad, lo, hi, diag (S values
// each), then the valid and active flags (S bytes each)
__host__ __device__ inline long long cd_smem_bytes(int S, int elem) {
  return 5LL * S * elem + 2LL * S;
}

// The active phase's layout for na listed slots in `budget` bytes: the
// seven compact vectors and a ring of at least two rows in shared memory,
// else the ring alone, else neither (or `forced` if it is smaller, when
// it is not -1); *depth gets the ring's rows, at most RING_MAX and at
// most `ring` when it is not 0.
__host__ __device__ inline int active_layout(int na, int elem, int budget,
                                             int forced, int ring,
                                             int* depth) {
  const long long row = (long long)cd_ldc(na) * elem;
  const long long vec = CD_VECS * row;
  int layout = LAYOUT_GLOBAL;
  if (vec + 2 * row <= budget)
    layout = LAYOUT_SMEM;
  else if (2 * row <= budget)
    layout = LAYOUT_RING;
  if (forced >= 0 && forced < layout) layout = forced;
  long long d = 0;
  if (layout == LAYOUT_SMEM) d = (budget - vec) / row;
  if (layout == LAYOUT_RING) d = budget / row;
  const long long most = ring > 0 && ring < RING_MAX ? ring : RING_MAX;
  *depth = (int)(d < most ? d : most);
  return layout;
}

template <typename T>
struct CdArgs {
  const T* Qt;            // (S, S): row i is column i of Q
  T* Qc;                  // the phase's block, na rows of cd_ldc(na)
  const T* diag;
  const T* lo;
  const T* hi;
  const uint8_t* valid;
  T* beta;                // (S,) the fit's state, in place
  T* grad;
  uint8_t* active;
  int* list;              // (S,) the open phase's listed slots, ascending
  int* rest;              // (S,) the other slots, ascending
  T* cvec;                // (CD_VECS cd_ldc(S),) compact vectors past smem
  T* log;                 // (log_cap,) a segment's deltas, sweep by sweep
  double* st;             // (ST_LEN,) the fit's state
  int S;
  T tol_scale;
  int max_iters;
  long long log_cap;
  int log_sweeps;         // sweeps a segment logs at most
  int layout;             // -1, else the active layout at most
  int ring;               // 0, else the ring's rows at most (2 or more)
  int smem;               // the launch's dynamic shared memory
};

// g -= delta q over the block, eight loads of q in flight a thread; each
// g[j] is one product and one subtraction, as in the twin
template <typename T>
__device__ __forceinline__ void axpy_row(T* g, const T* __restrict__ q,
                                         T delta, int S, int tid) {
  constexpr int U = 8;
  for (int j0 = tid; j0 < S; j0 += CD_NT * U) {
    T qv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * CD_NT;
      qv[u] = j < S ? __ldg(q + j) : T(0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * CD_NT;
      if (j < S) g[j] = g[j] - delta * qv[u];
    }
  }
}

// The listed slots (valid and active) into list and the others into rest,
// both ascending, by a block prefix sum over the consumers (warp ballots,
// then one thread adds the warp counts); returns the count listed.
__device__ int build_lists(int S, const uint8_t* v, const uint8_t* act,
                           int* list, int* rest, int* s_scan) {
  constexpr int NWARPS = CD_NT / 32;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int count = 0;
  for (int base = 0; base < S; base += CD_NT) {
    const int j = base + tid;
    const bool f = j < S && v[j] && act[j];
    const unsigned bal = __ballot_sync(0xffffffffu, f);
    if (lane == 0) s_scan[warp] = __popc(bal);
    consumer_sync();
    if (tid == 0) {
      int run = 0;
      for (int w = 0; w < NWARPS; ++w) {
        const int c = s_scan[w];
        s_scan[w] = run;
        run += c;
      }
      s_scan[NWARPS] = run;
    }
    consumer_sync();
    const int at = count + s_scan[warp] + __popc(bal & ((1u << lane) - 1u));
    if (j < S) {
      if (f)
        list[at] = j;
      else
        rest[j - at] = j;  // the slots before j not listed
    }
    count += s_scan[NWARPS];
    consumer_sync();  // s_scan is rewritten by the next tile
  }
  return count;
}

// One full sweep over every valid slot (the first K7's): then the prune
// if it converged, else the lists of the phase it opens.
template <typename T, int MODE, bool SMEM>
__device__ void full_stage(const CdArgs<T>& a, unsigned char* smem,
                           int* s_scan) {
  const int S = a.S;
  const int tid = threadIdx.x;
  double* st = a.st;
  if (st[ST_DONE] != 0.0 || st[ST_PHASE] != 0.0 ||
      st[ST_ITERS] >= (double)a.max_iters)
    return;
  T* b;
  T* g;
  const T* lo;
  const T* hi;
  const T* dg;
  const uint8_t* v;
  uint8_t* act;
  if (SMEM) {
    T* base = reinterpret_cast<T*>(smem);
    T* slo = base + 2 * (size_t)S;
    T* shi = base + 3 * (size_t)S;
    T* sd = base + 4 * (size_t)S;
    uint8_t* sv = reinterpret_cast<uint8_t*>(base + 5 * (size_t)S);
    b = base;
    g = base + S;
    act = sv + S;
    for (int j = tid; j < S; j += CD_NT) {
      slo[j] = a.lo[j];
      shi[j] = a.hi[j];
      sd[j] = a.diag[j];
      sv[j] = a.valid[j];
      b[j] = a.beta[j];
      g[j] = a.grad[j];
      act[j] = a.active[j];
    }
    lo = slo;
    hi = shi;
    dg = sd;
    v = sv;
  } else {
    b = a.beta;
    g = a.grad;
    act = a.active;
    lo = a.lo;
    hi = a.hi;
    dg = a.diag;
    v = a.valid;
  }
  // every thread carries the same scalars: the same reads, the same
  // arithmetic (st is read before the barrier, and written after the last)
  T loss = (T)st[ST_LOSS];
  consumer_sync();

  long long moves = 0;
  long long updates = 0;
  T convg = T(0);
  for (int i = 0; i < S; ++i) {
    if (!v[i]) continue;
    ++updates;
    const T d = dg[i];
    const T gi = g[i];
    const T bi = b[i];
    const T bn = cd_update<T, MODE>(d, gi, bi, lo[i], hi[i]);
    const T delta = bn - bi;
    if (!(delta != T(0))) continue;
    consumer_sync();  // every thread has read g[i], b[i] and act[i]
    const T sd2 = d * delta * delta;
    convg = nan_max(convg, sd2);
    loss = loss - (delta * gi - T(0.5) * sd2);
    ++moves;
    axpy_row(g, a.Qt + (size_t)i * S, delta, S, tid);
    if (tid == 0) {
      b[i] = bn;
      act[i] = 1;
    }
    consumer_sync();
  }
  const bool done = convg <= a.tol_scale;
  int na = 0;
  if (done) {
    for (int j = tid; j < S; j += CD_NT)
      act[j] = (act[j] && cd_keep<T, MODE>(b[j], lo[j], hi[j])) ? 1 : 0;
  } else {
    na = build_lists(S, v, act, a.list, a.rest, s_scan);
  }
  if (SMEM) {
    for (int j = tid; j < S; j += CD_NT) {
      a.beta[j] = b[j];
      a.grad[j] = g[j];
      a.active[j] = act[j];
    }
  }
  if (tid == 0) {
    st[ST_LOSS] = (double)loss;
    st[ST_ITERS] += 1.0;
    st[ST_DONE] = done ? 1.0 : 0.0;
    st[ST_MOVES] += (double)moves;
    st[ST_UPDATES] += (double)updates;
    if (!done) {
      st[ST_PHASE] = 1.0;
      st[ST_FRESH] = 1.0;
      st[ST_NA] = (double)na;
      st[ST_NR] = (double)(S - na);
      st[ST_PHASE_SWEEPS] = 0.0;
    }
  }
}

// The AXPY warps of an active segment (warps 1-3 and 5-7: thread t of
// AXPY_NT owning positions j = t (mod AXPY_NT)): after each update's
// barrier, the delta into the log, the row before released (once it has
// landed), and the update's move applied to every position but the
// update's own and the next one's (the chain does those), its row from
// the ring.  No AXPY warp shares a scheduler with the chain (warp w issues on
// scheduler w mod 4; warps 4 and 8 stay idle), so the chain's latency-bound
// instructions do not wait behind theirs.
template <typename T, bool RING>
__device__ void axpy_role(const CdArgs<T>& a, const T* ring, int R, int ldc,
                          int na, int t, uint64_t* s_full, uint64_t* s_empty,
                          const T* s_delta, const int* s_cmd, T* gc) {
  int slot = 0;
  unsigned rpar = 0;
  int prev_slot = -1;  // the row of the update before
  unsigned prev_par = 0;
  bool prev_waited = false;
  unsigned par = 0;
  T* logp = a.log;
  bool cont = true;
  while (cont) {
    for (int k = 0; k < na; ++k) {
      active_sync();
      const T d = s_delta[par];
      if (k == na - 1) cont = s_cmd[par] != 0;
      par ^= 1u;
      if (t == 1) logp[k] = d;
      // the row before is read by all: release it (once it has landed)
      if (RING && t == 0 && prev_slot >= 0) {
        if (!prev_waited) mbar_wait(&s_full[prev_slot], prev_par);
        mbar_arrive(&s_empty[prev_slot]);
      }
      bool waited = false;
      if (d != T(0)) {
        const T* row;
        if (RING) {
          mbar_wait(&s_full[slot], rpar);
          waited = true;
          row = ring + (size_t)slot * ldc;
        } else {
          row = a.Qc + (size_t)k * ldc;
        }
        // the positions the chain does itself: k, and the next one unless
        // the segment ends at k
        const int nxt = k + 1 < na ? k + 1 : (cont && na > 1 ? 0 : k);
        for (int j0 = t; j0 < na; j0 += AXPY_NT * AXPY_BATCH) {
          T gv[AXPY_BATCH], qv[AXPY_BATCH];
#pragma unroll
          for (int u = 0; u < AXPY_BATCH; ++u) {
            const int j = j0 + u * AXPY_NT;
            if (j < na) {
              gv[u] = gc[j];
              qv[u] = row[j];
            }
          }
#pragma unroll
          for (int u = 0; u < AXPY_BATCH; ++u) {
            const int j = j0 + u * AXPY_NT;
            if (j < na && j != k && j != nxt) gc[j] = gv[u] - d * qv[u];
          }
        }
      }
      prev_slot = slot;
      prev_par = rpar;
      prev_waited = waited;
      if (RING && ++slot == R) {
        slot = 0;
        rpar ^= 1u;
      }
    }
    logp += na;
  }
}

// One segment of the open active phase, on its compact block: at most L
// whole sweeps, each listed update's delta into the log; then the compact
// state back into the fit's, and the prune if the phase ended.
//
// Three roles.  Warp 0, the chain, runs the updates: for update k it
// applies the previous update's move to position k itself (Qc's element
// after the diagonal, kept in qn), computes the update's scalars, applies
// its own move to position k (Qc's diagonal, kept in qd), writes grad[k],
// beta[k] and the broadcast slot, loads the next update's constants, and
// crosses the update's one barrier.  The AXPY warps apply each move to
// every other position while the chain runs the next update: move k's
// AXPY skips position k (done by the chain) and the position after it
// (done by the chain at the next update, unless the segment ends there),
// and ends before the next barrier, so the chain reads each position after
// every earlier move but the last has reached it.  Warp 9 keeps the ring
// of Qc's rows full.
template <typename T, int MODE, int LAYOUT>
__device__ void active_stage(const CdArgs<T>& a, unsigned char* smem, int R,
                             uint64_t* s_full, uint64_t* s_empty,
                             volatile int* s_stop,
                             volatile long long* s_need, T* s_delta,
                             int* s_cmd, int* s_closed) {
  constexpr bool RING = LAYOUT != LAYOUT_GLOBAL;
  constexpr bool VSMEM = LAYOUT == LAYOUT_SMEM;
  const int tid = threadIdx.x;
  double* st = a.st;
  const int S = a.S;
  const int na = (int)st[ST_NA];
  const int ldc = cd_ldc(na);
  const long long fit_log = a.log_cap / (na > 0 ? na : 1);
  const int L = (int)(fit_log < a.log_sweeps ? fit_log : a.log_sweeps);
  T* ring = reinterpret_cast<T*>(smem);
  T* vec = VSMEM ? ring + (size_t)R * ldc : a.cvec;
  T* gc = vec;
  T* bc = vec + ldc;
  T* dc = vec + 2 * (size_t)ldc;
  T* lc = vec + 3 * (size_t)ldc;
  T* hc = vec + 4 * (size_t)ldc;
  T* qd = vec + 5 * (size_t)ldc;  // Qc[k, k]
  T* qn = vec + 6 * (size_t)ldc;  // Qc[k, k + 1], Qc[na - 1, 0] last
  const unsigned row_bytes = (unsigned)(ldc * sizeof(T));
  // every thread reads the state before the first barrier; it is written
  // after the last
  T loss = (T)st[ST_LOSS];
  T convg_last = (T)st[ST_CONVG];
  int it = (int)st[ST_ITERS];
  int ps = (int)st[ST_PHASE_SWEEPS];

  if (tid == 0) {
    if (RING) {
      for (int r = 0; r < R; ++r) {
        mbar_init(&s_full[r], 1);
        mbar_init(&s_empty[r], 1);
      }
      mbar_init_fence();
    }
    *s_stop = 0;
    *s_need = 0;
  }
  for (int k = tid; k < na; k += CD_THREADS) {
    const int j = a.list[k];
    const T* qrow = a.Qc + (size_t)k * ldc;
    gc[k] = a.grad[j];
    bc[k] = a.beta[j];
    dc[k] = a.diag[j];
    lc[k] = a.lo[j];
    hc[k] = a.hi[j];
    qd[k] = qrow[k];
    qn[k] = qrow[k + 1 < na ? k + 1 : 0];
  }
  __syncthreads();

  // The producer: lane 0 of the last warp copies row u % na of Qc into
  // slot u % R for u = 0, 1, ..., at most L sweeps of rows, each once the
  // slot's last row has been released (a release follows the row's
  // landing, so a slot's mbarriers advance one phase at a time).  It stops
  // once the chain has published its stop and the count of rows the
  // segment reads (its sweeps times na), and it has issued them all: a
  // row the consumers wait for is always issued, however far behind the
  // producer is when the chain ends (row u's slot is released at update
  // u - R + 1, which every u below the count reaches).  It then waits
  // for every copy it issued.
  if (tid >= CD_THREADS - 32) {
    if (RING && tid == CD_THREADS - 32 && na > 0) {
      const long long total = (long long)L * na;
      long long issued = 0;
      int slot = 0;
      unsigned use = 0;  // the slot's use number
      int row = 0;
      // whether row u is past the rows the segment reads
      auto past = [&](long long u) {
        if (!*s_stop) return false;
        __threadfence_block();  // the count was written before the stop
        return u >= *s_need;
      };
      for (long long u = 0; u < total; ++u) {
        if (use > 0) {
          bool stop = false;
          while (!mbar_test(&s_empty[slot], (use - 1) & 1u)) {
            if (past(u)) {
              stop = true;
              break;
            }
          }
          if (stop) break;
        }
        if (past(u)) break;
        fence_proxy_async();
        mbar_expect_tx(&s_full[slot], row_bytes);
        bulk_copy(ring + (size_t)slot * ldc, a.Qc + (size_t)row * ldc,
                  row_bytes, &s_full[slot]);
        issued = u + 1;
        if (++row == na) row = 0;
        if (++slot == R) {
          slot = 0;
          ++use;
        }
      }
      for (long long u = issued > R ? issued - R : 0; u < issued; ++u)
        mbar_wait(&s_full[u % R], (unsigned)((u / R) & 1));
    }
    __syncwarp();
    __syncthreads();  // the consumers' stop
    return;
  }

  // the twin's active loop: one sweep, then more while convg > tol_scale
  // and the count is below max_iters; a segment also stops at L sweeps
  bool closed = ps > 0 && !(convg_last > a.tol_scale && it < a.max_iters);
  int nsw = 0;
  long long moves = 0;
  long long updates = 0;
  if (!closed && tid < 32) {
    // the chain (every lane the same values; lane 0 writes).  An update's
    // constants are loaded before the barrier before it; only grad waits
    // for the barrier.
    const bool lead = tid == 0;
    const bool carry = na > 1;  // a move reaches the next position
    T cprod = T(0);             // the last move's product at this position
    bool cmoved = false;
    unsigned par = 0;
    bool cont = true;
    T d = T(0), bi = T(0), lo = T(0), hi = T(0), q_kk = T(0), q_next = T(0);
    if (na > 0) {
      d = dc[0];
      bi = bc[0];
      lo = lc[0];
      hi = hc[0];
      q_kk = qd[0];
      q_next = qn[0];
    }
    while (cont) {
      T convg = T(0);
      if (na == 0) {
        ++it;
        ++nsw;
        ++ps;
        convg_last = convg;
        closed = !(convg > a.tol_scale && it < a.max_iters);
        cont = !closed && nsw < L;
        continue;
      }
      for (int k = 0; k < na; ++k) {
        ++updates;
        T x = gc[k];
        if (carry && cmoved) x = x - cprod;
        const T bn = cd_update<T, MODE>(d, x, bi, lo, hi);
        const T delta = bn - bi;
        const bool moved = delta != T(0);
        T xk = x;
        if (moved) {
          const T sd2 = d * delta * delta;
          convg = nan_max(convg, sd2);
          loss = loss - (delta * x - T(0.5) * sd2);
          ++moves;
          xk = x - delta * q_kk;
          cprod = delta * q_next;
        }
        cmoved = moved;
        if (k == na - 1) {
          ++it;
          ++nsw;
          ++ps;
          convg_last = convg;
          closed = !(convg > a.tol_scale && it < a.max_iters);
          cont = !closed && nsw < L;
        }
        if (lead) {
          gc[k] = xk;
          if (moved) bc[k] = bn;
          s_delta[par] = moved ? delta : T(0);
          if (k == na - 1) s_cmd[par] = cont ? 1 : 0;
        }
        // the next update's constants (its beta is this one's if na is 1)
        const int kn = k + 1 < na ? k + 1 : 0;
        d = dc[kn];
        bi = kn == k ? (moved ? bn : bi) : bc[kn];
        lo = lc[kn];
        hi = hc[kn];
        q_kk = qd[kn];
        q_next = qn[kn];
        active_sync();  // the update's one barrier
        par ^= 1u;
      }
    }
  } else if (!closed && na > 0) {
    const int w = tid >> 5;
    if ((w & 3) != 0)  // warps 1-3 and 5-7
      axpy_role<T, RING>(a, ring, R, ldc, na, (w - 1 - (w >> 2)) * 32 +
                         (tid & 31), s_full, s_empty, s_delta, s_cmd, gc);
  }
  if (tid == 0) {
    // the rows the consumers read, then the stop (the producer reads them
    // in the other order)
    *s_need = (long long)nsw * na;
    __threadfence_block();
    *s_stop = 1;
    *s_closed = closed ? 1 : 0;  // the chain's verdict
  }
  __syncthreads();  // with the producer, whose copies have all landed
  closed = *s_closed != 0;

  for (int k = tid; k < na; k += CD_THREADS - 32) {
    const int j = a.list[k];
    a.grad[j] = gc[k];
    a.beta[j] = bc[k];
  }
  if (closed) {
    tail_sync();
    for (int j = tid; j < S; j += CD_THREADS - 32)
      a.active[j] =
          (a.active[j] && cd_keep<T, MODE>(a.beta[j], a.lo[j], a.hi[j])) ? 1
                                                                          : 0;
  }
  if (tid == 0) {
    st[ST_LOSS] = (double)loss;
    st[ST_ITERS] = (double)it;
    st[ST_MOVES] += (double)moves;
    st[ST_UPDATES] += (double)updates;
    st[ST_LIST_MOVES] += (double)moves;
    st[ST_LIST_UPDATES] += (double)updates;
    st[ST_PHASE_SWEEPS] = (double)ps;
    st[ST_LOGGED] = (double)nsw;
    st[ST_CONVG] = (double)convg_last;
    st[ST_FRESH] = 0.0;
    if (closed) st[ST_PHASE] = 0.0;
  }
}

// The chain: one block of CD_THREADS, a full sweep (stage STAGE_FULL) or a
// segment of the open active phase (STAGE_ACTIVE); either does nothing
// when the fit's state says there is nothing to do.
template <typename T, int MODE>
__global__ void __launch_bounds__(CD_THREADS)
    screened_cd_kernel(const CdArgs<T> a, int stage) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t s_full[RING_MAX];   // a slot's row has landed
  __shared__ uint64_t s_empty[RING_MAX];  // a slot's row has been read
  __shared__ int s_scan[CD_NT / 32 + 1];
  __shared__ int s_stop;
  __shared__ long long s_need;  // rows of Qc the segment's consumers read
  __shared__ T s_delta[2];  // an update's delta, double-buffered
  __shared__ int s_cmd[2];  // after a sweep's last update: 1 if another follows
  __shared__ int s_closed;
  if (stage == STAGE_FULL) {
    if (threadIdx.x >= CD_NT) return;
    if (a.smem >= cd_smem_bytes(a.S, (int)sizeof(T)))
      full_stage<T, MODE, true>(a, smem, s_scan);
    else
      full_stage<T, MODE, false>(a, smem, s_scan);
    return;
  }
  if (a.st[ST_PHASE] == 0.0) {
    if (threadIdx.x == 0) a.st[ST_LOGGED] = 0.0;
    return;
  }
  int R;
  const int layout = active_layout((int)a.st[ST_NA], (int)sizeof(T), a.smem,
                                   a.layout, a.ring, &R);
  if (layout == LAYOUT_SMEM)
    active_stage<T, MODE, LAYOUT_SMEM>(a, smem, R, s_full, s_empty, &s_stop,
                                       &s_need, s_delta, s_cmd, &s_closed);
  else if (layout == LAYOUT_RING)
    active_stage<T, MODE, LAYOUT_RING>(a, smem, R, s_full, s_empty, &s_stop,
                                       &s_need, s_delta, s_cmd, &s_closed);
  else
    active_stage<T, MODE, LAYOUT_GLOBAL>(a, smem, R, s_full, s_empty,
                                         &s_stop, &s_need, s_delta, s_cmd,
                                         &s_closed);
}

// The gather: Qc[k, c] = Q^T[list[k], list[c]] for the phase that just
// opened, one row a block in turn.
template <typename T>
__global__ void __launch_bounds__(GATHER_NT)
    screened_cd_gather_kernel(const T* __restrict__ Qt,
                              const int* __restrict__ list,
                              const double* __restrict__ st, T* Qc, int S) {
  if (st[ST_FRESH] == 0.0) return;
  const int na = (int)st[ST_NA];
  const int ldc = cd_ldc(na);
  for (int k = blockIdx.x; k < na; k += gridDim.x) {
    const T* src = Qt + (size_t)list[k] * S;
    T* dst = Qc + (size_t)k * ldc;
    for (int c = threadIdx.x; c < na; c += GATHER_NT) dst[c] = src[list[c]];
  }
}

// g -= d q over n logged deltas in order (q(k) the listed row k's value in
// this slot's column, k the position after the last entry applied),
// skipping a delta that is exactly 0: the twin's operations on this slot,
// each a product then a subtraction
template <typename T, typename Q>
__device__ __forceinline__ T replay_slot(T g, const T* d_log, int n, int na,
                                         int& k, Q q) {
  int e = 0;
  for (; e + REPLAY_UNROLL <= n; e += REPLAY_UNROLL) {
    T d[REPLAY_UNROLL], x[REPLAY_UNROLL];
#pragma unroll
    for (int u = 0; u < REPLAY_UNROLL; ++u) {
      d[u] = d_log[e + u];
      x[u] = q(k);
      if (++k == na) k = 0;
    }
#pragma unroll
    for (int u = 0; u < REPLAY_UNROLL; ++u)
      if (d[u] != T(0)) g = g - d[u] * x[u];
  }
  for (; e < n; ++e) {
    const T d = d_log[e];
    if (d != T(0)) g = g - d * q(k);
    if (++k == na) k = 0;
  }
  return g;
}

// The replay: the logged sweeps' moves applied to every slot not listed,
// one thread a slot, the blocks' tiles of slots spread over the grid.  A
// tile stages the listed rows of its slots' columns of Q^T in shared
// memory when they fit, else reads them from L2; the block reads the log
// into shared memory a chunk at a time, so that each slot's chain reads
// its deltas there.  What bounds it is that chain: one dependent
// subtraction a logged update, for every slot at once.
template <typename T>
__global__ void __launch_bounds__(REPLAY_NT)
    screened_cd_replay_kernel(const T* __restrict__ Qt,
                              const int* __restrict__ list,
                              const int* __restrict__ rest, T* grad,
                              const T* __restrict__ log,
                              const double* __restrict__ st, int S,
                              int smem_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nsw = (int)st[ST_LOGGED];
  const int na = (int)st[ST_NA];
  const int nr = (int)st[ST_NR];
  if (nsw == 0 || na == 0 || nr == 0) return;
  const long long n = (long long)nsw * na;
  T* chunk = reinterpret_cast<T*>(smem);  // REPLAY_CHUNK logged deltas
  T* Qs = chunk + REPLAY_CHUNK;
  const int fit =
      (smem_bytes - REPLAY_CHUNK * (int)sizeof(T)) / (na * (int)sizeof(T));
  const bool staged = fit >= 1;
  int tile = (nr + gridDim.x - 1) / gridDim.x;
  if (tile > REPLAY_NT) tile = REPLAY_NT;
  if (staged && tile > fit) tile = fit;
  const int t = threadIdx.x;
  for (int r0 = blockIdx.x * tile; r0 < nr; r0 += gridDim.x * tile) {
    const int m = nr - r0 < tile ? nr - r0 : tile;
    if (staged) {
      __syncthreads();  // the tile before is done with Qs
      for (int e = t; e < na * m; e += REPLAY_NT) {
        const int k = e / m;
        const int c = e - k * m;
        Qs[(size_t)k * tile + c] = Qt[(size_t)list[k] * S + rest[r0 + c]];
      }
    }
    const int j = t < m ? rest[r0 + t] : 0;
    T g = t < m ? grad[j] : T(0);
    int k = 0;
    for (long long c0 = 0; c0 < n; c0 += REPLAY_CHUNK) {
      const int cn = (int)(n - c0 < REPLAY_CHUNK ? n - c0 : REPLAY_CHUNK);
      __syncthreads();  // the chunk before is done (and Qs staged)
      for (int e = t; e < cn; e += REPLAY_NT) chunk[e] = log[c0 + e];
      __syncthreads();
      if (t < m) {
        if (staged)
          g = replay_slot(g, chunk, cn, na, k,
                          [&](int kk) { return Qs[(size_t)kk * tile + t]; });
        else
          g = replay_slot(g, chunk, cn, na, k, [&](int kk) {
            return Qt[(size_t)list[kk] * S + j];
          });
      }
    }
    if (t < m) grad[j] = g;
  }
}

// above 48 KB a block's dynamic shared memory must be opted into, once
// per kernel
template <typename K>
int opt_in(K kernel, int bytes, int* opted) {
  if (bytes > *opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    *opted = bytes;
  }
  return 0;
}

template <typename T, int MODE>
int launch_chain(const CdArgs<T>& args, int stage, cudaStream_t stream) {
  auto kernel = screened_cd_kernel<T, MODE>;
  static int opted = 0;
  const int e = opt_in(kernel, args.smem, &opted);
  if (e) return e;
  kernel<<<1, CD_THREADS, args.smem, stream>>>(args, stage);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_step(const void* Qt, void* Qc, const void* diag, const void* lo,
                const void* hi, const void* valid, void* beta, void* grad,
                void* active, void* list, void* rest, void* cvec, void* log,
                void* st, int S, int mode, int stage, T tol_scale,
                int max_iters, long long log_cap, int log_sweeps, int layout,
                int ring, void* stream) {
  // the log holds a sweep of the longest list at least (the host sizes
  // it once a phase from the list's length)
  if (S < 1 || (mode != MODE_BOX && mode != MODE_PINBALL) ||
      (stage != STAGE_FULL && stage != STAGE_ACTIVE) || log_cap < 1 ||
      log_sweeps < 1 || layout < -1 || layout > LAYOUT_SMEM || ring < 0 ||
      ring == 1)
    return (int)cudaErrorInvalidValue;
  CdArgs<T> args;
  args.Qt = (const T*)Qt;
  args.Qc = (T*)Qc;
  args.diag = (const T*)diag;
  args.lo = (const T*)lo;
  args.hi = (const T*)hi;
  args.valid = (const uint8_t*)valid;
  args.beta = (T*)beta;
  args.grad = (T*)grad;
  args.active = (uint8_t*)active;
  args.list = (int*)list;
  args.rest = (int*)rest;
  args.cvec = (T*)cvec;
  args.log = (T*)log;
  args.st = (double*)st;
  args.S = S;
  args.tol_scale = tol_scale;
  args.max_iters = max_iters;
  args.log_cap = log_cap;
  args.log_sweeps = log_sweeps;
  args.layout = layout;
  args.ring = ring;
  const int elem = (int)sizeof(T);
  if (stage == STAGE_FULL) {
    const long long need = cd_smem_bytes(S, elem);
    args.smem = need <= SMEM_DYN ? (int)need : 0;
  } else {
    // the most the layout of any na <= S takes
    const long long row = (long long)cd_ldc(S) * elem;
    const long long most = (CD_VECS + RING_MAX) * row;
    args.smem = most < SMEM_DYN ? (int)most : SMEM_DYN;
  }
  cudaStream_t s = (cudaStream_t)stream;
  return mode == MODE_BOX ? launch_chain<T, MODE_BOX>(args, stage, s)
                          : launch_chain<T, MODE_PINBALL>(args, stage, s);
}

template <typename T>
int launch_gather(const void* Qt, const void* list, const void* st, void* Qc,
                  int S, void* stream) {
  if (S < 1) return (int)cudaErrorInvalidValue;
  const int blocks = S < GATHER_BLOCKS ? S : GATHER_BLOCKS;
  screened_cd_gather_kernel<T><<<blocks, GATHER_NT, 0,
                                 (cudaStream_t)stream>>>(
      (const T*)Qt, (const int*)list, (const double*)st, (T*)Qc, S);
  return (int)cudaGetLastError();
}

int multiprocessors() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || n < 1)
    return 132;
  return n;
}

template <typename T>
int launch_replay(const void* Qt, const void* list, const void* rest,
                  void* grad, const void* log, const void* st, int S,
                  void* stream) {
  if (S < 1) return (int)cudaErrorInvalidValue;
  auto kernel = screened_cd_replay_kernel<T>;
  static int opted = 0;
  const int e = opt_in(kernel, SMEM_DYN, &opted);
  if (e) return e;
  kernel<<<multiprocessors(), REPLAY_NT, SMEM_DYN, (cudaStream_t)stream>>>(
      (const T*)Qt, (const int*)list, (const int*)rest, (T*)grad,
      (const T*)log, (const double*)st, S, SMEM_DYN);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One chain launch: stage 0 a full sweep, 1 a segment of the active phase
// (log_cap deltas in the log, at least a sweep of the open phase's list;
// layout -1 and ring 0 unless a check forces a smaller layout or ring).
int adelie_screened_cd_solve_f32(
    const void* Qt, void* Qc, const void* diag, const void* lo,
    const void* hi, const void* valid, void* beta, void* grad, void* active,
    void* list, void* rest, void* cvec, void* log, void* st, int S, int mode,
    int stage, float tol_scale, int max_iters, long long log_cap,
    int log_sweeps, int layout, int ring, void* stream) {
  return launch_step<float>(Qt, Qc, diag, lo, hi, valid, beta, grad, active,
                            list, rest, cvec, log, st, S, mode, stage,
                            tol_scale, max_iters, log_cap, log_sweeps, layout,
                            ring, stream);
}

int adelie_screened_cd_solve_f64(
    const void* Qt, void* Qc, const void* diag, const void* lo,
    const void* hi, const void* valid, void* beta, void* grad, void* active,
    void* list, void* rest, void* cvec, void* log, void* st, int S, int mode,
    int stage, double tol_scale, int max_iters, long long log_cap,
    int log_sweeps, int layout, int ring, void* stream) {
  return launch_step<double>(Qt, Qc, diag, lo, hi, valid, beta, grad, active,
                             list, rest, cvec, log, st, S, mode, stage,
                             tol_scale, max_iters, log_cap, log_sweeps,
                             layout, ring, stream);
}

int adelie_screened_cd_gather_f32(const void* Qt, const void* list,
                                  const void* st, void* Qc, int S,
                                  void* stream) {
  return launch_gather<float>(Qt, list, st, Qc, S, stream);
}

int adelie_screened_cd_gather_f64(const void* Qt, const void* list,
                                  const void* st, void* Qc, int S,
                                  void* stream) {
  return launch_gather<double>(Qt, list, st, Qc, S, stream);
}

int adelie_screened_cd_replay_f32(const void* Qt, const void* list,
                                  const void* rest, void* grad,
                                  const void* log, const void* st, int S,
                                  void* stream) {
  return launch_replay<float>(Qt, list, rest, grad, log, st, S, stream);
}

int adelie_screened_cd_replay_f64(const void* Qt, const void* list,
                                  const void* rest, void* grad,
                                  const void* log, const void* st, int S,
                                  void* stream) {
  return launch_replay<double>(Qt, list, rest, grad, log, st, S, stream);
}

// 1 when a full sweep of S slots keeps its vectors in shared memory
int adelie_screened_cd_in_smem(int S, int elem_bytes) {
  return cd_smem_bytes(S, elem_bytes) <= SMEM_DYN ? 1 : 0;
}

// the active phase's layout for na listed slots at S >= na (2: vectors
// and ring in shared memory, 1: the ring only, 0: neither), and the
// ring's rows in *depth
int adelie_screened_cd_active_layout(int na, int S, int elem_bytes,
                                     int* depth) {
  const long long row = (long long)cd_ldc(S) * elem_bytes;
  const long long most = (CD_VECS + RING_MAX) * row;
  const int budget = most < SMEM_DYN ? (int)most : SMEM_DYN;
  return active_layout(na, elem_bytes, budget, -1, 0, depth);
}

}  // extern "C"
