// The screened coordinate-descent kernel (K7) for Hopper (sm_90a).
//
// K7 runs the whole fit of the standalone solvers' screened problem in one
// launch and one thread block, templated on float and double and on the
// update (BVLS's box, pinball's asymmetric soft threshold), with a plain C
// interface loaded by ctypes from
// adelie_tpu_torch/solver/screened_cd_kernels.py.  The entry point launches
// on the caller's stream, allocates nothing and returns cudaGetLastError().
//
// What it replaces: not a Pallas kernel.  The JAX package runs this fit as
// one XLA device program, adelie_tpu/solver/screened_cd.py:screened_cd_fit
// (:45-141), a while_loop of fori_loops over the screened atoms whose body
// branches with lax.cond.  PyTorch has no device loop, so without a kernel
// every coordinate would be several launches and a host read.
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
// so the update reads column i, as the JAX loop does.  The kernel takes
// Q^T row-major, so column i of Q is row i of its argument, contiguous.
//
// What bounds it: the serial chain.  Update i needs the gradient every
// earlier update left, so one fit is one block on one SM.  Every thread
// computes the update's scalars itself from the same shared values, so a
// coordinate that does not move costs no barrier and no broadcast.  A
// moving one costs two barriers: one after every thread has read its
// scalars, before the slot is written, and one after the AXPY over the
// row of Q^T (coalesced, S elements read once, eight loads a thread in
// flight before the first is used).  The active slots do not change
// during an active phase (a moving update only flags a slot already
// active), so the phase lists them once and its sweeps walk the list; a
// listed update asks L2 for the next listed row before its own scalars.
// grad, beta, the bounds, the diagonal, the list and the two flag arrays
// live in shared memory when they fit (5 S values, S ints and 2 S
// bytes), else in global memory.  A simple kernel first: its time beside
// its bound is in PERF.md.
//
// Rounding: every operation is the twin's (screened_cd_solve_ref) in the
// same order, one rounding each; the build has -fmad=false, so the twin
// and the kernel take the same path bit for bit.
//
// info (double): loss, sweeps (iters0 included), converged, moving
// updates, updates (the slots visited, moving or not).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int CD_NT = 256;           // threads of the block
constexpr int SMEM_MAX = 232448;     // a block's shared memory on the H100

enum { MODE_BOX = 0, MODE_PINBALL = 1 };

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

template <typename T>
struct CdArgs {
  const T* Qt;           // (S, S): row i is column i of Q
  int* list;             // (S,) scratch: the active list past shared memory
  const T* diag;
  const T* beta0;
  const T* grad0;
  const T* lo;
  const T* hi;
  const uint8_t* valid;
  const uint8_t* active0;
  T* beta;
  T* grad;
  uint8_t* active;
  double* info;
  int S;
  T loss0;
  T tol_scale;
  int max_iters;
  int iters0;
};

// shared-memory layout: beta, grad, lo, hi, diag (S values each), the
// active list (S ints), then the valid and active flags (S bytes each)
__host__ __device__ inline size_t cd_smem_bytes(int S, int elem) {
  return (size_t)5 * S * elem + (size_t)4 * S + (size_t)2 * S;
}

// ask L2 for a row of Q^T, one 128-byte line a thread at a time
template <typename T>
__device__ __forceinline__ void prefetch_row(const T* row, int S, int tid) {
  constexpr int LINE = 128 / (int)sizeof(T);
  for (int j = tid * LINE; j < S; j += CD_NT * LINE)
    asm volatile("prefetch.L2 [%0];" ::"l"(row + j));
}

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

template <typename T, int MODE, bool SMEM>
__global__ void __launch_bounds__(CD_NT)
    screened_cd_kernel(const CdArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_count;
  const int S = a.S;
  const int tid = threadIdx.x;
  T* b;
  T* g;
  const T* lo;
  const T* hi;
  const T* dg;
  int* lst;
  const uint8_t* v;
  uint8_t* act;
  if (SMEM) {
    T* base = reinterpret_cast<T*>(smem);
    T* slo = base + 2 * (size_t)S;
    T* shi = base + 3 * (size_t)S;
    T* sd = base + 4 * (size_t)S;
    lst = reinterpret_cast<int*>(base + 5 * (size_t)S);
    uint8_t* sv = reinterpret_cast<uint8_t*>(lst + S);
    b = base;
    g = base + S;
    act = sv + S;
    for (int j = tid; j < S; j += CD_NT) {
      slo[j] = a.lo[j];
      shi[j] = a.hi[j];
      sd[j] = a.diag[j];
      sv[j] = a.valid[j];
    }
    lo = slo;
    hi = shi;
    dg = sd;
    v = sv;
  } else {
    b = a.beta;
    g = a.grad;
    act = a.active;
    lst = a.list;
    lo = a.lo;
    hi = a.hi;
    dg = a.diag;
    v = a.valid;
  }
  for (int j = tid; j < S; j += CD_NT) {
    b[j] = a.beta0[j];
    g[j] = a.grad0[j];
    act[j] = a.active0[j] ? 1 : 0;
  }
  __syncthreads();

  // every thread carries the same scalars: the same reads, the same
  // arithmetic
  T loss = a.loss0;
  long long moves = 0;
  long long updates = 0;

  // the update of slot i; convg takes its d delta^2 if it moves
  auto visit = [&](int i, T& convg) {
    ++updates;
    const T d = dg[i];
    const T gi = g[i];
    const T bi = b[i];
    const T bn = cd_update<T, MODE>(d, gi, bi, lo[i], hi[i]);
    const T delta = bn - bi;
    if (!(delta != T(0))) return;
    __syncthreads();  // every thread has read g[i], b[i] and act[i]
    const T sd2 = d * delta * delta;
    convg = nan_max(convg, sd2);
    loss = loss - (delta * gi - T(0.5) * sd2);
    ++moves;
    axpy_row(g, a.Qt + (size_t)i * S, delta, S, tid);
    if (tid == 0) {
      b[i] = bn;
      act[i] = 1;
    }
    __syncthreads();
  };

  // every valid slot in order
  auto full_sweep = [&]() -> T {
    T convg = T(0);
    for (int i = 0; i < S; ++i)
      if (v[i]) visit(i, convg);
    return convg;
  };

  // the listed (active) slots in order
  auto list_sweep = [&](int n) -> T {
    T convg = T(0);
    for (int k = 0; k < n; ++k) {
      prefetch_row(a.Qt + (size_t)lst[k + 1 < n ? k + 1 : 0] * S, S, tid);
      visit(lst[k], convg);
    }
    return convg;
  };

  int it = a.iters0;
  bool done = false;
  while (!done && it < a.max_iters) {
    T convg = full_sweep();
    ++it;
    done = convg <= a.tol_scale;
    if (!done) {
      // the active phase: its slots, in ascending order, listed once
      if (tid == 0) {
        int n = 0;
        for (int i = 0; i < S; ++i)
          if (v[i] && act[i]) lst[n++] = i;
        s_count = n;
      }
      __syncthreads();
      const int na = s_count;
      convg = list_sweep(na);
      ++it;
      while (convg > a.tol_scale && it < a.max_iters) {
        convg = list_sweep(na);
        ++it;
      }
    }
    for (int j = tid; j < S; j += CD_NT) {
      const bool keep = MODE == MODE_BOX ? (b[j] > lo[j] && b[j] < hi[j])
                                         : b[j] != T(0);
      act[j] = (act[j] && keep) ? 1 : 0;
    }
    __syncthreads();
  }

  if (SMEM) {
    for (int j = tid; j < S; j += CD_NT) {
      a.beta[j] = b[j];
      a.grad[j] = g[j];
      a.active[j] = act[j];
    }
  }
  if (tid == 0) {
    a.info[0] = (double)loss;
    a.info[1] = (double)it;
    a.info[2] = done ? 1.0 : 0.0;
    a.info[3] = (double)moves;
    a.info[4] = (double)updates;
  }
}

template <typename T, int MODE, bool SMEM>
int launch_cd(const CdArgs<T>& args, cudaStream_t stream) {
  auto kernel = screened_cd_kernel<T, MODE, SMEM>;
  const int bytes = SMEM ? (int)cd_smem_bytes(args.S, (int)sizeof(T)) : 0;
  // above 48 KB a block's dynamic shared memory must be opted into, once
  // per kernel
  static int opted_in = 0;
  if (bytes > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    opted_in = bytes;
  }
  kernel<<<1, CD_NT, bytes, stream>>>(args);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_screened_cd(const void* Qt, const void* diag, const void* beta0,
                       const void* grad0, const void* lo, const void* hi,
                       const void* valid, const void* active0, void* beta,
                       void* grad, void* active, void* info, void* list,
                       int S, int mode, T loss, T tol_scale, int max_iters,
                       int iters0, void* stream) {
  if (S < 1 || (mode != MODE_BOX && mode != MODE_PINBALL))
    return (int)cudaErrorInvalidValue;
  CdArgs<T> args;
  args.Qt = (const T*)Qt;
  args.list = (int*)list;
  args.diag = (const T*)diag;
  args.beta0 = (const T*)beta0;
  args.grad0 = (const T*)grad0;
  args.lo = (const T*)lo;
  args.hi = (const T*)hi;
  args.valid = (const uint8_t*)valid;
  args.active0 = (const uint8_t*)active0;
  args.beta = (T*)beta;
  args.grad = (T*)grad;
  args.active = (uint8_t*)active;
  args.info = (double*)info;
  args.S = S;
  args.loss0 = loss;
  args.tol_scale = tol_scale;
  args.max_iters = max_iters;
  args.iters0 = iters0;
  cudaStream_t st = (cudaStream_t)stream;
  const bool in_smem = cd_smem_bytes(S, (int)sizeof(T)) <= SMEM_MAX;
  if (mode == MODE_BOX)
    return in_smem ? launch_cd<T, MODE_BOX, true>(args, st)
                   : launch_cd<T, MODE_BOX, false>(args, st);
  return in_smem ? launch_cd<T, MODE_PINBALL, true>(args, st)
                 : launch_cd<T, MODE_PINBALL, false>(args, st);
}

}  // namespace

extern "C" {

int adelie_screened_cd_solve_f32(
    const void* Qt, const void* diag, const void* beta0, const void* grad0,
    const void* lo, const void* hi, const void* valid, const void* active0,
    void* beta, void* grad, void* active, void* info, void* list, int S,
    int mode, float loss, float tol_scale, int max_iters, int iters0,
    void* stream) {
  return launch_screened_cd<float>(Qt, diag, beta0, grad0, lo, hi, valid,
                                   active0, beta, grad, active, info, list, S,
                                   mode, loss, tol_scale, max_iters, iters0,
                                   stream);
}

int adelie_screened_cd_solve_f64(
    const void* Qt, const void* diag, const void* beta0, const void* grad0,
    const void* lo, const void* hi, const void* valid, const void* active0,
    void* beta, void* grad, void* active, void* info, void* list, int S,
    int mode, double loss, double tol_scale, int max_iters, int iters0,
    void* stream) {
  return launch_screened_cd<double>(Qt, diag, beta0, grad0, lo, hi, valid,
                                    active0, beta, grad, active, info, list,
                                    S, mode, loss, tol_scale, max_iters,
                                    iters0, stream);
}

// 1 when a fit of S slots keeps its vectors in shared memory
int adelie_screened_cd_in_smem(int S, int elem_bytes) {
  return cd_smem_bytes(S, elem_bytes) <= SMEM_MAX ? 1 : 0;
}

}  // extern "C"
