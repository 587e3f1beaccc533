// Covariance-form lasso pin-solve kernels for Hopper (sm_90a).
//
// Two kernels, each templated on float and double (the H100 has native
// FP64), with a plain C interface loaded by ctypes from
// adelie_tpu_torch/solver/pin_kernels.py.  Every entry point launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().
//
// Both kernels run Gauss-Seidel coordinate descent on the screen Gram A
// (S x S, symmetric, row-major): update i needs the gradient that every
// earlier update left behind, so one solve is one serial chain of scalar
// updates, each followed by a row AXPY  grad -= delta * A[i, :].  That chain
// is the design constraint: ONE THREAD BLOCK PER SOLVE, on one SM.  Per
// update the block reads one row of A (L2 or HBM) and crosses one
// __syncthreads; nothing else is O(S).  The scalar results of an update
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
// K1: pin_lasso_solve                                                      //
// ------------------------------------------------------------------------ //
//
// Replaces adelie_tpu/solver/pin_pallas.py:pin_lasso_solve_pallas
// (_pin_kernel): the whole q = 1 pin solve at one lambda, S <= 1024.
// Active-phase sweeps (valid and active coordinates, at least one, until
// convg < tol_f, a floor-gated stall or max_iters), then one full sweep over
// the valid coordinates; repeat until a full sweep's convg < tol_f.  A NaN
// iterate ends the solve as a failure.
//
// What bounds it here: the TPU kernel kept the whole Gram in VMEM.  At
// S = 1024 the f32 Gram is 4 MB (8 MB in f64): it fits the 50 MB L2 but not
// the 227 KB of shared memory, so rows are read from L2/HBM, one per update.
// Thread j owns coordinate j (beta_j, grad_j, a_jj, p_j in registers), so an
// update's row read is one coalesced load of A[i, :] (valid since A is
// symmetric), issued before the barrier to overlap its latency.  The owner
// of coordinate i reads its own, current g_i with no extra barrier, because
// it is the only thread that ever writes grad_i.  Validity and activity
// flags sit in shared memory so every thread skips the same coordinates
// without a barrier; a skipped coordinate costs no barrier at all.  All loop
// scalars (rsq, convg, the slow count, iters, done) are computed
// identically by every thread, so control flow is block-uniform.

constexpr int K1_MAX_S = 1024;

template <typename T>
__global__ void __launch_bounds__(K1_MAX_S) pin_lasso_solve_kernel(
    const T* __restrict__ A, const T* __restrict__ diag,
    const T* __restrict__ penalty, const uint8_t* __restrict__ valid,
    const uint8_t* __restrict__ active0, const T* __restrict__ beta0,
    const T* __restrict__ grad0, T* __restrict__ beta_out,
    T* __restrict__ grad_out, uint8_t* __restrict__ active_out,
    T* __restrict__ info, int S, T l1, T l2, T tol, T rsq0, int max_iters) {
  __shared__ uint8_t s_valid[K1_MAX_S];
  __shared__ uint8_t s_active[K1_MAX_S];
  __shared__ T s_delta[2];
  __shared__ T s_drsq[2];
  __shared__ T s_dconv[2];

  const int j = threadIdx.x;
  const bool own = j < S;
  T b = own ? beta0[j] : T(0);
  T g = own ? grad0[j] : T(0);
  const T a_jj = own ? diag[j] : T(0);
  const T p_j = own ? penalty[j] : T(0);
  if (own) {
    s_valid[j] = valid[j];
    s_active[j] = active0[j];
  }

  // dtype-feasibility floor and floor-gated stall (pin_pallas.py:56-112)
  T lam_cap = T(0);
  for (int i = 0; i < S; ++i) lam_cap = nan_max(lam_cap, T(fabs(diag[i])));
  lam_cap = nan_max(lam_cap, T(1));
  const T eps = Eps<T>::value();
  const T tol_f = nan_max(tol, T(100) * lam_cap * ((T(10) * eps) * (T(10) * eps)));
  const T stall_floor = T(1e8) * lam_cap * eps * eps;
  __syncthreads();

  T rsq = rsq0;
  unsigned k = 0;  // processed-update counter: parity picks the shared slot

  auto sweep = [&](bool active_only) -> T {
    T convg = T(0);
    for (int i = 0; i < S; ++i) {
      if (!s_valid[i] || (active_only && !s_active[i])) continue;
      const T a_ij = own ? A[(size_t)i * S + j] : T(0);
      const unsigned slot = k & 1u;
      if (j == i) {
        const T bnew = soft_update(b, g, a_jj, p_j, l1, l2);
        const T d = bnew - b;
        s_delta[slot] = d;
        s_drsq[slot] = d * (T(2) * g - d * a_jj);
        s_dconv[slot] = a_jj * d * d;
        if (d != T(0)) {
          b = bnew;
          // only full sweeps can activate; nobody reads s_active in them
          if (!active_only) s_active[i] = 1;
        }
      }
      __syncthreads();
      const T d = s_delta[slot];
      if (d != T(0)) {
        g -= d * a_ij;
        rsq = rsq + s_drsq[slot];
        convg = nan_max(convg, s_dconv[slot]);
      }
      ++k;
    }
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
  while (!done && iters < max_iters && !stalled(slow, convg) &&
         convg == convg) {
    const T prev = convg;
    // active phase: always one sweep, then until convergence or stall
    T c = sweep(true);
    int a_slow = 0;
    int it = iters + 1;
    while (c >= tol_f && it < max_iters && !stalled(a_slow, c)) {
      const T a_prev = c;
      c = sweep(true);
      a_slow = next_slow(a_slow, c, a_prev);
      ++it;
    }
    iters = it;
    convg = sweep(false);
    slow = next_slow(slow, convg, prev);
    ++iters;
    done = convg < tol_f;
  }
  // a floor-gated stall is convergence at the dtype's floor; NaN is failure
  done = (done || stalled(slow, convg)) && convg == convg;

  if (own) {
    beta_out[j] = b;
    grad_out[j] = g;
    active_out[j] = s_active[j];
  }
  if (j == 0) {
    info[0] = rsq;
    info[1] = T(iters);
    info[2] = done ? T(1) : T(0);
  }
}

// ------------------------------------------------------------------------ //
// K2: cd_sweep_rows                                                        //
// ------------------------------------------------------------------------ //
//
// Replaces adelie_tpu/solver/pin_pallas.py:cd_sweep_rows_pallas
// (_cd_sweep_rows_kernel): one Gauss-Seidel pass over a fixed list of n
// updates (pos[k], akk[k], pk[k]), k < n, for screens past K1's S <= 1024.
// The block reads the list and n itself from device memory, so the caller
// never syncs to learn n.  beta and grad are updated in place.
//
// What bounds it here: per update one row of A (S values) from L2/HBM and
// one barrier.  Thread t owns the coordinates j = t (mod blockDim): it does
// their share of every row AXPY in grad (global memory, L1/L2 resident) and
// is therefore the only writer of grad[j] and beta[j], so the owner of
// pos[k] reads current values without an extra barrier.  No row prefetch
// yet: the TPU kernel's depth-4 row DMA ring is later work.

constexpr int K2_THREADS = 1024;

template <typename T>
__global__ void __launch_bounds__(K2_THREADS) cd_sweep_rows_kernel(
    const T* __restrict__ A, T* __restrict__ beta, T* __restrict__ grad,
    const int32_t* __restrict__ pos, const T* __restrict__ akk,
    const T* __restrict__ pk, const int32_t* __restrict__ n_ptr,
    uint8_t* __restrict__ moved, T* __restrict__ info, int S, int C, T l1,
    T l2, T rsq0) {
  __shared__ T s_delta[2];
  __shared__ T s_drsq[2];
  __shared__ T s_dconv[2];

  const int t = threadIdx.x;
  const int nthreads = blockDim.x;
  for (int k = t; k < C; k += nthreads) moved[k] = 0;
  int n = *n_ptr;
  n = n < C ? n : C;
  T rsq = rsq0;
  T convg = T(0);
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    const int p = pos[k];
    const int slot = k & 1;
    if (p % nthreads == t) {
      const T a = akk[k];
      const T b = beta[p];
      const T g = grad[p];
      const T bnew = soft_update(b, g, a, pk[k], l1, l2);
      const T d = bnew - b;
      beta[p] = bnew;
      moved[k] = d != T(0);
      s_delta[slot] = d;
      s_drsq[slot] = d * (T(2) * g - d * a);
      s_dconv[slot] = a * d * d;
    }
    __syncthreads();
    const T d = s_delta[slot];
    if (d != T(0)) {
      const T* __restrict__ row = A + (size_t)p * S;
      for (int j = t; j < S; j += nthreads) grad[j] -= d * row[j];
      rsq = rsq + s_drsq[slot];
      convg = nan_max(convg, s_dconv[slot]);
    }
  }
  if (t == 0) {
    info[0] = convg;
    info[1] = rsq;
  }
}

template <typename T>
int launch_pin_lasso_solve(const void* A, const void* diag,
                           const void* penalty, const void* valid,
                           const void* active0, const void* beta0,
                           const void* grad0, void* beta_out, void* grad_out,
                           void* active_out, void* info, int S, T l1, T l2,
                           T tol, T rsq, int max_iters, void* stream) {
  if (S < 1 || S > K1_MAX_S) return (int)cudaErrorInvalidValue;
  const int threads = ((S + 31) / 32) * 32;
  pin_lasso_solve_kernel<T><<<1, threads, 0, (cudaStream_t)stream>>>(
      (const T*)A, (const T*)diag, (const T*)penalty, (const uint8_t*)valid,
      (const uint8_t*)active0, (const T*)beta0, (const T*)grad0, (T*)beta_out,
      (T*)grad_out, (uint8_t*)active_out, (T*)info, S, l1, l2, tol, rsq,
      max_iters);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cd_sweep_rows(const void* A, void* beta, void* grad,
                         const void* pos, const void* akk, const void* pk,
                         const void* n, void* moved, void* info, int S, int C,
                         T l1, T l2, T rsq, void* stream) {
  if (S < 1 || C < 1) return (int)cudaErrorInvalidValue;
  cd_sweep_rows_kernel<T><<<1, K2_THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)A, (T*)beta, (T*)grad, (const int32_t*)pos, (const T*)akk,
      (const T*)pk, (const int32_t*)n, (uint8_t*)moved, (T*)info, S, C, l1,
      l2, rsq);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int adelie_pin_lasso_solve_f32(const void* A, const void* diag,
                               const void* penalty, const void* valid,
                               const void* active0, const void* beta0,
                               const void* grad0, void* beta_out,
                               void* grad_out, void* active_out, void* info,
                               int S, float l1, float l2, float tol, float rsq,
                               int max_iters, void* stream) {
  return launch_pin_lasso_solve<float>(A, diag, penalty, valid, active0, beta0,
                                       grad0, beta_out, grad_out, active_out,
                                       info, S, l1, l2, tol, rsq, max_iters,
                                       stream);
}

int adelie_pin_lasso_solve_f64(const void* A, const void* diag,
                               const void* penalty, const void* valid,
                               const void* active0, const void* beta0,
                               const void* grad0, void* beta_out,
                               void* grad_out, void* active_out, void* info,
                               int S, double l1, double l2, double tol,
                               double rsq, int max_iters, void* stream) {
  return launch_pin_lasso_solve<double>(A, diag, penalty, valid, active0,
                                        beta0, grad0, beta_out, grad_out,
                                        active_out, info, S, l1, l2, tol, rsq,
                                        max_iters, stream);
}

int adelie_cd_sweep_rows_f32(const void* A, void* beta, void* grad,
                             const void* pos, const void* akk, const void* pk,
                             const void* n, void* moved, void* info, int S,
                             int C, float l1, float l2, float rsq,
                             void* stream) {
  return launch_cd_sweep_rows<float>(A, beta, grad, pos, akk, pk, n, moved,
                                     info, S, C, l1, l2, rsq, stream);
}

int adelie_cd_sweep_rows_f64(const void* A, void* beta, void* grad,
                             const void* pos, const void* akk, const void* pk,
                             const void* n, void* moved, void* info, int S,
                             int C, double l1, double l2, double rsq,
                             void* stream) {
  return launch_cd_sweep_rows<double>(A, beta, grad, pos, akk, pk, n, moved,
                                      info, S, C, l1, l2, rsq, stream);
}

const char* adelie_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
