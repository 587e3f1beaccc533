// The grouped pin-solve kernel (K6) for Hopper (sm_90a).
//
// K6 runs the whole pin solve at one lambda when the screen's padded block
// width qmax is above 1, in one launch and one thread block, templated on
// float and double, with a plain C interface loaded by ctypes from
// adelie_tpu_torch/solver/pin_group_kernels.py.  The entry points launch on
// the caller's stream, allocate nothing and return cudaGetLastError().
//
// What it replaces: not a Pallas kernel.  The JAX package runs this solve
// as one XLA device program, adelie_tpu/solver/pin.py:_sweep (:232-303,
// a fori_loop over groups whose body calls adelie_tpu/bcd.py:newton_solver
// with its data-dependent while_loops) inside pin_cov_solve's loop
// (:490-594); its grouped Pallas kernel was removed (pin.py:486-489).
// PyTorch has no device loop, so without a kernel every group update would
// be several launches and a host round trip.
//
// What bounds it: the serial chain, as for K1 and K2 (pin_kernels.cu).
// Update g needs the gradient every earlier update left, so one solve is one
// block on one SM.  Per update, one warp (warp 0, lanes over the group's
// coordinates, strided past 32) does the scalar work:
//     beta_t = V^T beta_g,  g_t = V^T grad_g,  v_t = g_t + lam o beta_t,
//     x_t = the block update of bcd.newton_solver ("newton_abs"): 0 if
//           ||v_t|| <= l1 p, the ridge closed form if l1 p == 0, else the
//           adaptive bisection (up to 100 steps) and guarded Newton (up to
//           newton_max_iters steps) on phi(h), each step two warp sums,
//     d_t = x_t - beta_t; skip the update unless ||d_t||^2 exceeds
//           dbeta_tol^2 q (q > 1) or 0 (q == 1),
//     convg = max(convg, sum(lam d_t^2) / q), rsq += sum(d_t (2 g_t - d_t lam)),
//     dbeta = V x_t - beta_g,
// and the block applies grad -= A[:, b:b+q] dbeta from the rows b .. b+q of
// the symmetric row-major Gram.  Three things keep the chain short:
//   - The Newton walks.  In float32 phi rarely rounds to within newton_tol
//     (1e-12) of 0, and such a walk cycles through a few h until
//     newton_max_iters.  A walk whose h repeats bit for bit ends exactly
//     (block_update, bcd.py _newton_phase): the same h, x and step count.
//   - The warp sums fold min(qmax, 32) lanes (warp_sum): 2 rounds at qmax 4.
//   - One block barrier an update (sweep, K2's owner scheme): warp 0 applies
//     the previous update's AXPY to its group's own coordinates and goes on,
//     while the other warps apply it to every other coordinate and stage the
//     next group's operands (position, size, penalty, lam and, up to
//     STAGE_QMAX, V and the rows of the coupling block) into a
//     double-buffered shared slot by cp.async.  The barrier publishes the
//     update's dbeta and position through a double-buffered slot too.
// grad, beta and the two lists of slots (every valid slot, the active
// slots) live in shared memory when they fit, else in global memory: any S
// runs.  Past STAGE_QMAX V and the coupling block are read from global
// memory.
//
// Rounding: every block sum is a lane partial (lane l adds coordinates
// l, l + W, ... in turn from 0) and an xor butterfly over W = min(qmax, 32)
// lanes, the order of adelie_tpu_torch/bcd.py:lane_sum, which the twin
// uses; the rotations add over the block's coordinates in order; each
// grad[s] takes acc = sum_j A[b + j, s] dbeta[j] in j order and one
// subtraction, whichever thread does it; the build has -fmad=false.
//
// The outer loop is K2's: an active phase (at least one sweep, then until
// convg < tol_f, a floor-gated stall or max_iters) and a full sweep over
// every valid slot (the JAX package filters only at qmax == 1), until a
// full sweep's convg < tol_f.  info (double): rsq, iters, done, updates,
// Newton root finds, their Newton steps, a histogram of steps a find
// (NBINS bins: 0, [1, 2), [2, 4), ..., [512, 1024), newton_max_iters), all
// as the full walks take them, then the Newton steps actually run and the
// finds that ended by the cycle rule (block_update).

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstddef>
#include <cstdint>

#include "async_copy.cuh"

namespace {

constexpr int GNT = 256;
constexpr int GWARPS = GNT / 32;
constexpr int NBINS = 12;
constexpr int MAX_QMAX = 1024;
constexpr unsigned FULL = 0xffffffffu;
// shared memory for grad, beta and the lists, past the nine block vectors
constexpr int SMEM_LIMIT = 220 * 1024;
// the widest block whose V and coupling block are staged in shared memory
constexpr int STAGE_QMAX = 32;

template <typename T> struct GroupEps;
template <> struct GroupEps<float> {
  static __device__ __forceinline__ float eps() { return FLT_EPSILON; }
  // bcd.py _tiny: float(finfo.tiny) * 1e8 in double, then rounded
  static __device__ __forceinline__ float tiny() {
    return (float)((double)FLT_MIN * 1e8);
  }
};
template <> struct GroupEps<double> {
  static __device__ __forceinline__ double eps() { return DBL_EPSILON; }
  static __device__ __forceinline__ double tiny() { return DBL_MIN * 1e8; }
};

// max that propagates NaN (fmax drops it), as np.maximum does
template <typename T>
__device__ __forceinline__ T nmax(T a, T b) {
  if (a != a || b != b) return a + b;
  return a > b ? a : b;
}

// A block sum over W = min(qmax, 32) lanes (qmax a power of 2), W a
// template argument so that the folds of independent sums interleave:
// lane l adds the coordinates l mod W, l mod W + W, ... in turn from 0 (the
// lanes l and l + W hold the same partial), then log2(W) rounds of an xor
// butterfly fold each W lanes in halves, the pairs of bcd.py lane_sum in
// its order; every lane ends with the same bits.  At W = qmax each lane
// holds one coordinate, so no lane past the block takes part: the fold is
// lane_sum's in every case, -0 included (a 32-lane fold would add +0 to a
// -0 total).
template <int W, typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1)
    x = x + __shfl_xor_sync(FULL, x, off);
  return x;
}

// a float's bits, for the Newton walks' cycle test (so -0 and +0 differ)
__device__ __forceinline__ unsigned bits_of(float x) {
  return __float_as_uint(x);
}
__device__ __forceinline__ unsigned long long bits_of(double x) {
  return (unsigned long long)__double_as_longlong(x);
}

template <int W, typename T>
__device__ __forceinline__ T warp_min(T x) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) {
    const T y = __shfl_xor_sync(FULL, x, off);
    x = y < x ? y : x;
  }
  return x;
}

template <typename T>
struct GroupArgs {
  const T* A;
  const T* beta0;
  const T* grad0;
  const int64_t* slot_begin;
  const int32_t* slot_size;
  const T* eigvals;   // (G, qmax)
  const T* eigvecs;   // (G, qmax, qmax), V[j][k]: coordinate j, vector k
  const T* penalty;
  const uint8_t* active0;
  T* beta;
  T* grad;
  uint8_t* active;
  double* info;
  int32_t* lists;     // 2 G: the lists when they are not in shared memory
  int S;
  int G;
  int qmax;
  int newton_max_iters;
  int max_iters;
  T l1;
  T l2;
  T tol;
  T dbeta_tol;
  T newton_tol;
  T rsq0;
};

// Warp 0's block functions below fold W = min(qmax, 32) lanes and take
// lw = lane & (W - 1), the first coordinate of the lane's partial.

// phi(h) = sum v_k^2 / (buf1_k h + l1)^2 - 1 over the block (warp 0)
template <int W, typename T>
__device__ __forceinline__ T root_fn(const T* buf1, const T* v, int qmax,
                                     int lw, T h, T l1) {
  T p = T(0);
  for (int k = lw; k < qmax; k += W) {
    const T den = buf1[k] * h + l1;
    p = p + (v[k] * v[k]) / (den * den);
  }
  return warp_sum<W>(p) - T(1);
}

// phi(h) and the guarded derivative of bcd.py _newton_step
template <int W, typename T>
__device__ __forceinline__ void newton_step(const T* buf1, const T* v,
                                            int qmax, int lw, T h, T l1,
                                            T& fh, T& dfh) {
  T p1 = T(0), p2 = T(0);
  for (int k = lw; k < qmax; k += W) {
    const T inv = T(1) / (buf1[k] * h + l1);
    const T vi = v[k] * inv;
    const T sq = vi * vi;
    p1 = p1 + sq;
    p2 = p2 + sq * buf1[k] * inv;
  }
  const T t = warp_sum<W>(p1);
  const T s = warp_sum<W>(p2);
  fh = t - T(1);
  dfh = -s * (T(1) + sqrt(t)) / nmax(t, GroupEps<T>::tiny());
}

// The block update x of bcd.newton_solver (method "newton_abs") by the 32
// lanes of warp 0, from buf1 = lam + l2 p and v in shared memory; returns
// the Newton steps of the full walk, and sets whether the root find ran
// (*general), the steps actually run (*run) and whether the walk ended by
// the cycle rule (*cycled).
template <int W, typename T>
__device__ __forceinline__ int block_update(const T* buf1, const T* v, T* x,
                                            int qmax, int lane, T l1, T ntol,
                                            int nmax_it, bool* general,
                                            int* run, bool* cycled) {
  const int lw = lane & (W - 1);
  T p = T(0);
  for (int k = lw; k < qmax; k += W) p = p + v[k] * v[k];
  const T vnorm = sqrt(warp_sum<W>(p));
  *general = false;
  *run = 0;
  *cycled = false;
  if (vnorm <= l1) {
    for (int k = lane; k < qmax; k += 32) x[k] = T(0);
    return 0;
  }
  if (l1 <= T(0)) {
    for (int k = lane; k < qmax; k += 32)
      x[k] = v[k] != T(0) ? v[k] / (buf1[k] != T(0) ? buf1[k] : T(1)) : T(0);
    return 0;
  }
  *general = true;
  const T tiny = GroupEps<T>::tiny();
  // root_lower_bound and root_upper_bound (zero_tol 1e-14)
  T s1 = T(0), s2 = T(0), s3 = T(0), s4 = T(0), u1 = T(0), u2 = T(0);
  T mn = T(INFINITY);
  for (int k = lw; k < qmax; k += W) {
    const T bk = buf1[k];
    const T vk = v[k];
    const T vi2 = vk * vk;
    s1 = s1 + bk;
    s2 = s2 + bk * bk;
    s3 = s3 + fabs(vk);
    s4 = s4 + (vk != T(0) ? T(1) : T(0));
    const bool nz = bk > T(1e-14);
    const T safe = nz ? bk : T(1);
    u1 = u1 + (nz ? vi2 / (safe * safe) : T(0));
    u2 = u2 + (bk <= T(0) ? vi2 : T(0));
    if (nz && bk < mn) mn = bk;
  }
  s1 = warp_sum<W>(s1);
  s2 = warp_sum<W>(s2);
  s3 = warp_sum<W>(s3);
  s4 = warp_sum<W>(s4);
  u1 = warp_sum<W>(u1);
  u2 = warp_sum<W>(u2);
  mn = warp_min<W>(mn);
  const T bb = l1 * s1;
  const T c = l1 * l1 * nmax(s4, T(1)) - s3 * s3;
  const T discr = bb * bb - s2 * c;
  T h_min = discr > T(-1e-12)
                ? (-bb + sqrt(nmax(discr, T(0)))) / nmax(s2, tiny)
                : T(0);
  h_min = nmax(h_min, T(0));
  const T denom = T(1) - u2 / (l1 * l1);
  const T h_max = sqrt(nmax(u1 / (denom > T(0) ? denom : T(1)), T(0)));
  const T min_nnz = isfinite(mn) ? mn : T(1);

  // adaptive bisection from h_max toward h_min until phi(h) >= 0
  T h = h_min;
  if (!(h_max - h_min <= T(1e-1))) {
    auto toward = [&](T hc) {
      const T w = nmax(l1 / (min_nnz * hc + l1), T(0.05));
      return w * h_min + (T(1) - w) * hc;
    };
    h = toward(nmax(h_max, h_min));
    T fh = root_fn<W>(buf1, v, qmax, lw, h, l1);
    int it = 1;
    while (fh < T(0) && fabs(fh) > ntol && it < 100) {
      h = toward(h);
      fh = root_fn<W>(buf1, v, qmax, lw, h, l1);
      ++it;
    }
  }
  // guarded Newton, with bcd.py _newton_phase's exact exit: the walk's
  // state is h alone, so once h repeats bit for bit (Brent's cycle
  // detection: the saved h against each of the next `power` steps, then
  // the newest saved and `power` doubled) at step it with period `since`, no
  // h of the cycle meets ntol and the walk would run to nmax_it; the
  // (nmax_it - it) mod since steps left of the cycle end on its last h.
  // Every lane holds the same h, so the warp takes one path.
  T fh, dfh;
  newton_step<W>(buf1, v, qmax, lw, h, l1, fh, dfh);
  int it = 0, since = 0, power = 1;
  auto saved = bits_of(h);
  while (fabs(fh) > ntol && it < nmax_it) {
    h = nmax(h - fh / dfh, T(0));
    newton_step<W>(buf1, v, qmax, lw, h, l1, fh, dfh);
    ++it;
    ++since;
    if (it < nmax_it && bits_of(h) == saved) {
      int left = (nmax_it - it) % since;
      *run = it + left;
      *cycled = true;
      for (; left > 0; --left) {
        h = nmax(h - fh / dfh, T(0));
        newton_step<W>(buf1, v, qmax, lw, h, l1, fh, dfh);
      }
      it = nmax_it;
      break;
    }
    if (since == power) {
      saved = bits_of(h);
      since = 0;
      power <<= 1;
    }
  }
  if (!*cycled) *run = it;
  for (int k = lane; k < qmax; k += 32) x[k] = (h * v[k]) / (buf1[k] * h + l1);
  return it;
}

// What warp 0 computes of update k between its rotations and its dbeta:
// x_t (block_update) and the update's sums
//     pd = ||d_t||^2,  pc = sum lam d_t^2,  pr = sum d_t (2 g_t - d_t lam).
template <typename T>
struct BlockStep {
  T pd, pc, pr;
  int nit, run;
  bool general, cycled;
};

template <int W, typename T>
__device__ BlockStep<T> block_step_w(const T* buf1, const T* vt, const T* bt,
                                     const T* gt, const T* lam, T* xt,
                                     int qmax, int lane, T l1, T ntol,
                                     int nmax_it) {
  BlockStep<T> r;
  r.nit = block_update<W>(buf1, vt, xt, qmax, lane, l1, ntol, nmax_it,
                          &r.general, &r.run, &r.cycled);
  __syncwarp();
  T pd = T(0), pc = T(0), pr = T(0);
  for (int kk = lane & (W - 1); kk < qmax; kk += W) {
    const T d = xt[kk] - bt[kk];
    pd = pd + d * d;
    pc = pc + lam[kk] * d * d;
    pr = pr + d * (T(2) * gt[kk] - d * lam[kk]);
  }
  r.pd = warp_sum<W>(pd);
  r.pc = warp_sum<W>(pc);
  r.pr = warp_sum<W>(pr);
  return r;
}

// block_step_w at the launch's W = min(qmax, 32): a branch the warp takes
// as one
template <typename T>
__device__ __forceinline__ BlockStep<T> block_step(
    const T* buf1, const T* vt, const T* bt, const T* gt, const T* lam,
    T* xt, int qmax, int lane, T l1, T ntol, int nmax_it) {
  switch (qmax) {
    case 1:
      return block_step_w<1>(buf1, vt, bt, gt, lam, xt, qmax, lane, l1,
                             ntol, nmax_it);
    case 2:
      return block_step_w<2>(buf1, vt, bt, gt, lam, xt, qmax, lane, l1,
                             ntol, nmax_it);
    case 4:
      return block_step_w<4>(buf1, vt, bt, gt, lam, xt, qmax, lane, l1,
                             ntol, nmax_it);
    case 8:
      return block_step_w<8>(buf1, vt, bt, gt, lam, xt, qmax, lane, l1,
                             ntol, nmax_it);
    case 16:
      return block_step_w<16>(buf1, vt, bt, gt, lam, xt, qmax, lane, l1,
                              ntol, nmax_it);
    default:
      return block_step_w<32>(buf1, vt, bt, gt, lam, xt, qmax, lane, l1,
                              ntol, nmax_it);
  }
}

template <typename T, bool SMEM>
__global__ void __launch_bounds__(GNT)
    pin_group_solve_kernel(const GroupArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T s_red[GWARPS];
  __shared__ int s_cnt[GWARPS];
  __shared__ int s_b[2];   // an update's position and, if it moved, size
  __shared__ int s_q[2];
  __shared__ int st_b[2];  // the staged group's position, size and penalty
  __shared__ int st_q[2];
  __shared__ T st_pk[2];
  __shared__ T s_conv;
  __shared__ int s_hist[NBINS];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int S = a.S;
  const int G = a.G;
  const int qmax = a.qmax;
  const bool stage = qmax <= STAGE_QMAX;
  const int qq = stage ? qmax * qmax : 0;

  // warp 0's block vectors, the two dbeta slots, the two staging slots
  // (lam; V and the coupling block when staged), then (SMEM) grad, beta
  // and the lists
  T* bg = reinterpret_cast<T*>(smem);
  T* gg = bg + qmax;
  T* bt = gg + qmax;
  T* gt = bt + qmax;
  T* vt = gt + qmax;
  T* buf1 = vt + qmax;
  T* xt = buf1 + qmax;
  T* dbs = xt + qmax;             // 2 qmax
  T* st_lam = dbs + 2 * qmax;     // 2 qmax
  T* st_V = st_lam + 2 * qmax;    // 2 qq
  T* st_X = st_V + 2 * qq;        // 2 qq
  T* grad = SMEM ? st_X + 2 * qq : a.grad;
  T* beta = SMEM ? grad + S : a.beta;
  int* vlist = SMEM ? reinterpret_cast<int*>(beta + S) : a.lists;
  int* alist = vlist + G;

  for (int s = t; s < S; s += GNT) {
    grad[s] = a.grad0[s];
    beta[s] = a.beta0[s];
  }
  if (t < NBINS) s_hist[t] = 0;
  // lam_max = max(max |eigvals|, 1), NaN propagating
  T lmax = T(0);
  for (int s = t; s < G; s += GNT) {
    a.active[s] = a.active0[s];
    for (int k = 0; k < qmax; ++k)
      lmax = nmax(lmax, T(fabs(a.eigvals[(size_t)s * qmax + k])));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    lmax = nmax(lmax, __shfl_xor_sync(FULL, lmax, off));
  if (lane == 0) s_red[warp] = lmax;
  __syncthreads();
  lmax = T(0);
  for (int w = 0; w < GWARPS; ++w) lmax = nmax(lmax, s_red[w]);
  lmax = nmax(lmax, T(1));

  // dtype-feasibility floor and floor-gated stall, as K1 and K2
  const T eps = GroupEps<T>::eps();
  const T tol_f =
      nmax(a.tol, T(100) * lmax * ((T(10) * eps) * (T(10) * eps)));
  const T stall_floor = T(1e8) * lmax * eps * eps;

  // a valid slot names a block inside A: the wrapper's contract, checked
  // here only so that malformed buffers cannot read or write out of bounds
  auto valid = [&](int s) {
    const int64_t b = a.slot_begin[s];
    const int q = a.slot_size[s];
    return q > 0 && q <= qmax && b >= 0 && b + q <= S;
  };
  // the slots with valid(s) (and, active_only, active) into list,
  // ascending, by a block prefix sum of warp ballots; returns the count
  auto build = [&](bool active_only, int* list) {
    int base = 0;
    for (int c0 = 0; c0 < G; c0 += GNT) {
      const int s = c0 + t;
      const bool f = s < G && valid(s) && (!active_only || a.active[s]);
      const unsigned bal = __ballot_sync(FULL, f);
      if (lane == 0) s_cnt[warp] = __popc(bal);
      __syncthreads();
      int off = 0, tot = 0;
      for (int w = 0; w < GWARPS; ++w) {
        off += w < warp ? s_cnt[w] : 0;
        tot += s_cnt[w];
      }
      if (f) list[base + off + __popc(bal & ((1u << lane) - 1u))] = s;
      base += tot;
      __syncthreads();
    }
    return base;
  };

  // copy slot i's operands into staging slot `sl` (thread `id` of `nt`):
  // position, size, penalty, lam and, when staged, the rows of V and the
  // coupling block X[j][jj] = A[pb + j, b + jj] (j < pq, the group before
  // it in the pass; pq = 0 for a pass's first), by cp.async; the caller
  // waits (cp_async_wait_all) and crosses a barrier before they are read
  auto stage_slot = [&](int sl, int i, int pb, int pq, int id, int nt) {
    const int b = (int)a.slot_begin[i];
    const int q = a.slot_size[i];
    if (id == 0) {
      st_b[sl] = b;
      st_q[sl] = q;
      st_pk[sl] = a.penalty[i];
    }
    for (int k = id; k < qmax; k += nt)
      cp_async<sizeof(T)>(st_lam + sl * qmax + k,
                          a.eigvals + (size_t)i * qmax + k);
    if (!stage) return;
    for (int e = id; e < q * qmax; e += nt)
      cp_async<sizeof(T)>(st_V + sl * qq + e,
                          a.eigvecs + (size_t)i * qmax * qmax + e);
    for (int e = id; e < pq * q; e += nt) {
      const int j = e / q, jj = e - j * q;
      cp_async<sizeof(T)>(st_X + sl * qq + j * qmax + jj,
                          a.A + (size_t)(pb + j) * S + b + jj);
    }
  };
  // grad[s] -= sum_j A[b + j, s] db[j] (j < q, in order) for s in
  // [s0, S) by stride nt, skipping [xb, xb + xq)
  auto axpy = [&](int b, int q, const T* db, int s0, int nt, int xb,
                  int xq) {
    const T* rows = a.A + (size_t)b * S;
    for (int s = s0; s < S; s += nt) {
      if ((unsigned)(s - xb) < (unsigned)xq) continue;
      T acc = T(0);
      for (int j = 0; j < q; ++j)
        acc = acc + __ldg(rows + (size_t)j * S + s) * db[j];
      grad[s] = grad[s] - acc;
    }
  };

  const T l1 = a.l1;
  const T l2 = a.l2;
  T rsq = a.rsq0;                    // warp 0's
  // thread 0's: updates, root finds, Newton steps (full walks), steps run,
  // cycle exits
  long long n_upd = 0, n_solve = 0, n_newton = 0, n_run = 0, n_cycle = 0;

  // One Gauss-Seidel pass over list[0 .. n); returns its convg.  Update k
  // uses slot k & 1 of the staging, dbeta and broadcast buffers, and ends
  // at the block's one barrier of the update.  Before it, warp 0 applies
  // update k - 1's grad -= A[b:b+q]^T dbeta to update k's own coordinates
  // (from the staged coupling block) and does update k's scalar work; the
  // other warps apply update k - 1's AXPY to every other coordinate and
  // stage update k + 1's operands.  The barrier then orders the broadcast
  // of update k's results and the reuse of slot k + 1 & 1, which nothing
  // reads after update k - 1.  Each grad[s] still takes the AXPYs in
  // update order, each summed over j in order and subtracted once.
  auto sweep = [&](const int* list, int n) {
    T convg = T(0);
    if (n > 0) stage_slot(0, list[0], 0, 0, t, GNT);
    cp_async_wait_all();
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const int sl = k & 1, pl = sl ^ 1;
      const int b = st_b[sl], q = st_q[sl];
      const int pq = k > 0 ? s_q[pl] : 0;   // update k - 1's, if it moved
      const int pb = s_b[pl];
      const T* pdb = dbs + pl * qmax;
      if (warp == 0) {
        const int i = list[k];
        const T pk = st_pk[sl];
        const T* lam = st_lam + sl * qmax;
        const T* V = stage ? st_V + sl * qq
                           : a.eigvecs + (size_t)i * qmax * qmax;
        for (int j = lane; j < q; j += 32) {
          T g = grad[b + j];
          if (pq) {
            T acc = T(0);
            for (int jp = 0; jp < pq; ++jp) {
              const T x = stage ? st_X[sl * qq + jp * qmax + j]
                                : __ldg(a.A + (size_t)(pb + jp) * S + b + j);
              acc = acc + x * pdb[jp];
            }
            g = g - acc;
            grad[b + j] = g;
          }
          bg[j] = beta[b + j];
          gg[j] = g;
        }
        __syncwarp();
        const T l2p = l2 * pk;
        for (int kk = lane; kk < qmax; kk += 32) {
          T ab = T(0), ag = T(0);
          for (int j = 0; j < q; ++j) {
            const T vjk = V[(size_t)j * qmax + kk];
            ab = ab + vjk * bg[j];
            ag = ag + vjk * gg[j];
          }
          bt[kk] = ab;
          gt[kk] = ag;
          vt[kk] = ag + lam[kk] * ab;
          buf1[kk] = lam[kk] + l2p;
        }
        __syncwarp();
        const BlockStep<T> r = block_step(buf1, vt, bt, gt, lam, xt, qmax,
                                          lane, l1 * pk, a.newton_tol,
                                          a.newton_max_iters);
        const T pd = r.pd, pc = r.pc, pr = r.pr;
        const T thresh =
            q > 1 ? a.dbeta_tol * a.dbeta_tol * T(q) : T(0);
        const bool moved = pd > thresh;
        if (moved) {
          convg = nmax(convg, pc / T(q));
          rsq = rsq + pr;
          T* db = dbs + sl * qmax;
          for (int j = lane; j < q; j += 32) {
            T acc = T(0);
            for (int kk = 0; kk < qmax; ++kk)
              acc = acc + V[(size_t)j * qmax + kk] * xt[kk];
            db[j] = acc - bg[j];
            beta[b + j] = acc;
          }
        }
        if (lane == 0) {
          if (moved) a.active[i] = 1;
          s_b[sl] = b;
          s_q[sl] = moved ? q : 0;
          ++n_upd;
          if (r.general) {
            ++n_solve;
            n_newton += r.nit;
            n_run += r.run;
            n_cycle += r.cycled;
            const int bin =
                r.nit >= a.newton_max_iters
                    ? NBINS - 1
                    : (r.nit == 0 ? 0 : min(32 - __clz(r.nit), NBINS - 2));
            ++s_hist[bin];
          }
        }
      } else {
        if (pq) axpy(pb, pq, pdb, t - 32, GNT - 32, b, q);
        if (k + 1 < n) stage_slot(pl, list[k + 1], b, q, t - 32, GNT - 32);
        cp_async_wait_all();
      }
      __syncthreads();
    }
    // the pass's last AXPY, by every thread
    const int ll = (n - 1) & 1;
    if (n > 0 && s_q[ll])
      axpy(s_b[ll], s_q[ll], dbs + ll * qmax, t, GNT, 0, 0);
    if (t == 0) s_conv = convg;
    __syncthreads();
    return s_conv;
  };

  auto next_slow = [&](int slow, T convg, T prev) {
    return convg >= T(0.99) * prev ? slow + 1 : 0;
  };
  auto stalled = [&](int slow, T convg) {
    return slow >= 3 && convg <= stall_floor;
  };

  const int nv = build(false, vlist);
  T convg = T(INFINITY);
  int slow = 0, iters = 0;
  bool done = false;
  while (!done && iters < a.max_iters && !stalled(slow, convg) &&
         convg == convg) {
    const T prev = convg;
    // active phase: at least one sweep over the active list, built once
    const int na = build(true, alist);
    T c = sweep(alist, na);
    int it = iters + 1, a_slow = 0;
    while (c >= tol_f && it < a.max_iters && !stalled(a_slow, c)) {
      const T p = c;
      c = sweep(alist, na);
      a_slow = next_slow(a_slow, c, p);
      ++it;
    }
    iters = it;
    convg = sweep(vlist, nv);
    slow = next_slow(slow, convg, prev);
    ++iters;
    done = convg < tol_f;
  }
  // a floor-gated stall is convergence at the dtype's floor; NaN is failure
  done = (done || stalled(slow, convg)) && convg == convg;

  if (SMEM) {
    for (int s = t; s < S; s += GNT) {
      a.grad[s] = grad[s];
      a.beta[s] = beta[s];
    }
  }
  if (t == 0) {
    a.info[0] = (double)rsq;
    a.info[1] = (double)iters;
    a.info[2] = done ? 1.0 : 0.0;
    a.info[3] = (double)n_upd;
    a.info[4] = (double)n_solve;
    a.info[5] = (double)n_newton;
    for (int i = 0; i < NBINS; ++i) a.info[6 + i] = (double)s_hist[i];
    a.info[6 + NBINS] = (double)n_run;
    a.info[7 + NBINS] = (double)n_cycle;
  }
}

template <typename T, bool SMEM>
int launch_group_block(const GroupArgs<T>& args, int bytes,
                       cudaStream_t stream) {
  auto kernel = pin_group_solve_kernel<T, SMEM>;
  // above 48 KB a block's dynamic shared memory must be opted into, once
  // per kernel
  static int opted_in = 0;
  if (bytes > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    opted_in = bytes;
  }
  kernel<<<1, GNT, bytes, stream>>>(args);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pin_group_solve(
    const void* A, const void* beta0, const void* grad0,
    const void* slot_begin, const void* slot_size, const void* eigvals,
    const void* eigvecs, const void* penalty, const void* active0,
    void* beta, void* grad, void* active, void* info, void* lists, int S,
    int G, int qmax, T l1, T l2, T tol, T dbeta_tol, T newton_tol, T rsq,
    int newton_max_iters, int max_iters, void* stream) {
  if (S < 1 || G < 1 || qmax < 1 || qmax > MAX_QMAX || (qmax & (qmax - 1)))
    return (int)cudaErrorInvalidValue;
  GroupArgs<T> args;
  args.A = (const T*)A;
  args.beta0 = (const T*)beta0;
  args.grad0 = (const T*)grad0;
  args.slot_begin = (const int64_t*)slot_begin;
  args.slot_size = (const int32_t*)slot_size;
  args.eigvals = (const T*)eigvals;
  args.eigvecs = (const T*)eigvecs;
  args.penalty = (const T*)penalty;
  args.active0 = (const uint8_t*)active0;
  args.beta = (T*)beta;
  args.grad = (T*)grad;
  args.active = (uint8_t*)active;
  args.info = (double*)info;
  args.lists = (int32_t*)lists;
  args.S = S;
  args.G = G;
  args.qmax = qmax;
  args.newton_max_iters = newton_max_iters;
  args.max_iters = max_iters;
  args.l1 = l1;
  args.l2 = l2;
  args.tol = tol;
  args.dbeta_tol = dbeta_tol;
  args.newton_tol = newton_tol;
  args.rsq0 = rsq;
  // warp 0's vectors, two dbeta slots, two staging slots
  const size_t qq = qmax <= STAGE_QMAX ? (size_t)qmax * qmax : 0;
  const size_t vec_bytes = ((size_t)11 * qmax + 4 * qq) * sizeof(T);
  const size_t state_bytes = (size_t)2 * S * sizeof(T) + (size_t)2 * G * 4;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec_bytes + state_bytes <= (size_t)SMEM_LIMIT)
    return launch_group_block<T, true>(args, (int)(vec_bytes + state_bytes),
                                       st);
  return launch_group_block<T, false>(args, (int)vec_bytes, st);
}

}  // namespace

extern "C" {

int adelie_pin_group_solve_f32(
    const void* A, const void* beta0, const void* grad0,
    const void* slot_begin, const void* slot_size, const void* eigvals,
    const void* eigvecs, const void* penalty, const void* active0,
    void* beta, void* grad, void* active, void* info, void* lists, int S,
    int G, int qmax, float l1, float l2, float tol, float dbeta_tol,
    float newton_tol, float rsq, int newton_max_iters, int max_iters,
    void* stream) {
  return launch_pin_group_solve<float>(
      A, beta0, grad0, slot_begin, slot_size, eigvals, eigvecs, penalty,
      active0, beta, grad, active, info, lists, S, G, qmax, l1, l2, tol,
      dbeta_tol, newton_tol, rsq, newton_max_iters, max_iters, stream);
}

int adelie_pin_group_solve_f64(
    const void* A, const void* beta0, const void* grad0,
    const void* slot_begin, const void* slot_size, const void* eigvals,
    const void* eigvecs, const void* penalty, const void* active0,
    void* beta, void* grad, void* active, void* info, void* lists, int S,
    int G, int qmax, double l1, double l2, double tol, double dbeta_tol,
    double newton_tol, double rsq, int newton_max_iters, int max_iters,
    void* stream) {
  return launch_pin_group_solve<double>(
      A, beta0, grad0, slot_begin, slot_size, eigvals, eigvecs, penalty,
      active0, beta, grad, active, info, lists, S, G, qmax, l1, l2, tol,
      dbeta_tol, newton_tol, rsq, newton_max_iters, max_iters, stream);
}

}  // extern "C"
