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
//     dbeta = V x_t - beta_g;
// then one block barrier, and every thread takes its share of
//     grad -= A[:, b:b+q] dbeta
// from the rows b .. b+q of the symmetric row-major Gram, and a second
// barrier before the next update reads grad.  An update that does not move
// costs the one barrier.  Its scalar arguments (position, size) go through a
// double-buffered shared slot, so that warp 0 may start the next update
// before every thread has read them.  grad, beta and the two lists of slots
// (every valid slot, the active slots) live in shared memory when they fit,
// else in global memory: any S runs.  V and lam are read from global memory.
//
// Rounding: every block sum is a lane partial (lane l adds coordinates
// l, l + 32, ... in turn from 0) and a 32-lane xor butterfly, the order of
// adelie_tpu_torch/bcd.py:lane_sum, which the twin uses; the rotations add
// over the block's coordinates in order; the build has -fmad=false.
//
// The outer loop is K2's: an active phase (at least one sweep, then until
// convg < tol_f, a floor-gated stall or max_iters) and a full sweep over
// every valid slot (the JAX package filters only at qmax == 1), until a
// full sweep's convg < tol_f.  info (double): rsq, iters, done, updates,
// Newton root finds, their Newton steps, and a histogram of steps a find
// (NBINS bins: 0, [1, 2), [2, 4), ..., [512, 1024), newton_max_iters).

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int GNT = 256;
constexpr int GWARPS = GNT / 32;
constexpr int NBINS = 12;
constexpr int MAX_QMAX = 1024;
constexpr unsigned FULL = 0xffffffffu;
// shared memory for grad, beta and the lists, past the nine block vectors
constexpr int SMEM_LIMIT = 220 * 1024;

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

// the sum over the warp: the lanes' partials folded by an xor butterfly,
// so every lane holds the same bits
template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = x + __shfl_xor_sync(FULL, x, off);
  return x;
}

template <typename T>
__device__ __forceinline__ T warp_min(T x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
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

// phi(h) = sum v_k^2 / (buf1_k h + l1)^2 - 1 over the block (warp 0)
template <typename T>
__device__ __forceinline__ T root_fn(const T* buf1, const T* v, int qmax,
                                     int lane, T h, T l1) {
  T p = T(0);
  for (int k = lane; k < qmax; k += 32) {
    const T den = buf1[k] * h + l1;
    p = p + (v[k] * v[k]) / (den * den);
  }
  return warp_sum(p) - T(1);
}

// phi(h) and the guarded derivative of bcd.py _newton_step
template <typename T>
__device__ __forceinline__ void newton_step(const T* buf1, const T* v,
                                            int qmax, int lane, T h, T l1,
                                            T& fh, T& dfh) {
  T p1 = T(0), p2 = T(0);
  for (int k = lane; k < qmax; k += 32) {
    const T inv = T(1) / (buf1[k] * h + l1);
    const T vi = v[k] * inv;
    const T sq = vi * vi;
    p1 = p1 + sq;
    p2 = p2 + sq * buf1[k] * inv;
  }
  const T t = warp_sum(p1);
  const T s = warp_sum(p2);
  fh = t - T(1);
  dfh = -s * (T(1) + sqrt(t)) / nmax(t, GroupEps<T>::tiny());
}

// The block update x of bcd.newton_solver (method "newton_abs") by the 32
// lanes of warp 0, from buf1 = lam + l2 p and v in shared memory; returns
// the Newton steps, and whether the root find ran (*general).
template <typename T>
__device__ int block_update(const T* buf1, const T* v, T* x, int qmax,
                            int lane, T l1, T ntol, int nmax_it,
                            bool* general) {
  T p = T(0);
  for (int k = lane; k < qmax; k += 32) p = p + v[k] * v[k];
  const T vnorm = sqrt(warp_sum(p));
  *general = false;
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
  for (int k = lane; k < qmax; k += 32) {
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
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  s3 = warp_sum(s3);
  s4 = warp_sum(s4);
  u1 = warp_sum(u1);
  u2 = warp_sum(u2);
  mn = warp_min(mn);
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
    T fh = root_fn(buf1, v, qmax, lane, h, l1);
    int it = 1;
    while (fh < T(0) && fabs(fh) > ntol && it < 100) {
      h = toward(h);
      fh = root_fn(buf1, v, qmax, lane, h, l1);
      ++it;
    }
  }
  // guarded Newton
  T fh, dfh;
  newton_step(buf1, v, qmax, lane, h, l1, fh, dfh);
  int it = 0;
  while (fabs(fh) > ntol && it < nmax_it) {
    h = nmax(h - fh / dfh, T(0));
    newton_step(buf1, v, qmax, lane, h, l1, fh, dfh);
    ++it;
  }
  for (int k = lane; k < qmax; k += 32) x[k] = (h * v[k]) / (buf1[k] * h + l1);
  return it;
}

template <typename T, bool SMEM>
__global__ void __launch_bounds__(GNT)
    pin_group_solve_kernel(const GroupArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T s_red[GWARPS];
  __shared__ int s_cnt[GWARPS];
  __shared__ int s_b[2];   // the update's position and, if it moved, size
  __shared__ int s_q[2];
  __shared__ T s_conv;
  __shared__ int s_hist[NBINS];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int S = a.S;
  const int G = a.G;
  const int qmax = a.qmax;

  // warp 0's block vectors, then (SMEM) grad, beta and the lists
  T* bg = reinterpret_cast<T*>(smem);
  T* gg = bg + qmax;
  T* bt = gg + qmax;
  T* gt = bt + qmax;
  T* vt = gt + qmax;
  T* lam = vt + qmax;
  T* buf1 = lam + qmax;
  T* xt = buf1 + qmax;
  T* db = xt + qmax;
  T* grad = SMEM ? db + qmax : a.grad;
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

  const T l1 = a.l1;
  const T l2 = a.l2;
  T rsq = a.rsq0;                    // warp 0's
  long long n_upd = 0, n_solve = 0, n_newton = 0;  // thread 0's
  unsigned step = 0;                 // updates so far: parity picks s_b/s_q

  // one Gauss-Seidel pass over list[0 .. n); returns its convg
  auto sweep = [&](const int* list, int n) {
    T convg = T(0);
    for (int k = 0; k < n; ++k, ++step) {
      const int slot = step & 1;
      if (warp == 0) {
        const int i = list[k];
        const int b = (int)a.slot_begin[i];
        const int q = a.slot_size[i];
        const T pk = a.penalty[i];
        const T* V = a.eigvecs + (size_t)i * qmax * qmax;
        for (int j = lane; j < q; j += 32) {
          bg[j] = beta[b + j];
          gg[j] = grad[b + j];
        }
        for (int kk = lane; kk < qmax; kk += 32)
          lam[kk] = a.eigvals[(size_t)i * qmax + kk];
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
        bool general;
        const int nit = block_update(buf1, vt, xt, qmax, lane, l1 * pk,
                                     a.newton_tol, a.newton_max_iters,
                                     &general);
        __syncwarp();
        T pd = T(0), pc = T(0), pr = T(0);
        for (int kk = lane; kk < qmax; kk += 32) {
          const T d = xt[kk] - bt[kk];
          pd = pd + d * d;
          pc = pc + lam[kk] * d * d;
          pr = pr + d * (T(2) * gt[kk] - d * lam[kk]);
        }
        pd = warp_sum(pd);
        pc = warp_sum(pc);
        pr = warp_sum(pr);
        const T thresh =
            q > 1 ? a.dbeta_tol * a.dbeta_tol * T(q) : T(0);
        const bool moved = pd > thresh;
        if (moved) {
          convg = nmax(convg, pc / T(q));
          rsq = rsq + pr;
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
          s_b[slot] = b;
          s_q[slot] = moved ? q : 0;
          ++n_upd;
          if (general) {
            ++n_solve;
            n_newton += nit;
            const int bin =
                nit >= a.newton_max_iters
                    ? NBINS - 1
                    : (nit == 0 ? 0 : min(32 - __clz(nit), NBINS - 2));
            ++s_hist[bin];
          }
        }
      }
      __syncthreads();
      const int q = s_q[slot];
      if (q) {
        const T* rows = a.A + (size_t)s_b[slot] * S;
        for (int s = t; s < S; s += GNT) {
          T acc = T(0);
          for (int j = 0; j < q; ++j)
            acc = acc + __ldg(rows + (size_t)j * S + s) * db[j];
          grad[s] = grad[s] - acc;
        }
        __syncthreads();
      }
    }
    if (t == 0) s_conv = convg;
    __syncthreads();
    const T c = s_conv;
    __syncthreads();
    return c;
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
  const size_t vec_bytes = (size_t)9 * qmax * sizeof(T);
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
