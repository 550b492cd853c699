// K2: one BDF-2 step's whole damped-Newton shooting solve per launch, one
// thread per rod.
//
// Replaces knode_cosserat_tpu/ops/pallas_step.py::make_step_kernel. Plain
// version: knode_cosserat_tpu_torch/ops/step.py::step_reference (the
// FD-Newton driver of core/fast_rollout.py over the plain sweep, forward
// differences, Jacobian refreshed every iteration). Per rod, while
// r2 > tol, fails <= max_escalations and it < max_iter:
//   J[i][k] = (r(G + h_k e_k)_i - r_i) / h_k, h_k = eps0 (1 + |G_k|)
//   J_ii += lam * max(|J_ii|, 1)                  (Levenberg-Marquardt)
//   dG = J^-1 (-r), Gaussian elimination with partial pivoting; a
//        non-finite dG is set to 0
//   take the first alpha = 0.5**k (k < n_alphas) with r2(G + alpha dG) < r2
//   success: lam = 0, fails = 0; stall: hold G, lam = max(lam*growth,
//        lam0), fails += 1
// then a final sweep records y (B, N, 19) and z (B, N-1, 6).
//
// The net is one for all rods, or one per rod (nn_per_rod = 1: rod b reads
// the b-th of B nets stacked on a leading axis, each tensor at b times its
// per-net size) -- the JAX package lifts the step kernel over per-cell
// params with vmap for the eval tables; here the rod index is the cell.
//
// What the TPU kernel needed and this one drops: pre-stalled pad lanes,
// the f32-carried fails/found masks, 8-row padding of the node slabs, and
// running every line-search candidate (stopping at the first improving
// alpha gives the same G). Each rod loops on its own, so `iters` is each
// rod's own iteration count (the TPU wrote one count per block of rods).
//
// Where the H100 bounds it: a Newton iteration is 6 probe sweeps plus up
// to n_alphas candidate sweeps, each (N-1) K1 calls; with the hybrid net
// at hidden 512 that is ~54 kflop per K1 call, ~9 nodes x (6 + <=7) sweeps
// per iteration, all a serial dependent chain in one thread (see
// rhs_rows.cuh). 256 rods are 256 threads, ~0.1% of the card's 132 x 2048
// resident-thread slots, so the step's latency is one thread's chain and
// the card is almost entirely idle. This mapping is the first target for
// later performance work: a warp per rod with the hidden dimension across
// its lanes, and the 6 probes and the candidates of an iteration in
// parallel (the probes are independent sweeps).
#include "rhs_rows.cuh"

// Residual of the sweep from base reaction G (6), no recording. PER_ROD
// gives the per-rod kernel its own copy: the shared-net kernel's copy then
// only ever sees its net in the kernel's parameters, as before per-rod nets.
template <typename T, int NNIN, bool RK4, bool PER_ROD>
__device__ __noinline__ void sweep_res(const RodConsts<T>& rc,
                                       const Mlp<T>& mlp, int N, const T* G,
                                       const T* yhb, const T* zhb,
                                       const T* tf, T* r) {
  T y[19], z[6];
  base_node(rc, G, y);
  for (int j = 0; j < N - 1; ++j)
    node_update<T, NNIN, RK4>(rc, mlp, y, yhb + 19 * j, zhb + 6 * j, tf, z);
  tip_residual(rc, y, r);
}

template <typename T>
__device__ __forceinline__ T sumsq6(const T* r) {
  T s = T(0);
#pragma unroll
  for (int i = 0; i < 6; ++i) s += r[i] * r[i];
  return s;
}

__device__ __forceinline__ bool finite_val(float x) { return isfinite(x); }
__device__ __forceinline__ bool finite_val(double x) { return isfinite(x); }

// Solve A x = b (6x6, A row-major) by Gaussian elimination with partial
// pivoting. Fully unrolled, so A lives in registers; the pivot row is
// brought up by conditional swaps with every lower row that holds a larger
// |A[., k]| (the row that ends on top is the column's maximum). A zero or
// non-finite pivot gives non-finite x, which the caller masks.
template <typename T>
__device__ __forceinline__ void solve6(T* A, T* b, T* x) {
#pragma unroll
  for (int k = 0; k < 6; ++k) {
#pragma unroll
    for (int j = k + 1; j < 6; ++j) {
      const bool better = m_abs(A[6 * j + k]) > m_abs(A[6 * k + k]);
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        const T ak = A[6 * k + c], aj = A[6 * j + c];
        A[6 * k + c] = better ? aj : ak;
        A[6 * j + c] = better ? ak : aj;
      }
      const T bk = b[k], bj = b[j];
      b[k] = better ? bj : bk;
      b[j] = better ? bk : bj;
    }
    const T inv_p = T(1) / A[6 * k + k];
#pragma unroll
    for (int j = k + 1; j < 6; ++j) {
      const T f = A[6 * j + k] * inv_p;
#pragma unroll
      for (int c = k; c < 6; ++c) A[6 * j + c] -= f * A[6 * k + c];
      b[j] -= f * b[k];
    }
  }
#pragma unroll
  for (int k = 5; k >= 0; --k) {
    T acc = b[k];
#pragma unroll
    for (int c = k + 1; c < 6; ++c) acc -= A[6 * k + c] * x[c];
    x[k] = acc / A[6 * k + k];
  }
}

struct NewtonArgs {
  double tol, eps0, lm_lambda0, lm_growth;
  int max_iter, n_alphas, max_escalations;
};

// PER_ROD: rod b runs the b-th net of the stack (a copy of the net's
// pointers advanced to it); otherwise every rod reads the one net straight
// from the kernel's parameter.
template <typename T, int NNIN, bool RK4, bool PER_ROD>
__global__ void step_kernel(const RodConsts<T> rc, const Mlp<T> mlp_arg,
                            const NewtonArgs na, int B, int N,
                            const T* __restrict__ G_in,
                            const T* __restrict__ yh,
                            const T* __restrict__ zh,
                            const T* __restrict__ tf, T* __restrict__ G_out,
                            T* __restrict__ y_out, T* __restrict__ z_out,
                            T* __restrict__ r2_out, int* __restrict__ iters) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Mlp<T> own;
  if constexpr (PER_ROD) {
    const size_t h = (size_t)mlp_arg.hidden;
    own = mlp_arg;
    own.W1 += b * h * NNIN;
    own.b1 += b * h;
    own.W2 += b * h * 25;
    own.b2 += (size_t)b * 25;
  }
  const Mlp<T>& mlp = PER_ROD ? own : mlp_arg;
  const T* yhb = yh + (size_t)b * N * 19;
  const T* zhb = zh + (size_t)b * N * 6;
  const T tfb[3] = {tf[3 * b], tf[3 * b + 1], tf[3 * b + 2]};
  const T tol = T(na.tol), eps0 = T(na.eps0);
  const T lam0 = T(na.lm_lambda0), growth = T(na.lm_growth);

  T G[6], r[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) G[i] = G_in[6 * (size_t)b + i];
  sweep_res<T, NNIN, RK4, PER_ROD>(rc, mlp, N, G, yhb, zhb, tfb, r);
  T r2 = sumsq6(r);
  T lam = T(0);
  int fails = 0, it = 0;

  while (it < na.max_iter && r2 > tol && fails <= na.max_escalations) {
    // forward-difference Jacobian: 6 probe sweeps (unrolled: six calls of
    // the out-of-line sweep, and J's indices stay compile-time constants)
    T J[36];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      T Gp[6], rp[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) Gp[i] = G[i];
      const T h = eps0 * (T(1) + m_abs(G[k]));
      Gp[k] = G[k] + h;
      sweep_res<T, NNIN, RK4, PER_ROD>(rc, mlp, N, Gp, yhb, zhb, tfb, rp);
#pragma unroll
      for (int i = 0; i < 6; ++i) J[6 * i + k] = (rp[i] - r[i]) / h;
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const T d = m_abs(J[7 * i]);
      J[7 * i] += lam * (d > T(1) ? d : T(1));
    }
    T rhs[6], dG[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) rhs[i] = -r[i];
    solve6(J, rhs, dG);
    bool fin = true;
#pragma unroll
    for (int i = 0; i < 6; ++i) fin = fin && finite_val(dG[i]);
    if (!fin) {
#pragma unroll
      for (int i = 0; i < 6; ++i) dG[i] = T(0);
    }

    // backtracking line search: the first improving alpha = 0.5**k
    bool found = false;
#pragma unroll 1
    for (int k = 0; k < na.n_alphas && !found; ++k) {
      const T a = T(1) / T(1ll << k);
      T Gc[6], rc_[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) Gc[i] = G[i] + a * dG[i];
      sweep_res<T, NNIN, RK4, PER_ROD>(rc, mlp, N, Gc, yhb, zhb, tfb, rc_);
      const T r2c = sumsq6(rc_);
      if (r2c < r2) {
        found = true;
        r2 = r2c;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          G[i] = Gc[i];
          r[i] = rc_[i];
        }
      }
    }
    // no improving alpha: hold G and escalate lambda; success resets it
    if (found) {
      lam = T(0);
      fails = 0;
    } else {
      const T l = lam * growth;
      lam = l > lam0 ? l : lam0;
      ++fails;
    }
    ++it;
  }

  // final recording sweep at the solved G
  T y[19], z[6];
  base_node(rc, G, y);
  T* yo = y_out + (size_t)b * N * 19;
  T* zo = z_out + (size_t)b * (N - 1) * 6;
#pragma unroll
  for (int i = 0; i < 19; ++i) yo[i] = y[i];
  for (int j = 0; j < N - 1; ++j) {
    node_update<T, NNIN, RK4>(rc, mlp, y, yhb + 19 * j, zhb + 6 * j, tfb, z);
#pragma unroll
    for (int i = 0; i < 19; ++i) yo[19 * (j + 1) + i] = y[i];
#pragma unroll
    for (int i = 0; i < 6; ++i) zo[6 * j + i] = z[i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) G_out[6 * (size_t)b + i] = G[i];
  r2_out[b] = r2;
  iters[b] = it;
}

template <typename T, int NNIN, bool RK4>
static void launch(const RodConstsHost* h, const NewtonArgs& na,
                   const void* W1, const void* b1, const void* W2,
                   const void* b2, int hidden, int act, int per_rod, int B,
                   int N, const void* G, const void* yh, const void* zh,
                   const void* tf, void* G_out, void* y, void* z, void* r2,
                   void* iters, int block, cudaStream_t stream) {
  const Mlp<T> mlp{(const T*)W1, (const T*)b1, (const T*)W2, (const T*)b2,
                   hidden, act};
  const int grid = (B + block - 1) / block;
  const RodConsts<T> rc = cast_consts<T>(*h);
  if constexpr (NNIN != 0) {
    if (per_rod) {
      step_kernel<T, NNIN, RK4, true><<<grid, block, 0, stream>>>(
          rc, mlp, na, B, N, (const T*)G, (const T*)yh, (const T*)zh,
          (const T*)tf, (T*)G_out, (T*)y, (T*)z, (T*)r2, (int*)iters);
      return;
    }
  }
  step_kernel<T, NNIN, RK4, false><<<grid, block, 0, stream>>>(
      rc, mlp, na, B, N, (const T*)G, (const T*)yh, (const T*)zh,
      (const T*)tf, (T*)G_out, (T*)y, (T*)z, (T*)r2, (int*)iters);
}

template <typename T, int NNIN>
static void launch_m(int rk4, const RodConstsHost* h, const NewtonArgs& na,
                     const void* W1, const void* b1, const void* W2,
                     const void* b2, int hidden, int act, int per_rod, int B,
                     int N, const void* G, const void* yh, const void* zh,
                     const void* tf, void* G_out, void* y, void* z, void* r2,
                     void* iters, int block, cudaStream_t stream) {
  if (rk4)
    launch<T, NNIN, true>(h, na, W1, b1, W2, b2, hidden, act, per_rod, B, N,
                          G, yh, zh, tf, G_out, y, z, r2, iters, block,
                          stream);
  else
    launch<T, NNIN, false>(h, na, W1, b1, W2, b2, hidden, act, per_rod, B, N,
                           G, yh, zh, tf, G_out, y, z, r2, iters, block,
                           stream);
}

template <typename T>
static int launch_t(int nn_in, int rk4, const RodConstsHost* h,
                    const NewtonArgs& na, const void* W1, const void* b1,
                    const void* W2, const void* b2, int hidden, int act,
                    int per_rod, int B, int N, const void* G, const void* yh,
                    const void* zh, const void* tf, void* G_out, void* y,
                    void* z, void* r2, void* iters, int block,
                    cudaStream_t stream) {
  switch (nn_in) {
    case 0:
      launch_m<T, 0>(rk4, h, na, W1, b1, W2, b2, hidden, act, per_rod, B, N, G,
                     yh, zh, tf, G_out, y, z, r2, iters, block, stream);
      return 0;
    case 28:
      launch_m<T, 28>(rk4, h, na, W1, b1, W2, b2, hidden, act, per_rod, B, N,
                      G, yh, zh, tf, G_out, y, z, r2, iters, block, stream);
      return 0;
    case 53:
      launch_m<T, 53>(rk4, h, na, W1, b1, W2, b2, hidden, act, per_rod, B, N,
                      G, yh, zh, tf, G_out, y, z, r2, iters, block, stream);
      return 0;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// C entry point (bound with ctypes in ops/_build.py). Pointers are device
// pointers of contiguous tensors. Returns cudaGetLastError() after the
// launch.
extern "C" int knode_step(int is_f64, int nn_in, int act, int rk4, int B,
                          int N, const RodConstsHost* consts, double tol,
                          double eps0, int max_iter, int n_alphas,
                          double lm_lambda0, double lm_growth,
                          int max_escalations, const void* G, const void* yh,
                          const void* zh, const void* tf, const void* W1,
                          const void* b1, const void* W2, const void* b2,
                          int hidden, int nn_per_rod, void* G_out, void* y,
                          void* z, void* r2, void* iters, int block,
                          void* stream) {
  if (B <= 0 || N < 2 || block <= 0 || (nn_in && !W1) || n_alphas > 62 ||
      (nn_per_rod && !nn_in))
    return (int)cudaErrorInvalidValue;
  const NewtonArgs na{tol, eps0, lm_lambda0, lm_growth, max_iter, n_alphas,
                      max_escalations};
  const int bad =
      is_f64 ? launch_t<double>(nn_in, rk4, consts, na, W1, b1, W2, b2,
                                hidden, act, nn_per_rod, B, N, G, yh, zh, tf,
                                G_out, y, z, r2, iters, block,
                                (cudaStream_t)stream)
             : launch_t<float>(nn_in, rk4, consts, na, W1, b1, W2, b2, hidden,
                               act, nn_per_rod, B, N, G, yh, zh, tf, G_out, y,
                               z, r2, iters, block, (cudaStream_t)stream);
  if (bad) return bad;
  return (int)cudaGetLastError();
}
