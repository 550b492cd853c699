// K2: one BDF-2 step's whole damped-Newton shooting solve per launch, one
// block per rod (hybrid net) or per STEP_PHYS_RODS rods (physics only).
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
// then a final sweep records y (B, N, 19) and z (B, N-1, 6). Where
// `sweeps` is not null (only while a profiler runs: ops/step.py) each rod's
// count of the sweeps its solve took is written there: the first
// residual, the probes, the line-search candidates it ran (alpha = 1 alone,
// then tiles) and the recording sweep.
//
// The net is one for all rods, or one per rod (nn_per_rod = 1: rod b reads
// the b-th of B nets stacked on a leading axis, each tensor at b times its
// per-net size) -- the JAX package lifts the step kernel over per-cell
// params with vmap for the eval tables; here the rod index is the cell.
//
// What the TPU kernel needed and this one drops: pre-stalled pad lanes,
// the f32-carried fails/found masks, 8-row padding of the node slabs, and
// running every line-search candidate. Each rod loops on its own, so
// `iters` is each rod's own iteration count (the TPU wrote one count per
// block of rods).
//
// Mapping. A rod has STEP_LANES lanes; a lane is a warp over
// rhs_node_coop with the net (the block, 7 warps, stages the rod's net
// into shared memory once when it fits: ops/step.py::launch_plan), or a
// thread without it. The solve runs as phases, each one sweep per busy
// lane: the first residual; the 6 probes of an iteration together (lanes
// 0-5, so the Jacobian's columns arrive at once); alpha = 1 alone, and
// only if it does not improve the remaining candidates as one tile of up
// to 7 (the smallest improving k is taken, which is the sequential rule's
// pick; running every candidate at once was slower at batch 1, 40 and
// 256, PERF.md); the recording sweep. With the net, a phase of one lane
// runs it on the whole block (rhs_node_coop over 224 threads; 30% off a
// step at batch 1 against one warp, PERF.md), a tile on one warp per
// lane. Between phases a barrier, and one thread per rod (its leader) reads the lanes' residuals
// from shared memory, solves the 6x6 (solve6), and moves the rod's state
// machine (RodState: G, r, r2, lam, fails, it, the phase). Every thread
// reads the phase after the barrier, so a rod's block takes one branch
// and no barrier sits in divergent code.
//
// Where the H100 bounds it: with the net at hidden 512, a lane-node is
// ~54 kflop whose every weight comes from shared memory (see
// rhs_rows.cuh: ~860 cycles of the SM's shared-memory bandwidth per
// lane-node, f32); a step is ~2 + 2-3 phases per iteration of N-1 nodes
// each. At batch 1 the phases' latency sets the time, most of it the
// probe phases (one warp per lane, 16 units per thread in a dependent
// chain); at batch 256 the 256 blocks share the 132 SMs and the
// shared-memory bandwidth bounds it. Physics only, a step is a few
// hundred flops per lane-node: launch- and latency-bound.
#include "rhs_rows.cuh"

constexpr int STEP_LANES = 7;      // lanes per rod
constexpr int STEP_PHYS_RODS = 4;  // rods per block without the net

enum Phase { PH_FIRST = 0, PH_PROBE, PH_ALPHA, PH_RECORD, PH_DONE };

// One rod's solver in shared memory. Its size enters the launch plan
// (ops/step.py::_STATE_BYTES).
template <typename T>
struct RodState {
  T G[6], r[6], dG[6], h[6];
  T cG[STEP_LANES][6], cr[STEP_LANES][6];   // the lanes' G and residual
  T red[STEP_LANES + 1][25];                // mlp_coop's block scratch
  T r2, lam;
  int phase, it, fails, k0, count, sweeps;  // count lanes run alpha k0+l
};
static_assert(sizeof(RodState<float>) == 1264, "ops/step.py::_STATE_BYTES");
static_assert(sizeof(RodState<double>) == 2504, "ops/step.py::_STATE_BYTES");

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

// The next iteration, or the recording sweep when the rod has stopped.
template <typename T>
__device__ __forceinline__ void next_iteration(RodState<T>& S,
                                               const NewtonArgs& na) {
  S.phase = (S.it < na.max_iter && S.r2 > T(na.tol) &&
             S.fails <= na.max_escalations)
                ? PH_PROBE
                : PH_RECORD;
}

// The rod's leader, after a phase's sweeps: read the lanes' residuals and
// move the solver on.
template <typename T>
__device__ void advance(RodState<T>& S, const NewtonArgs& na, int b,
                        T* __restrict__ G_out, T* __restrict__ r2_out,
                        int* __restrict__ iters, int* __restrict__ sweeps) {
  // the sweeps of the phase just run: one lane, the 6 probes, or the
  // tile of candidates
  if (S.phase != PH_DONE)
    S.sweeps += S.phase == PH_PROBE ? 6 : S.phase == PH_ALPHA ? S.count : 1;
  switch (S.phase) {
    case PH_FIRST: {
#pragma unroll
      for (int i = 0; i < 6; ++i) S.r[i] = S.cr[0][i];
      S.r2 = sumsq6(S.r);
      next_iteration(S, na);
      break;
    }
    case PH_PROBE: {
      T J[36], rhs[6], dG[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) {
#pragma unroll
        for (int i = 0; i < 6; ++i)
          J[6 * i + k] = (S.cr[k][i] - S.r[i]) / S.h[k];
      }
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const T d = m_abs(J[7 * i]);
        J[7 * i] += S.lam * (d > T(1) ? d : T(1));
        rhs[i] = -S.r[i];
      }
      solve6(J, rhs, dG);
      bool fin = true;
#pragma unroll
      for (int i = 0; i < 6; ++i) fin = fin && finite_val(dG[i]);
#pragma unroll
      for (int i = 0; i < 6; ++i) S.dG[i] = fin ? dG[i] : T(0);
      S.k0 = 0;
      S.count = 1;     // alpha = 1 alone, then the rest as one tile
      S.phase = PH_ALPHA;
      if (na.n_alphas > 0) break;
      S.count = 0;     // no candidate at all: a stall
    }
    // fall through
    case PH_ALPHA: {
      int pick = -1;
      T r2c = T(0);
      for (int l = 0; l < S.count && pick < 0; ++l) {
        r2c = sumsq6(S.cr[l]);
        if (r2c < S.r2) pick = l;
      }
      if (pick >= 0) {
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          S.G[i] = S.cG[pick][i];
          S.r[i] = S.cr[pick][i];
        }
        S.r2 = r2c;
        S.lam = T(0);
        S.fails = 0;
      } else if (S.k0 + S.count < na.n_alphas) {
        S.k0 += S.count;       // the next tile of candidates
        S.count = min(STEP_LANES, na.n_alphas - S.k0);
        break;
      } else {                 // no improving alpha: hold G, escalate
        const T l = S.lam * T(na.lm_growth);
        S.lam = l > T(na.lm_lambda0) ? l : T(na.lm_lambda0);
        ++S.fails;
      }
      ++S.it;
      next_iteration(S, na);
      break;
    }
    case PH_RECORD: {
#pragma unroll
      for (int i = 0; i < 6; ++i) G_out[6 * (size_t)b + i] = S.G[i];
      r2_out[b] = S.r2;
      iters[b] = S.it;
      if (sweeps) sweeps[b] = S.sweeps;
      S.phase = PH_DONE;
      break;
    }
    default:
      break;
  }
}

template <int NNIN>
constexpr int step_threads() {
  return NNIN ? STEP_LANES * WARP : STEP_LANES * STEP_PHYS_RODS;
}

// Thread t: rod (t / (STEP_LANES * GS)) of the block, lane (t / GS) %
// STEP_LANES, GS threads per lane. The lane's first thread writes its
// results; lane 0's first thread is the rod's leader.
template <typename T, int NNIN, bool RK4, int NETM>
__global__ void __launch_bounds__(step_threads<NNIN>())
    step_kernel(const RodConsts<T> rc,
                const typename NetOf<T, NETM>::In nin, const NewtonArgs na,
                int B, int N, int per_rod, size_t w_bytes,
                const T* __restrict__ G_in, const T* __restrict__ yh,
                const T* __restrict__ zh, const T* __restrict__ tf,
                T* __restrict__ G_out, T* __restrict__ y_out,
                T* __restrict__ z_out, T* __restrict__ r2_out,
                int* __restrict__ iters, int* __restrict__ sweeps) {
  constexpr int GS = NNIN ? WARP : 1;
  constexpr int RPB = NNIN ? 1 : STEP_PHYS_RODS;
  extern __shared__ double smem_d[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem_d);
  typename NetOf<T, NETM>::View net{};
  if constexpr (NNIN > 0 && NETM == NET_DEEP) {
    // block b runs net b of the stack
    net = deep_view<T>(nin, sm, per_rod ? blockIdx.x : 0);
  } else if constexpr (NNIN > 0) {
    Mlp<T> m = nin;
    if (per_rod) {           // block b runs net b of the stack
      const size_t h = (size_t)m.hidden, b = blockIdx.x;
      m.W1 += b * h * NNIN;
      m.b1 += b * h;
      m.W2 += b * h * 25;
      m.b2 += b * 25;
    }
    net = net_view<T, NNIN, NETM == NET_SMEM>(m, (T*)smem_d);
  }
  RodState<T>* states = reinterpret_cast<RodState<T>*>(sm + w_bytes);

  const int t = threadIdx.x;
  const int lane = (t / GS) % STEP_LANES;
  // a deep net's activation scratch: the lane's own, and lane 0's for a
  // phase the whole block runs
  T* buf = nullptr;
  T* buf_wide = nullptr;
  if constexpr (NETM == NET_DEEP) {
    buf = deep_scratch<T>(nin, sm, lane);
    buf_wide = deep_scratch<T>(nin, sm, 0);
  }
  const bool writer = t % GS == 0;
  const bool leader = writer && lane == 0;
  const int b = blockIdx.x * RPB + t / (STEP_LANES * GS);
  const bool live = b < B;
  RodState<T>& S = states[t / (STEP_LANES * GS)];
  const size_t bb = live ? b : 0;
  const T* yhb = yh + bb * N * 19;
  const T* zhb = zh + bb * N * 6;
  const T tfb[3] = {tf[3 * bb], tf[3 * bb + 1], tf[3 * bb + 2]};
  if (leader && live) {
#pragma unroll
    for (int i = 0; i < 6; ++i) S.G[i] = G_in[6 * bb + i];
    S.lam = T(0);
    S.phase = PH_FIRST;
    S.it = S.fails = S.k0 = S.sweeps = 0;
    S.count = 1;
  }
  __syncthreads();
  const T eps0 = T(na.eps0);

  for (;;) {
    // the lanes' sweeps of this phase (each rod's lanes read its phase).
    // With the net, a phase of one busy lane runs it on the whole block.
    if (live) {
      const int ph = S.phase;
      const bool wide = NNIN > 0 && (ph == PH_FIRST || ph == PH_RECORD ||
                                     (ph == PH_ALPHA && S.count == 1));
      const int l = wide ? 0 : lane;
      const bool put = wide ? t == 0 : writer;
      bool go = false;
      T Gc[6];
      if (ph == PH_FIRST || ph == PH_RECORD) {
        go = l == 0;
#pragma unroll
        for (int i = 0; i < 6; ++i) Gc[i] = S.G[i];
      } else if (ph == PH_PROBE) {
        go = l < 6;
        if (go) {
          const T h = eps0 * (T(1) + m_abs(S.G[l]));
#pragma unroll
          for (int i = 0; i < 6; ++i) Gc[i] = i == l ? S.G[i] + h : S.G[i];
          if (put) S.h[l] = h;
        }
      } else if (ph == PH_ALPHA) {
        go = l < S.count;
        if (go) {
          const T a = T(1) / T(1ll << (S.k0 + l));
#pragma unroll
          for (int i = 0; i < 6; ++i) Gc[i] = S.G[i] + a * S.dG[i];
        }
      }
      if (go) {
        const bool rec = ph == PH_RECORD;
        T r[6];
        sweep_lane<T, NNIN, RK4>(
            rc, net, N, Gc, yhb, zhb, tfb, r,
            rec ? y_out + bb * N * 19 : nullptr,
            rec ? z_out + bb * (N - 1) * 6 : nullptr, put,
            wide ? &S.red[0][0] : nullptr, wide ? buf_wide : buf);
        if (put) {
#pragma unroll
          for (int i = 0; i < 6; ++i) {
            S.cG[l][i] = Gc[i];
            S.cr[l][i] = r[i];
          }
        }
      }
    }
    __syncthreads();
    if (leader && live) advance(S, na, b, G_out, r2_out, iters, sweeps);
    // the leaders' own word on whether their rods go on (another
    // thread could still see the phase before this advance)
    if (!__syncthreads_or(leader && live && S.phase != PH_DONE)) break;
  }
}

template <typename T, int NNIN, bool RK4>
static int launch(const RodConstsHost* h, const NewtonArgs& na,
                  const Mlp<T>& mlp, const NetTableHost* deep, int per_rod,
                  int B, int N, const void* G, const void* yh, const void* zh,
                  const void* tf, void* G_out, void* y, void* z, void* r2,
                  void* iters, void* sweeps, int threads, int smem,
                  int staged, cudaStream_t stream) {
  constexpr int RPB = NNIN ? 1 : STEP_PHYS_RODS;
  if (threads != step_threads<NNIN>() || (staged && !NNIN))
    return (int)cudaErrorInvalidValue;
  const int grid = (B + RPB - 1) / RPB;
  if constexpr (NNIN > 0) {
    if (deep) {           // a net of three layers or more
      const size_t w_bytes = deep_smem_bytes<T>(*deep, STEP_LANES);
      if ((size_t)smem != w_bytes + sizeof(RodState<T>) ||
          staged != deep->staged)
        return (int)cudaErrorInvalidValue;
      auto kern = step_kernel<T, NNIN, RK4, NET_DEEP>;
      if (const int e = allow_smem(kern, smem)) return e;
      kern<<<grid, threads, smem, stream>>>(
          cast_consts<T>(*h), *deep, na, B, N, per_rod, w_bytes,
          (const T*)G, (const T*)yh, (const T*)zh, (const T*)tf, (T*)G_out,
          (T*)y, (T*)z, (T*)r2, (int*)iters, (int*)sweeps);
      return 0;
    }
  }
  const size_t w_bytes = staged ? net_smem_bytes<T>(NNIN, mlp.hidden) : 0;
  if ((size_t)smem != w_bytes + RPB * sizeof(RodState<T>))
    return (int)cudaErrorInvalidValue;
  void (*kern)(const RodConsts<T>, const Mlp<T>, const NewtonArgs, int, int,
               int, size_t, const T*, const T*, const T*, const T*, T*, T*,
               T*, T*, int*, int*) = step_kernel<T, NNIN, RK4, NET_GLOBAL>;
  if constexpr (NNIN > 0) {
    if (staged) kern = step_kernel<T, NNIN, RK4, NET_SMEM>;
  }
  if (const int e = allow_smem(kern, smem)) return e;
  kern<<<grid, threads, smem, stream>>>(
      cast_consts<T>(*h), mlp, na, B, N, per_rod, w_bytes, (const T*)G,
      (const T*)yh, (const T*)zh, (const T*)tf, (T*)G_out, (T*)y, (T*)z,
      (T*)r2, (int*)iters, (int*)sweeps);
  return 0;
}

template <typename T, int NNIN>
static int launch_m(int rk4, const RodConstsHost* h, const NewtonArgs& na,
                    const Mlp<T>& mlp, const NetTableHost* deep, int per_rod,
                    int B, int N, const void* G, const void* yh,
                    const void* zh, const void* tf, void* G_out, void* y,
                    void* z, void* r2, void* iters, void* sweeps, int threads,
                    int smem, int staged, cudaStream_t stream) {
  return rk4 ? launch<T, NNIN, true>(h, na, mlp, deep, per_rod, B, N, G, yh,
                                     zh, tf, G_out, y, z, r2, iters, sweeps,
                                     threads, smem, staged, stream)
             : launch<T, NNIN, false>(h, na, mlp, deep, per_rod, B, N, G, yh,
                                      zh, tf, G_out, y, z, r2, iters, sweeps,
                                      threads, smem, staged, stream);
}

template <typename T>
static int launch_t(int nn_in, int rk4, const RodConstsHost* h,
                    const NewtonArgs& na, const void* W1, const void* b1,
                    const void* W2, const void* b2, int hidden, int act,
                    const NetTableHost* deep, int per_rod, int B, int N,
                    const void* G, const void* yh, const void* zh,
                    const void* tf, void* G_out, void* y, void* z, void* r2,
                    void* iters, void* sweeps, int threads, int smem,
                    int staged, cudaStream_t stream) {
  const Mlp<T> mlp{(const T*)W1, (const T*)b1, (const T*)W2, (const T*)b2,
                   hidden, act};
  switch (nn_in) {
    case 0:
      return launch_m<T, 0>(rk4, h, na, mlp, nullptr, 0, B, N, G, yh, zh, tf,
                            G_out, y, z, r2, iters, sweeps, threads, smem,
                            staged, stream);
    case 28:
      return launch_m<T, 28>(rk4, h, na, mlp, deep, per_rod, B, N, G, yh, zh,
                             tf, G_out, y, z, r2, iters, sweeps, threads,
                             smem, staged, stream);
    case 53:
      return launch_m<T, 53>(rk4, h, na, mlp, deep, per_rod, B, N, G, yh, zh,
                             tf, G_out, y, z, r2, iters, sweeps, threads,
                             smem, staged, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// C entry point (bound with ctypes in ops/_build.py). Pointers are device
// pointers of contiguous tensors. A two-layer net comes as W1, b1, W2, b2
// and hidden with `deep` null; a net of three layers or more as the layer
// table `deep` (a host pointer; W1 .. b2 unused). threads, smem and staged
// come from ops/step.py::launch_plan and are checked against the kernel's
// own shape. `sweeps` (int, B) is null or receives each rod's sweep
// count. Returns the first CUDA error of the shared-memory attribute
// or the launch, 0 on success.
extern "C" int knode_step(int is_f64, int nn_in, int act, int rk4, int B,
                          int N, const RodConstsHost* consts, double tol,
                          double eps0, int max_iter, int n_alphas,
                          double lm_lambda0, double lm_growth,
                          int max_escalations, const void* G, const void* yh,
                          const void* zh, const void* tf, const void* W1,
                          const void* b1, const void* W2, const void* b2,
                          int hidden, const NetTableHost* deep,
                          int nn_per_rod, void* G_out, void* y, void* z,
                          void* r2, void* iters, void* sweeps, int threads,
                          int smem, int staged, void* stream) {
  if (B <= 0 || N < 2 || (nn_in && !deep && (!W1 || hidden <= 0)) ||
      (deep && !deep_table_ok(*deep, nn_in)) || n_alphas > 62 ||
      (nn_per_rod && !nn_in))
    return (int)cudaErrorInvalidValue;
  const NewtonArgs na{tol, eps0, lm_lambda0, lm_growth, max_iter, n_alphas,
                      max_escalations};
  const int bad =
      is_f64 ? launch_t<double>(nn_in, rk4, consts, na, W1, b1, W2, b2,
                                hidden, act, deep, nn_per_rod, B, N, G, yh,
                                zh, tf, G_out, y, z, r2, iters, sweeps,
                                threads, smem, staged, (cudaStream_t)stream)
             : launch_t<float>(nn_in, rk4, consts, na, W1, b1, W2, b2, hidden,
                               act, deep, nn_per_rod, B, N, G, yh, zh, tf,
                               G_out, y, z, r2, iters, sweeps, threads, smem,
                               staged, (cudaStream_t)stream);
  if (bad) return bad;
  return (int)cudaGetLastError();
}
