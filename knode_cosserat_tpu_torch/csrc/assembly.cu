// K7: one coupled-assembly BDF-2 step's whole damped-Newton solve per
// launch, one thread block per assembly.
//
// Replaces knode_cosserat_tpu/ops/pallas_assembly.py::
// make_assembly_step_kernel. Plain version: knode_cosserat_tpu_torch/ops/
// assembly.py::assembly_step_reference (the same algorithm on the same
// lanes, batched in torch). Unknowns X = [G_1..G_M, p_plate, h_plate],
// U = 6M+7 <= 61 (M <= 9). Per Newton iteration, while r2 > tol,
// fails <= 4 and it < max_iter:
//   one pass over 2U+1 lanes, thread l runs lane l: thread 0 the base
//     residual r(X), threads 1..U the +h_k probes, threads U+1..2U the -h_k
//     probes (h_k = eps0 (1 + |X_k|)). A lane sweeps its M rods base to tip
//     with K1's physics (rhs_rows.cuh, rhs_node<T, 0>: no net) and closes
//     the plate algebra (core/assembly.py::_residual_algebra) in registers;
//   A[:, k] = r(X + h_k e_k) - r(X - h_k e_k) (= J[:, k] 2 h_k, central
//     difference), A_kk += lam max(|A_kk|, 2 h_k) (Levenberg-Marquardt);
//   t = A^-1 (-r) by Gauss-Jordan with partial pivoting spread over the
//     block (the pivot row: the largest |A_ik|, i >= k, ties to the lowest
//     i, found by warp 0 with shuffles); dX = 2 h t, or -r if not finite;
//   threads 0..6 evaluate X + 0.5^l dX; the first improving l wins
//     (lam = 0, fails = 0), else X holds (lam = max(30 lam, 1e-4),
//     fails += 1);
// then threads 0..M-1 each record one rod's sweep at the solved X.
//
// Shared memory holds the rods' constants, the plate's, the histories
// (M N 25 values), X, dX, h, r and the U x U system: about 57 KB at M = 9,
// N = 10, f64, so the launch raises the block's dynamic shared memory limit
// above 48 KB when it needs to.
//
// Built with -fmad=false (ops/_build.py, SOURCE_FLAGS): every multiply
// and add rounds on its own, as in the plain version and the TPU kernel.
// In float32 the system's near-null direction (the rods' axial forces,
// smallest singular value ~4e-5 at the bench assembly) turns rounding into
// where the FD-Newton stops inside its tolerance; with contraction the
// kernel stopped 3-9x farther from the float64 truth than the plain coupled
// Newton (PERF.md).
//
// What the TPU kernel needed and this one drops: the 8-row padding of the
// node slabs, broadcasting every input over 128 lanes, the lane roll for
// the central difference, and masked lane/sublane reductions for pivots.
//
// Where the H100 bounds it: the work is ~(2U+1+7) lanes x M (N-1) nodes x
// ~400 flops of physics per iteration plus U^3 for the elimination, ~0.5
// Mflop per iteration at M = 3: nothing against the card's rates. The time
// is the latency of one lane's serial chain (M (N-1) dependent node
// updates, each a few hundred dependent flops) plus U pivot steps of the
// elimination, each a few block-wide barriers, and one launch per step.
// One block of <= 128 threads leaves 131 of 132 SMs idle, like K2. Later
// work: a warp per lane (the M rods of a lane in parallel), a thread per
// (lane, rod) pair, and batching assemblies across blocks.
#include "rhs_rows.cuh"

namespace {

constexpr int kMaxRods = 9;
constexpr int kMaxU = 6 * kMaxRods + 7;
constexpr int kAlphas = 7;          // alphas 0.5^0 .. 0.5^6
constexpr int kMaxEscalations = 4;
constexpr int kPlateHead = 14;      // mass, inertia (9), g (3), c0

// Pointers into the block's dynamic shared memory.
template <typename T>
struct Smem {
  RodConsts<T>* rc;   // M
  T* plate;           // kPlateHead + 7M: then offsets (3M), quats (4M)
  T* yh;              // M N 19
  T* zh;              // M N 6
  T* tf;              // 3M
  T* ph;              // 13: pph, vph, hph, wbh
  T* X;
  T* dX;
  T* h;
  T* r;
  T* b;
  T* fac;
  T* A;               // U x U, row-major
  T* cand;            // kAlphas + 1
};

template <typename T>
__host__ __device__ size_t smem_count(int M, int N) {
  const int U = 6 * M + 7;
  return (size_t)M * (sizeof(RodConsts<T>) / sizeof(T)) + kPlateHead +
         7 * M + (size_t)M * N * 25 + 3 * M + 13 + 6 * U + (size_t)U * U +
         kAlphas + 1;
}

template <typename T>
__device__ Smem<T> carve(T* base, int M, int N) {
  const int U = 6 * M + 7;
  Smem<T> s;
  s.rc = reinterpret_cast<RodConsts<T>*>(base);
  T* p = base + (size_t)M * (sizeof(RodConsts<T>) / sizeof(T));
  s.plate = p;  p += kPlateHead + 7 * M;
  s.yh = p;     p += (size_t)M * N * 19;
  s.zh = p;     p += (size_t)M * N * 6;
  s.tf = p;     p += 3 * M;
  s.ph = p;     p += 13;
  s.X = p;      p += U;
  s.dX = p;     p += U;
  s.h = p;      p += U;
  s.r = p;      p += U;
  s.b = p;      p += U;
  s.fac = p;    p += U;
  s.A = p;      p += (size_t)U * U;
  s.cand = p;
  return s;
}

template <typename T>
__device__ __forceinline__ void quat_mul(const T* a, const T* b, T* o) {
  o[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  o[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  o[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  o[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ bool finite_val(float x) { return isfinite(x); }
__device__ __forceinline__ bool finite_val(double x) { return isfinite(x); }

// The coupled residual (U rows) at this lane's unknowns
//   X_lane[j] = X[j] + alpha dX[j] (when alpha != 0) + delta (at j == pk),
// the TPU kernel's residual_tile for one lane. Rows: tip positions (3M),
// tip orientations (3M), plate force (3), plate moment (3), |hp|^2 - 1.
template <typename T>
__device__ __noinline__ void lane_residual(const Smem<T> s, int M, int N,
                                           int pk, T delta, T alpha, T* res) {
  const Mlp<T> no_net{nullptr, nullptr, nullptr, nullptr, 0, 0};
  auto xv = [&](int j) {
    T v = s.X[j];
    if (alpha != T(0)) v = v + alpha * s.dX[j];
    if (j == pk) v = v + delta;
    return v;
  };
  const int P = 6 * M;
  T pp[3], hp[4];
#pragma unroll
  for (int c = 0; c < 3; ++c) pp[c] = xv(P + c);
#pragma unroll
  for (int c = 0; c < 4; ++c) hp[c] = xv(P + 3 + c);

  // plate rotation, the non-unit-safe form of quat_to_rotmat
  const T h1 = hp[0], h2 = hp[1], h3 = hp[2], h4 = hp[3];
  const T hh = h1 * h1 + h2 * h2 + h3 * h3 + h4 * h4;
  const T sc = T(2) / hh;
  T R[9];
  R[0] = T(1) + sc * (-h3 * h3 - h4 * h4);
  R[1] = sc * (h2 * h3 - h4 * h1);
  R[2] = sc * (h2 * h4 + h3 * h1);
  R[3] = sc * (h2 * h3 + h4 * h1);
  R[4] = T(1) + sc * (-h2 * h2 - h4 * h4);
  R[5] = sc * (h3 * h4 - h2 * h1);
  R[6] = sc * (h2 * h4 - h3 * h1);
  R[7] = sc * (h3 * h4 + h2 * h1);
  R[8] = T(1) + sc * (-h2 * h2 - h3 * h3);

  const T* pl = s.plate;
  const T mass = pl[0];
  const T* inertia = pl + 1;
  const T* g = pl + 10;
  const T c0 = pl[13];
  const T* offs = pl + kPlateHead;
  const T* aquats = offs + 3 * M;

  T sum_n[3] = {T(0), T(0), T(0)}, torque[3] = {T(0), T(0), T(0)};
  for (int i = 0; i < M; ++i) {
    const RodConsts<T>& rc = s.rc[i];
    T y[19], z[6], G[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) G[k] = xv(6 * i + k);
    base_node(rc, G, y);
    const T* yh = s.yh + (size_t)i * N * 19;
    const T* zh = s.zh + (size_t)i * N * 6;
    for (int j = 0; j < N - 1; ++j)
      node_update<T, 0, false>(rc, no_net, y, yh + 19 * j, zh + 6 * j,
                               s.tf + 3 * i, z);
    // tip position vs the attachment point pp + R off_i
    T att[3];
    mv3(R, offs + 3 * i, att);
#pragma unroll
    for (int c = 0; c < 3; ++c) res[3 * i + c] = y[c] - (pp[c] + att[c]);
    // tip orientation: vec(conj(hp * aq_i) * h_tip / |h_tip|)
    const T inv = T(1) / m_sqrt(y[3] * y[3] + y[4] * y[4] + y[5] * y[5] +
                                y[6] * y[6]);
    T htn[4], htar[4], rel[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) htn[c] = y[3 + c] * inv;
    quat_mul(hp, aquats + 4 * i, htar);
#pragma unroll
    for (int c = 1; c < 4; ++c) htar[c] = -htar[c];
    quat_mul(htar, htn, rel);
#pragma unroll
    for (int c = 0; c < 3; ++c) res[3 * M + 3 * i + c] = rel[1 + c];
    // rod i pushes on the plate with -n_i, -m_i at att
    T neg_n[3], cr[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      sum_n[c] += y[7 + c];
      neg_n[c] = -y[7 + c];
    }
    cross3(att, neg_n, cr);
#pragma unroll
    for (int c = 0; c < 3; ++c) torque[c] = torque[c] + cr[c] - y[10 + c];
  }

  // plate BDF-2 kinematics and balances
  const T* pph = s.ph;
  const T* vph = s.ph + 3;
  const T* hph = s.ph + 6;
  const T* wbh = s.ph + 10;
  T hdot[4], hc[4], q[4], wb[3], wbdot[3];
#pragma unroll
  for (int c = 0; c < 4; ++c) hdot[c] = c0 * hp[c] + hph[c];
  hc[0] = hp[0];
#pragma unroll
  for (int c = 1; c < 4; ++c) hc[c] = -hp[c];
  quat_mul(hc, hdot, q);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    wb[c] = T(2) * q[1 + c];
    wbdot[c] = c0 * wb[c] + wbh[c];
    const T vp = c0 * pp[c] + pph[c];
    const T ap = c0 * vp + vph[c];
    res[6 * M + c] = mass * (ap - g[c]) + sum_n[c];
  }
  T Jw[3], Iwd[3], wxJw[3];
  mv3(inertia, wb, Jw);
  mv3(inertia, wbdot, Iwd);
  cross3(wb, Jw, wxJw);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    res[6 * M + 3 + c] = Iwd[c] + wxJw[c] -
                         (R[c] * torque[0] + R[3 + c] * torque[1] +
                          R[6 + c] * torque[2]);
  res[6 * M + 6] = hh - T(1);
}

template <typename T>
__device__ __forceinline__ T sumsq(const T* r, int U) {
  T acc = T(0);
  for (int i = 0; i < U; ++i) acc += r[i] * r[i];
  return acc;
}

// A t = b in place (t = b / diag(A) after the loop), the TPU kernel's
// solve_tile: partial pivoting, elimination in every row but the pivot's.
template <typename T>
__device__ void gauss_jordan(T* A, T* b, T* fac, int U, int* s_piv) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int k = 0; k < U; ++k) {
    if (tid < 32) {
      T best = T(-1);
      int bi = U;
      for (int i = k + tid; i < U; i += 32) {
        const T v = m_abs(A[i * U + k]);
        if (v > best) {
          best = v;
          bi = i;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const T ob = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (ob > best || (ob == best && oi < bi)) {
          best = ob;
          bi = oi;
        }
      }
      if (tid == 0) *s_piv = bi;
    }
    __syncthreads();
    const int p = *s_piv;
    if (p != k && p < U) {
      for (int j = tid; j < U; j += nt) {
        const T t = A[k * U + j];
        A[k * U + j] = A[p * U + j];
        A[p * U + j] = t;
      }
      if (tid == 0) {
        const T t = b[k];
        b[k] = b[p];
        b[p] = t;
      }
    }
    __syncthreads();
    const T piv = A[k * U + k];
    for (int i = tid; i < U; i += nt) fac[i] = i == k ? T(0) : A[i * U + k] / piv;
    __syncthreads();
    for (int e = tid; e < U * U; e += nt) {
      const int i = e / U;
      if (i != k) A[e] -= fac[i] * A[k * U + (e - i * U)];
    }
    for (int i = tid; i < U; i += nt)
      if (i != k) b[i] -= fac[i] * b[k];
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(128)
assembly_kernel(const RodConstsHost* __restrict__ consts,
                const double* __restrict__ plate, int M, int N, T tol,
                T eps0, int max_iter, const T* __restrict__ X0,
                const T* __restrict__ yh, const T* __restrict__ zh,
                const T* __restrict__ tf, const T* __restrict__ ph,
                T* __restrict__ X_out, T* __restrict__ y_out,
                T* __restrict__ z_out, T* __restrict__ r2_out,
                int* __restrict__ it_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T s_r2, s_lam;
  __shared__ int s_it, s_fails, s_pick, s_fin, s_piv;
  const Smem<T> s = carve(reinterpret_cast<T*>(smem_raw), M, N);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int U = 6 * M + 7, L = 2 * U + 1;

  for (int i = tid; i < M; i += nt) s.rc[i] = cast_consts<T>(consts[i]);
  for (int i = tid; i < kPlateHead + 7 * M; i += nt) s.plate[i] = T(plate[i]);
  for (int i = tid; i < M * N * 19; i += nt) s.yh[i] = yh[i];
  for (int i = tid; i < M * N * 6; i += nt) s.zh[i] = zh[i];
  for (int i = tid; i < 3 * M; i += nt) s.tf[i] = tf[i];
  for (int i = tid; i < 13; i += nt) s.ph[i] = ph[i];
  for (int i = tid; i < U; i += nt) {
    s.X[i] = X0[i];
    s.dX[i] = T(0);
  }
  __syncthreads();

  T res[kMaxU];
  if (tid == 0) {
    lane_residual(s, M, N, -1, T(0), T(0), res);
    s_r2 = sumsq(res, U);
    s_lam = T(0);
    s_it = 0;
    s_fails = 0;
  }
  __syncthreads();

  while (s_r2 > tol && s_fails <= kMaxEscalations && s_it < max_iter) {
    const T r2 = s_r2, lam = s_lam;
    for (int k = tid; k < U; k += nt) s.h[k] = eps0 * (T(1) + m_abs(s.X[k]));
    __syncthreads();
    // the probe pass: base residual, +h and -h central-difference lanes
    int pk = -1;
    if (tid < L) {
      T delta = T(0);
      if (tid >= 1) {
        pk = (tid - 1) % U;
        delta = tid <= U ? s.h[pk] : -s.h[pk];
      }
      lane_residual(s, M, N, pk, delta, T(0), res);
      if (tid == 0) {
        for (int i = 0; i < U; ++i) s.r[i] = res[i];
      } else if (tid <= U) {
        for (int i = 0; i < U; ++i) s.A[i * U + pk] = res[i];
      }
    }
    __syncthreads();
    if (tid > U && tid < L)
      for (int i = 0; i < U; ++i) s.A[i * U + pk] -= res[i];
    __syncthreads();
    // Levenberg-Marquardt in probe-difference space, right-hand side -r
    for (int k = tid; k < U; k += nt) {
      const T a = s.A[k * U + k], d = m_abs(a), h2 = T(2) * s.h[k];
      s.A[k * U + k] = a + lam * (d > h2 ? d : h2);
      s.b[k] = -s.r[k];
    }
    if (tid == 0) s_fin = 1;
    __syncthreads();
    gauss_jordan(s.A, s.b, s.fac, U, &s_piv);
    for (int k = tid; k < U; k += nt) {
      const T dx = T(2) * s.h[k] * (s.b[k] / s.A[k * U + k]);
      s.dX[k] = dx;
      if (!finite_val(dx)) s_fin = 0;
    }
    __syncthreads();
    if (!s_fin)
      for (int k = tid; k < U; k += nt) s.dX[k] = -s.r[k];
    __syncthreads();
    // line search: lane l tries alpha = 0.5^l
    if (tid < kAlphas) {
      lane_residual(s, M, N, -1, T(0), T(1) / T(1 << tid), res);
      s.cand[tid] = sumsq(res, U);
    }
    __syncthreads();
    if (tid == 0) {
      int pick = -1;
      for (int l = 0; l < kAlphas; ++l)
        if (s.cand[l] < r2) {
          pick = l;
          break;
        }
      s_pick = pick;
      if (pick >= 0) {
        s_r2 = s.cand[pick];
        s_lam = T(0);
        s_fails = 0;
      } else {
        const T l = lam * T(30);
        s_lam = l > T(1e-4) ? l : T(1e-4);
        ++s_fails;
      }
      ++s_it;
    }
    __syncthreads();
    if (s_pick >= 0) {
      const T a = T(1) / T(1 << s_pick);
      for (int k = tid; k < U; k += nt) s.X[k] = s.X[k] + a * s.dX[k];
    }
    __syncthreads();
  }

  // recording sweeps at the solved X, one rod per thread
  const Mlp<T> no_net{nullptr, nullptr, nullptr, nullptr, 0, 0};
  for (int i = tid; i < M; i += nt) {
    const RodConsts<T>& rc = s.rc[i];
    T y[19], z[6];
    base_node(rc, s.X + 6 * i, y);
    T* yo = y_out + (size_t)i * N * 19;
    T* zo = z_out + (size_t)i * (N - 1) * 6;
#pragma unroll
    for (int c = 0; c < 19; ++c) yo[c] = y[c];
    for (int j = 0; j < N - 1; ++j) {
      node_update<T, 0, false>(rc, no_net, y, s.yh + ((size_t)i * N + j) * 19,
                               s.zh + ((size_t)i * N + j) * 6, s.tf + 3 * i, z);
#pragma unroll
      for (int c = 0; c < 19; ++c) yo[19 * (j + 1) + c] = y[c];
#pragma unroll
      for (int c = 0; c < 6; ++c) zo[6 * j + c] = z[c];
    }
  }
  for (int k = tid; k < U; k += nt) X_out[k] = s.X[k];
  if (tid == 0) {
    *r2_out = s_r2;
    *it_out = s_it;
  }
}

template <typename T>
int launch(int M, int N, const RodConstsHost* consts, const double* plate,
           double tol, double eps0, int max_iter, const void* X0,
           const void* yh, const void* zh, const void* tf, const void* ph,
           void* X, void* y, void* z, void* r2, void* iters,
           cudaStream_t stream) {
  const int U = 6 * M + 7;
  const int threads = ((2 * U + 1 + 31) / 32) * 32;
  const size_t bytes = smem_count<T>(M, N) * sizeof(T);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        assembly_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  assembly_kernel<T><<<1, threads, bytes, stream>>>(
      consts, plate, M, N, T(tol), T(eps0), max_iter, (const T*)X0,
      (const T*)yh, (const T*)zh, (const T*)tf, (const T*)ph, (T*)X, (T*)y,
      (T*)z, (T*)r2, (int*)iters);
  return 0;
}

}  // namespace

// C entry point (bound with ctypes in ops/_build.py). consts: M
// RodConstsHost on the device; plate: the plate's float64 constants
// (ops/assembly.py::_plate_consts) on the device; the other pointers are
// device pointers of contiguous tensors in the working type (iters int32).
// Returns cudaGetLastError() after the launch.
extern "C" int knode_assembly(int is_f64, int M, int N, const void* consts,
                              const void* plate, double tol, double eps0,
                              int max_iter, const void* X0, const void* yh,
                              const void* zh, const void* tf, const void* ph,
                              void* X, void* y, void* z, void* r2,
                              void* iters, void* stream) {
  if (M < 1 || M > kMaxRods || N < 2 || !consts || !plate)
    return (int)cudaErrorInvalidValue;
  const RodConstsHost* c = (const RodConstsHost*)consts;
  const double* pl = (const double*)plate;
  const int bad =
      is_f64 ? launch<double>(M, N, c, pl, tol, eps0, max_iter, X0, yh, zh,
                              tf, ph, X, y, z, r2, iters, (cudaStream_t)stream)
             : launch<float>(M, N, c, pl, tol, eps0, max_iter, X0, yh, zh, tf,
                             ph, X, y, z, r2, iters, (cudaStream_t)stream);
  if (bad) return bad;
  return (int)cudaGetLastError();
}
