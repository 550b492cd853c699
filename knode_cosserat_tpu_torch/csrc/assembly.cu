// K7: one coupled-assembly BDF-2 step's whole damped-Newton solve per
// launch, one thread block per assembly, a grid of B blocks for a batch
// of B systems of the same assembly.
//
// Replaces knode_cosserat_tpu/ops/pallas_assembly.py::
// make_assembly_step_kernel. Plain version: knode_cosserat_tpu_torch/ops/
// assembly.py::assembly_step_reference (the same algorithm on the same
// lanes, batched in torch). Unknowns X = [G_1..G_M, p_plate, h_plate],
// U = 6M+7 <= 61 (M <= 9). Per Newton iteration, while r2 > tol,
// fails <= 4 and it < max_iter:
//   the probe pass over 2U+1 lanes: lane 0 the base residual r(X), lanes
//     1..U the +h_k probes, lanes U+1..2U the -h_k probes (h_k = eps0
//     (1 + |X_k|)), each the M rod sweeps (K1's physics, rhs_rows.cuh,
//     rhs_node<T, 0>: no net) closed by the plate algebra
//     (core/assembly.py::_residual_algebra);
//   A[:, k] = r(X + h_k e_k) - r(X - h_k e_k) (= J[:, k] 2 h_k, central
//     difference), A_kk += lam max(|A_kk|, 2 h_k) (Levenberg-Marquardt);
//   t = A^-1 (-r) by Gauss-Jordan with partial pivoting (the pivot: the
//     largest |A_ik| over positions i >= k, ties to the lowest position);
//     dX = 2 h t, or -r if not finite;
//   the candidates X + 0.5^l dX, l < 7; the first improving l wins
//     (lam = 0, fails = 0), else X holds (lam = max(30 lam, 1e-4),
//     fails += 1);
// then threads 0..M-1 each record one rod's sweep at the solved X.
//
// Layout: a pass sweeps only the (rod, lane) pairs whose base reaction
// differs, one thread per job, and writes each job's tip (position,
// quaternion, n, m: 13 values) to shared memory; then one thread per lane
// closes the lane's residual from the tips: the base lane into r and each
// +h probe into its column of A, then, after a barrier, each -h probe
// subtracted from that column (A = R+ - R-, the same single subtraction
// per element as before), and the LM term on the diagonal; a line-search
// candidate closes into a row of A, free by then. A probe on G_i changes rod
// i's sweep alone and a probe on the plate pose changes none, so the probe
// pass is 13M jobs (rod i: job 13i its base sweep, 13i+1..13i+6 the +h
// probes of its 6 unknowns, 13i+7..13i+12 the -h probes; ops/assembly.py::
// probe_jobs), where lane by lane it would be (2U+1) M sweeps; the line
// search is 7M jobs (rod i, alpha l: job 7i+l). A borrowed tip is the same
// code on the same inputs as the lane's own sweep, and the closure sums
// over the rods in the order i = 0..M-1, so every lane's residual has the
// bits it had when each lane swept its M rods itself.
//
// The elimination keeps each element's arithmetic (fac = A_ik / A_kk,
// A_ij -= fac A_kj, b_i -= fac b_k, every row but the pivot's, every
// column) and its pivot rule, and changes only the mapping: the rows stay
// in place and each thread tracks the position of its row (a swap is a
// relabelling); two threads per row share its columns (a warp barrier
// between reading A_ik and writing it), and the pivot search for column
// k+1 runs as the elimination of column k writes that column, each warp
// reducing its candidates and the warps meeting on a board in shared
// memory (PivotBoard), so one block barrier per pivot where the old
// mapping had three and moved rows. (A row per lane of one warp, with
// warp barriers only, measured 1-3% slower at M = 3 and 4: PERF.md.)
// Every shared-memory pointer comes from the k7_smem symbol: passed as
// arguments, the compiler had lost their address space and emitted generic
// loads, 3.5k cycles a pivot at M = 9 against ~1.5k with shared ones.
//
// Shared memory holds the rods' constants, the plate's, the histories
// (M N 25 values), X, dX, h, b, r, the U x U system in padded rows and the
// tips (13M x 13): about 71 KB at M = 9, N = 10, f64 (125 KB at N = 40),
// so every launch sets the block's dynamic shared memory limit. The
// longest rod that fits: ops/assembly.py::launch_plan (N = 99 at M = 9,
// f64).
//
// Built with -fmad=false (ops/_build.py, SOURCE_FLAGS): every multiply
// and add rounds on its own, as in the plain version and the TPU kernel.
// In float32 the system's near-null direction (the rods' axial forces,
// smallest singular value ~4e-5 at the bench assembly) turns rounding into
// where the FD-Newton stops inside its tolerance; with contraction the
// kernel stopped 3-9x farther from the float64 truth than the plain coupled
// Newton (PERF.md).
//
// A batch (the JAX kernel under jax.vmap, which Pallas runs as a grid of B
// programs): block b reads its X0, histories, tendon forces and plate
// histories at offset b, writes its own outputs and runs its own Newton
// loop (every decision is on the block's own shared scalars), leaving
// when its system is done; the rods' and the plate's constants are shared.
// Nothing global is written but a block's own outputs, so each system's
// results are, bit for bit, those of a launch of its own.
//
// Where the H100 bounds it: per iteration 20M rod sweeps of N-1 nodes of
// ~400 flops and the elimination's 2 U^3: ~0.2 Mflop at M = 3, nothing
// against the card's rates. The time is latency: a job's serial chain of
// N-1 dependent node updates, twice an iteration, and U pivot steps of
// one barrier each, on one block of <= 128 threads (131 of 132 SMs idle,
// one assembly per launch as in the JAX kernel). Measured at M = 9, f32
// (PERF.md): ~120k cycles an iteration, 78% of it the elimination,
// ~1.5k cycles a pivot (the slots, the division, the row update, the
// butterfly); the sweeps ~10%.
#include "rhs_rows.cuh"

namespace {

constexpr int kMaxRods = 9;
constexpr int kMaxU = 6 * kMaxRods + 7;
constexpr int kMaxThreads = 128;
constexpr int kMaxWarps = kMaxThreads / WARP;
constexpr int kAlphas = 7;          // alphas 0.5^0 .. 0.5^6
constexpr int kMaxEscalations = 4;
constexpr int kPlateHead = 14;      // mass, inertia (9), g (3), c0
constexpr int kTip = 13;            // tip p (3), h (4), n (3), m (3)
constexpr int kRodJobs = 13;        // a rod's base sweep and 12 probes

// The block's dynamic shared memory. Every function takes its pointers
// from this symbol (smem_of), never through a pointer argument, so that
// the compiler knows them for shared memory and emits shared loads and
// stores rather than generic ones.
extern __shared__ __align__(16) unsigned char k7_smem[];

// Pointers into it.
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
  T* b;
  T* r;               // r(X), the base lane's residual
  T* A;               // U x lda(U), row-major
  T* cand;            // kAlphas + 1
  T* tips;            // kRodJobs M jobs x kTip
};

// A's row length: U rounded up to whole 32-column strips (the elimination
// runs over whole strips, with no test per element), plus 2 so that the
// rows a warp updates at once fall in different banks.
__host__ __device__ inline int lda(int U) { return (U + 31) / 32 * 32 + 2; }

// Values of the working type in the block's dynamic shared memory; the
// launch plan (ops/assembly.py::launch_plan) counts the same.
template <typename T>
__host__ __device__ size_t smem_count(int M, int N) {
  const int U = 6 * M + 7;
  return (size_t)M * (sizeof(RodConsts<T>) / sizeof(T)) + kPlateHead +
         7 * M + (size_t)M * N * 25 + 3 * M + 13 + 5 * U +
         (size_t)U * lda(U) + kAlphas + 1 + (size_t)kRodJobs * M * kTip;
}

// The block's threads: one per probe job, per lane and per line-search
// job, rounded up to whole warps.
__host__ __device__ inline int block_threads(int M) {
  const int U = 6 * M + 7;
  int n = kRodJobs * M;
  if (2 * U + 1 > n) n = 2 * U + 1;
  if (kAlphas * M > n) n = kAlphas * M;
  return (n + WARP - 1) / WARP * WARP;
}

template <typename T>
__device__ __forceinline__ Smem<T> smem_of(int M, int N) {
  const int U = 6 * M + 7;
  T* base = reinterpret_cast<T*>(k7_smem);
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
  s.b = p;      p += U;
  s.r = p;      p += U;
  s.A = p;      p += (size_t)U * lda(U);
  s.cand = p;   p += kAlphas + 1;
  s.tips = p;
  return s;
}

// Small vectors passed by value (a pointer argument would send the
// caller's array to local memory).
template <typename T, int K>
struct Vec {
  T v[K];
};

template <int K, typename T>
__device__ __forceinline__ Vec<T, K> load_vec(const T* p) {
  Vec<T, K> o;
#pragma unroll
  for (int c = 0; c < K; ++c) o.v[c] = p[c];
  return o;
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

// The probe job that gives lane l its tip of rod j: the rod's own +-h
// probe where lane l perturbs one of G_j's 6 unknowns, else its base
// sweep (ops/assembly.py::probe_jobs).
__device__ __forceinline__ int probe_job(int l, int j, int M, int U) {
  const int job = kRodJobs * j;
  if (l == 0) return job;
  const bool minus = l > U;
  const int pk = minus ? l - 1 - U : l - 1;
  return (pk < 6 * M && pk / 6 == j) ? job + 1 + pk % 6 + (minus ? 6 : 0)
                                     : job;
}

// Rod i's sweep from base reaction G to its tip, written as job `job`'s
// kTip values.
template <typename T>
__device__ __noinline__ void sweep_tip(int M, int N, int i, Vec<T, 6> G,
                                       int job) {
  const Smem<T> s = smem_of<T>(M, N);
  const Mlp<T> no_net{nullptr, nullptr, nullptr, nullptr, 0, 0};
  const RodConsts<T>& rc = s.rc[i];
  T* tip = s.tips + kTip * job;
  T y[19], z[6];
  base_node(rc, G.v, y);
  const T* yh = s.yh + (size_t)i * N * 19;
  const T* zh = s.zh + (size_t)i * N * 6;
  for (int j = 0; j < N - 1; ++j)
    node_update<T, 0, false>(rc, no_net, y, yh + 19 * j, zh + 6 * j,
                             s.tf + 3 * i, z);
#pragma unroll
  for (int c = 0; c < kTip; ++c) tip[c] = y[c];
}

// Where close_lane puts a lane's U residuals: r (the base lane), column
// `at` of A (a +h probe), subtracted from that column (a -h probe), or row
// `at` of A (a line-search candidate).
enum Dest { kToR, kToCol, kSubCol, kToRow };

// The coupled residual (U rows) of one lane from its plate pose
// x7 = [pp, hp] and its rods' tips (rod i's: job tip_of(i)), put where
// `dest` and `at` say; the TPU kernel's residual_tile for one lane. Rows:
// tip positions (3M), tip orientations (3M), plate force (3), plate
// moment (3), |hp|^2 - 1.
template <typename T, typename TipOf>
__device__ __noinline__ void close_lane(int M, int N, Vec<T, 7> x7,
                                        TipOf tip_of, Dest dest, int at) {
  const Smem<T> s = smem_of<T>(M, N);
  const int ld = lda(6 * M + 7);
  T* out = dest == kToR     ? s.r
           : dest == kToRow ? s.A + (size_t)at * ld
                            : s.A + at;
  const int step = dest == kToCol || dest == kSubCol ? ld : 1;
  const bool sub = dest == kSubCol;
  const auto put = [=](int i, T v) {
    T& o = out[(size_t)i * step];
    o = sub ? o - v : v;
  };
  T pp[3], hp[4];
#pragma unroll
  for (int c = 0; c < 3; ++c) pp[c] = x7.v[c];
#pragma unroll
  for (int c = 0; c < 4; ++c) hp[c] = x7.v[3 + c];

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
    const T* y = s.tips + kTip * tip_of(i);
    // tip position vs the attachment point pp + R off_i
    T att[3];
    mv3(R, offs + 3 * i, att);
#pragma unroll
    for (int c = 0; c < 3; ++c) put(3 * i + c, y[c] - (pp[c] + att[c]));
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
    for (int c = 0; c < 3; ++c) put(3 * M + 3 * i + c, rel[1 + c]);
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
    put(6 * M + c, mass * (ap - g[c]) + sum_n[c]);
  }
  T Jw[3], Iwd[3], wxJw[3];
  mv3(inertia, wb, Jw);
  mv3(inertia, wbdot, Iwd);
  cross3(wb, Jw, wxJw);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    put(6 * M + 3 + c, Iwd[c] + wxJw[c] -
                           (R[c] * torque[0] + R[3 + c] * torque[1] +
                            R[6 + c] * torque[2]));
  put(6 * M + 6, hh - T(1));
}

template <typename T>
__device__ __forceinline__ T sumsq(const T* r, int U) {
  T acc = T(0);
  for (int i = 0; i < U; ++i) acc += r[i] * r[i];
  return acc;
}

// The pivot rule: the largest |A_ik| over positions i >= k, ties to the
// lowest position; a NaN never wins (the TPU kernel's search starts from
// -1 and takes only a larger |A_ik|), unless every candidate is NaN, when
// the lowest position wins. Each warp finds its best candidate by a
// butterfly of shuffles and writes it to its slot (two sets, alternating
// by pivot); every thread then reduces the slots to the winner.
struct PivotAt {
  int pos, row;
};

template <typename T>
struct PivotBoard {
  struct Slot {
    T key;    // |A_ik|, -1 for a NaN, -2 for no candidate
    int at;   // position * 256 + row
  };
  Slot slot[2][kMaxWarps];

  static __device__ bool beats(const Slot& a, const Slot& b) {
    return (a.key > b.key) | ((a.key == b.key) & (a.at < b.at));
  }
  // Every thread of the block: its candidate for pivot k (ok: it has one).
  __device__ void publish(int k, T a, bool ok, int pos, int row) {
    const T v = m_abs(a);
    Slot c{ok ? (v == v ? v : T(-1)) : T(-2), pos * 256 + row};
#pragma unroll
    for (int m = WARP / 2; m > 0; m >>= 1) {
      const Slot o{__shfl_xor_sync(0xffffffffu, c.key, m),
                   __shfl_xor_sync(0xffffffffu, c.at, m)};
      const bool w = beats(o, c);
      c.key = w ? o.key : c.key;
      c.at = w ? o.at : c.at;
    }
    if (threadIdx.x % WARP == 0) slot[k & 1][threadIdx.x / WARP] = c;
  }
  __device__ PivotAt best(int k) const {
    Slot b = slot[k & 1][0];
    for (int w = 1; w < (int)blockDim.x / WARP; ++w)
      if (beats(slot[k & 1][w], b)) b = slot[k & 1][w];
    return PivotAt{b.at >> 8, b.at & 255};
  }
};

// Row r of the elimination, A_rj -= fac A_pj for j = j0 + step u,
// u < 16: a whole batch (A's padded rows hold it; the padding columns
// carry values that nothing reads), its loads before its stores, as the
// two rows never alias.
template <typename T>
__device__ __forceinline__ void eliminate(T* Ar, const T* Ap, T fac, int j0,
                                          int step) {
  constexpr int kN = 16;
  T a[kN], p[kN];
#pragma unroll
  for (int u = 0; u < kN; ++u) {
    a[u] = Ar[j0 + u * step];
    p[u] = Ap[j0 + u * step];
  }
#pragma unroll
  for (int u = 0; u < kN; ++u) Ar[j0 + u * step] = a[u] - fac * p[u];
}

// A t = b in place (A, b: the Smem's), the TPU kernel's solve_tile
// (partial pivoting, elimination in every row but the pivot's), with the
// rows left where they are: on return perm[k] is the row at position k,
// and t_k = b[perm[k]] / A[perm[k]][k]. Two threads per row.
template <typename T>
__device__ void gauss_jordan(const Smem<T>& s, int U, int* perm,
                             PivotBoard<T>& board) {
  const int tid = threadIdx.x, ld = lda(U);
  const int batches = ((U + 1) / 2 + 15) / 16;
  T* A = s.A;
  T* b = s.b;
  const bool owner = tid < 2 * U;
  const int r = owner ? tid / 2 : 0, half = tid % 2;
  T* Ar = A + (size_t)r * ld;
  int pos = r;
  board.publish(0, owner ? Ar[0] : T(0), owner && half == 0, pos, r);
  __syncthreads();
  for (int k = 0; k < U; ++k) {
    const PivotAt best = board.best(k);
    const int p = best.row;
    if (pos == best.pos) pos = k;
    else if (pos == k) pos = best.pos;
    const T* Ap = A + (size_t)p * ld;
    const T piv = Ap[k];
    const T a = owner ? Ar[k] : T(0);
    __syncwarp();
    T next = T(0);
    if (owner && r != p) {
      const T fac = a / piv;
      for (int q = 0; q < batches; ++q)
        eliminate(Ar, Ap, fac, half + 32 * q, 2);
      if (half == 0) b[r] -= fac * b[p];
    }
    if (k + 1 < U) {
      const bool mine = owner && half == ((k + 1) & 1) && pos > k;
      if (mine) next = Ar[k + 1];
      board.publish(k + 1, next, mine, pos, r);
    }
    __syncthreads();
  }
  if (owner && half == 0) perm[pos] = r;
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
assembly_kernel(const RodConstsHost* __restrict__ consts,
                const double* __restrict__ plate, int M, int N, T tol,
                T eps0, int max_iter, const T* __restrict__ X0,
                const T* __restrict__ yh, const T* __restrict__ zh,
                const T* __restrict__ tf, const T* __restrict__ ph,
                T* __restrict__ X_out, T* __restrict__ y_out,
                T* __restrict__ z_out, T* __restrict__ r2_out,
                int* __restrict__ it_out) {
  __shared__ T s_r2, s_lam;
  __shared__ int s_it, s_fails, s_pick, s_fin;
  __shared__ int s_perm[kMaxU];
  __shared__ PivotBoard<T> s_board;
  const Smem<T> s = smem_of<T>(M, N);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int U = 6 * M + 7, ld = lda(U);
  // this block's system of the batch
  const size_t sys = blockIdx.x;
  X0 += sys * U;
  yh += sys * M * N * 19;
  zh += sys * M * N * 6;
  tf += sys * 3 * M;
  ph += sys * 13;
  X_out += sys * U;
  y_out += sys * M * N * 19;
  z_out += sys * M * (N - 1) * 6;
  r2_out += sys;
  it_out += sys;

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
  for (int i = tid; i < U * ld; i += nt) s.A[i] = T(0);
  __syncthreads();

  // the first residual: the M base sweeps, closed by thread 0
  if (tid < M)
    sweep_tip<T>(M, N, tid, load_vec<6>(s.X + 6 * tid), kRodJobs * tid);
  __syncthreads();
  if (tid == 0) {
    close_lane<T>(M, N, load_vec<7>(s.X + 6 * M),
                  [=](int i) { return kRodJobs * i; }, kToR, 0);
    s_r2 = sumsq(s.r, U);
    s_lam = T(0);
    s_it = 0;
    s_fails = 0;
  }
  __syncthreads();

  while (s_r2 > tol && s_fails <= kMaxEscalations && s_it < max_iter) {
    const T r2 = s_r2, lam = s_lam;
    for (int k = tid; k < U; k += nt) s.h[k] = eps0 * (T(1) + m_abs(s.X[k]));
    __syncthreads();
    // the probe sweeps: job t = 13 i + q, rod i; q = 0 its base, q = 1..6
    // +h on its unknown q-1, q = 7..12 -h on its unknown q-7
    if (tid < kRodJobs * M) {
      const int i = tid / kRodJobs, q = tid % kRodJobs;
      Vec<T, 6> G = load_vec<6>(s.X + 6 * i);
      if (q > 0) {
        const int c = (q - 1) % 6;
        const T delta = q <= 6 ? s.h[6 * i + c] : -s.h[6 * i + c];
#pragma unroll
        for (int e = 0; e < 6; ++e)
          if (e == c) G.v[e] = G.v[e] + delta;
      }
      sweep_tip<T>(M, N, i, G, tid);
    }
    __syncthreads();
    // the lanes' residuals: lane 0 to r and the +h probe of unknown k
    // (lane 1 + k) to column k of A, then the -h probe of k (lane
    // U + 1 + k) subtracted from it: A[:, k] = R+_k - R-_k
    const auto close_probe = [&](int l, Dest dest, int at) {
      Vec<T, 7> x7 = load_vec<7>(s.X + 6 * M);
      const int pk = l == 0 ? -1 : (l - 1) % U;
      if (pk >= 6 * M) {
        const T delta = l <= U ? s.h[pk] : -s.h[pk];
#pragma unroll
        for (int e = 0; e < 7; ++e)
          if (e == pk - 6 * M) x7.v[e] = x7.v[e] + delta;
      }
      close_lane<T>(M, N, x7, [=](int i) { return probe_job(l, i, M, U); },
                    dest, at);
    };
    if (tid <= U) close_probe(tid, tid == 0 ? kToR : kToCol, tid - 1);
    __syncthreads();
    if (tid < U) close_probe(U + 1 + tid, kSubCol, tid);
    __syncthreads();
    // Levenberg-Marquardt on the diagonal (probe-difference space),
    // right-hand side -r
    for (int k = tid; k < U; k += nt) {
      T* a = s.A + (size_t)k * ld + k;
      const T d = m_abs(*a), h2 = T(2) * s.h[k];
      *a = *a + lam * (d > h2 ? d : h2);
      s.b[k] = -s.r[k];
    }
    if (tid == 0) s_fin = 1;
    __syncthreads();
    gauss_jordan(s, U, s_perm, s_board);
    for (int k = tid; k < U; k += nt) {
      const int p = s_perm[k];
      const T dx = T(2) * s.h[k] * (s.b[p] / s.A[(size_t)p * ld + k]);
      s.dX[k] = dx;
      if (!finite_val(dx)) s_fin = 0;
    }
    __syncthreads();
    if (!s_fin)
      for (int k = tid; k < U; k += nt) s.dX[k] = -s.r[k];
    __syncthreads();
    // line search: job 7 i + l sweeps rod i at alpha = 0.5^l; thread l
    // closes candidate l
    if (tid < kAlphas * M) {
      const int i = tid / kAlphas;
      const T alpha = T(1) / T(1 << (tid % kAlphas));
      Vec<T, 6> G;
#pragma unroll
      for (int c = 0; c < 6; ++c)
        G.v[c] = s.X[6 * i + c] + alpha * s.dX[6 * i + c];
      sweep_tip<T>(M, N, i, G, tid);
    }
    __syncthreads();
    if (tid < kAlphas) {
      const T alpha = T(1) / T(1 << tid);
      Vec<T, 7> x7;
#pragma unroll
      for (int c = 0; c < 7; ++c)
        x7.v[c] = s.X[6 * M + c] + alpha * s.dX[6 * M + c];
      close_lane<T>(M, N, x7, [=](int i) { return kAlphas * i + tid; },
                    kToRow, tid);
      s.cand[tid] = sumsq(s.A + (size_t)tid * ld, U);
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
int launch(int B, int M, int N, const RodConstsHost* consts,
           const double* plate,
           double tol, double eps0, int max_iter, const void* X0,
           const void* yh, const void* zh, const void* tf, const void* ph,
           void* X, void* y, void* z, void* r2, void* iters, int threads,
           int smem, cudaStream_t stream) {
  const size_t bytes = smem_count<T>(M, N) * sizeof(T);
  if (threads != block_threads(M) || (size_t)smem != bytes)
    return (int)cudaErrorInvalidValue;
  // Set at every launch: the 48 KB a block gets by default counts the
  // kernel's static __shared__ variables too, so a plan just under 48 KB
  // (M = 6, N = 10, f64: 48,944 B) needs it as well.
  const cudaError_t e = cudaFuncSetAttribute(
      assembly_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) {
    cudaGetLastError();   // the error is returned, not left behind
    return (int)e;
  }
  assembly_kernel<T><<<B, threads, bytes, stream>>>(
      consts, plate, M, N, T(tol), T(eps0), max_iter, (const T*)X0,
      (const T*)yh, (const T*)zh, (const T*)tf, (const T*)ph, (T*)X, (T*)y,
      (T*)z, (T*)r2, (int*)iters);
  return 0;
}

}  // namespace

// C entry point (bound with ctypes in ops/_build.py). B: the systems of
// the batch, one block each; consts: M RodConstsHost on the device; plate:
// the plate's float64 constants (ops/assembly.py::_plate_consts) on the
// device; the other pointers are device pointers of contiguous tensors in
// the working type (iters int32), each with a leading B.
// threads and smem come from ops/assembly.py::launch_plan and are
// checked against the kernel's own shape. Returns the first CUDA error of
// the shared-memory attribute or the launch, 0 on success.
extern "C" int knode_assembly(int is_f64, int B, int M, int N,
                              const void* consts,
                              const void* plate, double tol, double eps0,
                              int max_iter, const void* X0, const void* yh,
                              const void* zh, const void* tf, const void* ph,
                              void* X, void* y, void* z, void* r2,
                              void* iters, int threads, int smem,
                              void* stream) {
  if (B < 1 || M < 1 || M > kMaxRods || N < 2 || !consts || !plate)
    return (int)cudaErrorInvalidValue;
  const RodConstsHost* c = (const RodConstsHost*)consts;
  const double* pl = (const double*)plate;
  const int bad =
      is_f64 ? launch<double>(B, M, N, c, pl, tol, eps0, max_iter, X0, yh,
                              zh, tf, ph, X, y, z, r2, iters, threads, smem,
                              (cudaStream_t)stream)
             : launch<float>(B, M, N, c, pl, tol, eps0, max_iter, X0, yh, zh,
                             tf, ph, X, y, z, r2, iters, threads, smem,
                             (cudaStream_t)stream);
  if (bad) return bad;
  return (int)cudaGetLastError();
}
