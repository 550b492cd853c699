// K4: the whole KNODE training run, n_epochs per launch, on one thread-block
// cluster that splits the hidden units.
//
// Replaces knode_cosserat_tpu/ops/pallas_train.py::_make_run_one (via
// make_fused_training_run). Plain version:
// knode_cosserat_tpu_torch/ops/train.py::train_run_reference (the same
// epoch loop with an autograd gradient). Inputs are the per-cell constants
// of ops/train.py::precompute, cell-major: x (C, din), y_base (C, 19),
// z_phys (C, 6), tgt_y (C, 19), tgt_z (C, 6), e_tgt (C, 3). Per epoch:
//   forward   H = elu(W1 X + b1) (h x C), NN = W2 H + b2 (25 x C)
//   loss      y = y_base + ds NN[:19], z = z_phys + NN[19:], the four mean
//             squared groups (pos, states 7:19, Euler angles of the
//             quaternion, z) with per-trajectory denominators; G = dL/dNN
//             by hand, through the reference's quaternion->Euler map
//   backward  dW2 = G H^T, db2 = sum G, dA = (W2^T G) * elu'(A),
//             dW1 = dA X^T, db1 = sum dA
//   update    reduce-on-plateau on this epoch's loss, then bias-corrected
//             Adam(W) with t = t0 + e + 1, then the clamp of the weights
//             (not the biases) at 0 -- training/train.py:AdamPlateau.
// The weights, both moments, the plateau state and the Adam count carry
// from epoch to epoch inside the launch; the run writes the per-epoch
// losses, the new weights and moments and the 4 scalars (count, best,
// plateau count, scale), so chunked runs compose.
//
// K5 (knode_train_grid) is this kernel over a grid of experiment cells: it
// replaces knode_cosserat_tpu/ops/pallas_train.py::
// make_fused_grid_training_run (jax.vmap of the run over the (data x mod x
// seed) cells). Run g trains cell g on its own slabs, net, moments,
// scalars and ds (grid_cell below); the cells of one launch share C, din,
// hidden, the hyperparameters and the loss denominators (one trajectory
// count: parallel/grid.py splits a grid into such sub-grids). Plain
// version: train_run_reference per cell (ops/train.py::train_grid_reference).
//
// Design (the plan is ops/train.py::launch_plan, checked here). A cluster
// is CL = 8 blocks of 512 threads; one run spreads over P clusters. Block
// rank r owns the hidden units [r U, r U + U), U = ceil(h / CL): their W1
// rows (transposed, with b1 as an extra row) and W2 columns stay in its
// shared memory for the launch, in UP unit slots (U rounded up to a power
// of two, >= 16; unowned slots hold zeros). The cells are cut into parts
// of 128 (kTile: the part count depends on C alone), and cluster p of a
// run takes parts p, p + P, ...; a part streams through shared memory as
// one tile (X is staged once per launch by a cluster that owns one part).
// Parts of 128 rather than 256 spread train-real's 1,904 cells over 15
// clusters rather than 8 of an H100's 16: 36 against 56 us an epoch there
// (PERF.md). For the accumulations, thread t is slot u = t % UP of
// cell slice s = t / UP, one of S = 512 / UP slices; for the products over
// a part it takes 4 slots x UP / 16 cells; so every width keeps all 512
// threads busy. Per part:
//   F1  A = b1 + W1 x, H = elu(A) -> Hs (UP x 128), 4 slots x UP / 16
//       cells a thread (per input, a float4 of W1 and UP / 16 cells of X)
//   F2  this block's partial NN over its units, 4 cells x 5 outputs per
//       thread -> its partial buffer P[buf] (25 x 128)
//   --  cluster.sync(): every block's partial is complete
//   N   every block reads the CL partials of each (output, cell) through
//       distributed shared memory and sums them in rank order 0..CL-1,
//       plus b2: every block holds the same bits of NN
//   L   every block takes the loss and cotangent G of every cell of the
//       part (one thread per cell), the same in every block
//   B1  thread (u, s) accumulates dW2[o][u] for the outputs o = s + S i
//       over all the part's cells (slot 0 also db2[o]), in registers
//   B2  dA = (W2^T G) elu'(H) in place of H, tiled as F1
//   B3  thread (u, s) accumulates dW1[u][k] for the inputs k = s + S i
//       over all the part's cells (k = din is db1: X's extra row of ones)
//   --  the part's gradient, formed from zero, and its loss go to the run's
//       scratch in device memory: slab t holds part t's entries, rank by
//       rank in the shared-memory layout of W1t / W2s (row k, slot u), then
//       db2 and the loss (written by rank 0)
// The partial buffers alternate between parts (the other one holds this
// part's NN, then G): a block rewrites a buffer only after the next
// cluster.sync, when every block has read it, so one cluster barrier a part
// suffices. At the epoch's end, after a barrier across the run's clusters
// (a cluster.sync when P = 1), block r of cluster p folds the p-th of P
// slices of rank r's entries over all parts in part order, ((part 0 +
// part 1) + part 2) + ..., and applies Adam(W) and the clamp to exactly
// those entries (their weights and moments in its shared memory); every
// block folds db2 and the parts' losses in the same order, so every
// cluster takes the same plateau decision and b2 update (b2's moments in
// shared memory) with no further message. When P > 1 each block then
// writes its slice's new weights to the run's exchange slab and, after a
// second barrier, reloads the other clusters' slices of its units from
// it. The fold runs the same float
// operations for every P, so a run's bits do not depend on P: a run repeats
// bit for bit, and K5's run g equals a K4 launch on cell g bit for bit,
// whatever P each used. Cluster 0's rank 0 writes b2, its moments, the
// losses and the scalars; each thread keeps its entries' moments in shared
// memory for the launch. Adam's bias corrections (double-precision powers)
// are computed by all threads at once, 512 epochs ahead. Everything is
// float32 on the CUDA cores (no TF32); atan2/asin are the native ones. The
// plateau's comparison runs in double, as the plain version's (on Python
// floats).
//
// P is min(parts, max(1, resident / G)) for G runs a launch and the
// clusters the card holds at once (ops/train.py::clusters_per_run). When
// P > 1 the barrier needs every cluster of the launch resident: the launch
// carries cudaLaunchAttributeCooperative beside the cluster dimension (the
// card refuses a launch it cannot hold at once rather than hang it; the
// H100 takes such launches, so the fold stays inside the one launch rather
// than at a kernel boundary between launches), and the barrier is a count
// and a generation per run in device memory (run_barrier), which each
// completed barrier leaves at count 0, so the wrapper keeps one zeroed
// pair per run across launches. A K5 grid whose runs fill the card has
// P = 1: no cooperative launch, no barrier, its clusters run in waves.
//
// What bounds it: per epoch 2 C h (2 din + 75) FMA-flops, 255.4 MFLOP at
// C=1,904, h=512, din=28: 3.8 us at the card's 67 TFLOP/s float32 peak, and
// ~1.3 MB a launch of cells, weights and moments read and written once
// (~0.4 us at 3.35 TB/s), so the bound is compute. A cluster takes CL = 8
// of the 132 SMs: a run on P clusters has P x 8/132 of that peak for its
// ceiling, and a part is the smallest piece of work. Within a block,
// shared memory delivers 128 B a clock to registers, broadcast or not: a
// phase whose thread loads one float per FMA runs at a quarter of the FMA
// rate, hence F1's and B2's register tiles; B1 and B3 (one unit per
// thread) and N, which moves 25 x 128 x CL floats through distributed
// shared memory per part, are the largest phases left (PERF.md).
#include <cooperative_groups.h>

#include "train_common.cuh"

namespace cg = cooperative_groups;

struct TrainArgs {
  const float* cells[6];  // x, y_base, z_phys, tgt_y, tgt_z, e_tgt
  const float* w_in[4];   // W1 (h, din), b1 (h), W2 (25, h), b2 (25)
  const float* m_in[8];   // mu, nu of W1, b1, W2, b2 (shapes as above)
  const float* s_in;      // count, best, plateau count, scale
  float* w_out[4];
  float* m_out[8];
  float* s_out;
  float* losses;          // (n_epochs,)
  int C, din, hidden, n_epochs, patience, clamp;
  double lr, weight_decay, factor, rtol, ds;
  double inv[4];          // mean denominators: pos, states, eul, z
  const double* ds_grid;  // K5: each grid cell's ds (device); K4: null
  float* part;            // scratch, run_floats() a run: the parts' partial
                          // gradients and losses, and the weight exchange
  unsigned* bar;          // (2 a run): the run barrier's count (0 between
                          // launches) and generation
};

// The launch shape, ops/train.py::launch_plan.
struct TrainPlan {
  int threads;   // per block
  int cluster;   // blocks per cluster
  int units;     // hidden units owned by each block
  int slots;     // unit slots per block (units rounded up, >= 16)
  int tile;      // cells per part
  int smem;      // dynamic shared memory per block, bytes
  int clusters;  // clusters a run (P)
};

constexpr int kThreads = 512;
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kTile = 128;          // cells per part (one tile)
constexpr int kQuads = kTile / 4;   // cell quads per tile
constexpr int kTP = kTile + 4;      // row stride of the cell-wide buffers
constexpr int kMinSlots = kThreads / kQuads;   // a cell quad per slice

// The arguments of grid cell g: every slab, weight, moment, scalar and loss
// pointer advanced past the g cells before it (K5 stacks them on a leading
// grid axis; K4 is cell 0 of a grid of one), and the cell's own ds.
__device__ TrainArgs grid_cell(const TrainArgs& a, int g) {
  TrainArgs c = a;
  const size_t C = a.C, h = a.hidden;
  const size_t cw[6] = {(size_t)a.din, 19, 6, 19, 6, 3};
  const size_t pw[4] = {h * a.din, h, h * kOut, kOut};
#pragma unroll
  for (int i = 0; i < 6; ++i) c.cells[i] += g * C * cw[i];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c.w_in[i] += g * pw[i];
    c.w_out[i] += g * pw[i];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      c.m_in[2 * i + j] += g * pw[i];
      c.m_out[2 * i + j] += g * pw[i];
    }
  }
  c.s_in += 4 * (size_t)g;
  c.s_out += 4 * (size_t)g;
  c.losses += (size_t)g * a.n_epochs;
  if (a.ds_grid) c.ds = a.ds_grid[g];
  return c;
}

// Floats of dynamic shared memory for din inputs and UP unit slots.
__host__ __device__ constexpr int smem_floats(int din, int up) {
  return (din + 1) * kTP        // Xs: X tile transposed, + a row of ones
         + up * kTP             // Hs: H, then dA
         + 2 * kOut * kTP       // P[2]: partial NN; NN then G
         + (din + 1) * up       // W1t: W1 transposed, + b1
         + kOut * up            // W2s
         + 4 * 32;              // b2, its two moments, warp loss sums
}

// The scratch of one run: a slab per part (each rank's (din + 26) x UP
// entries of W1t / W2s's layout, then db2 and the loss), and one slab for
// the weight exchange.
__device__ constexpr size_t slab_floats(int cl, int din, int up) {
  return (size_t)cl * (din + 1 + kOut) * up + 32;
}

__device__ constexpr size_t run_floats(int cl, int din, int up,
                                       int parts) {
  return (parts + 1) * slab_floats(cl, din, up);
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ void add_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" :: "l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ void store_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" :: "l"(p), "r"(v)
               : "memory");
}

// Where entry x of a block's units (W1t / W2s's row x / UP, slot x % UP,
// the block's first unit u0) keeps its moments: m_in / m_out's pair m (0
// W1, 2 b1, 4 W2) and the index in it.
template <int DIN, int UP>
__device__ __forceinline__ size_t moment_at(int x, int u0, int h, int& m) {
  const int row = x / UP, j = u0 + x % UP;
  m = row < DIN ? 0 : row == DIN ? 2 : 4;
  return row < DIN ? (size_t)j * DIN + row
         : row == DIN ? (size_t)j : (size_t)(row - DIN - 1) * h + j;
}

// ((p[0] + p[stride]) + p[2 stride]) + ... over n parts: the fold's one
// order, whatever the clusters of the run. The loads go out 16 at a time,
// ahead of their adds.
__device__ __forceinline__ float fold_parts(const float* p, int n,
                                            size_t stride) {
  float v = p[0];
  for (int t0 = 1; t0 < n; t0 += 16) {
    float q[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      q[j] = t0 + j < n ? p[(t0 + j) * stride] : 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (t0 + j < n) v += q[j];
  }
  return v;
}

// The barrier of one run's n blocks: each arrives on the count (acquire
// and release, after the block's own barrier); the last resets it and
// advances the generation (release), on which the others wait (acquire).
// Every write a block made before it is visible to every block after it.
__device__ void run_barrier(unsigned* bar, unsigned n) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned gen = load_acquire(bar + 1);
    if (add_acq_rel(bar, 1u) == n - 1) {
      store_relaxed(bar, 0u);
      add_release(bar + 1, 1u);
    } else {
      while (load_acquire(bar + 1) == gen) __nanosleep(32);
    }
  }
  __syncthreads();
}

// N consecutive cells of a shared-memory row, in float4s where N allows
template <int N>
__device__ __forceinline__ void load_cells(float* v, const float* row) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(row)[q];
      v[4 * q] = f.x, v[4 * q + 1] = f.y, v[4 * q + 2] = f.z,
      v[4 * q + 3] = f.w;
    }
  } else if constexpr (N == 2) {
    const float2 f = *reinterpret_cast<const float2*>(row);
    v[0] = f.x, v[1] = f.y;
  } else {
    v[0] = row[0];
  }
}

template <int N>
__device__ __forceinline__ void store_cells(float* row, const float* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      reinterpret_cast<float4*>(row)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(row) = make_float2(v[0], v[1]);
  } else {
    row[0] = v[0];
  }
}

template <int DIN, int NQ>
__global__ void __launch_bounds__(kThreads, 1) train_kernel(
    const TrainArgs grid_args, int units, int P) {
  constexpr int S = kQuads / NQ;       // cell slices
  constexpr int UP = kThreads / S;     // unit slots
  constexpr int KR = DIN + 1;          // W1's rows and b1
  constexpr int NK = (KR + S - 1) / S;     // W1 / b1 rows per thread
  constexpr int NO = (kOut + S - 1) / S;   // W2 rows per thread
  constexpr int E = (KR + kOut) * UP;      // entries of a rank (W1t, W2s)
  constexpr int EPT = (E + kThreads - 1) / kThreads;   // a thread's, at most
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int run = blockIdx.x / CL / P, p = blockIdx.x / CL % P;
  const TrainArgs a = grid_cell(grid_args, run);

  extern __shared__ float4 smem4[];
  __shared__ AdamStep step_s;                    // this epoch's Adam step
  __shared__ float2 bc_s[kThreads];              // bias corrections of the
                                                 // next kThreads epochs
  __shared__ float fold_s[32];                   // db2 and the loss, folded
  // the moments of this thread's entries of the fold, [mu / nu][i][tid],
  // in shared memory for the launch (read from m_in, written to m_out)
  __shared__ float mom_s[2][EPT][kThreads];
  float* Xs = reinterpret_cast<float*>(smem4);   // KR x kTP
  float* Hs = Xs + KR * kTP;                     // UP x kTP
  float* Pb = Hs + UP * kTP;                     // 2 x 25 x kTP
  float* W1t = Pb + 2 * kOut * kTP;              // KR x UP
  float* W2s = W1t + KR * UP;                    // 25 x UP (W1t's rows on)
  float* b2s = W2s + kOut * UP;                  // 25 (32)
  float* b2m = b2s + 32;                         // b2's moments
  float* b2v = b2m + 32;
  float* wsum = b2v + 32;                        // the part's warp losses

  const int tid = threadIdx.x, h = a.hidden, C = a.C;
  const int u = tid % UP, s = tid / UP;      // B1 / B3 / the partials
  const int tg = tid % (UP / 4), tc = tid / (UP / 4);   // F1 / B2 tiles
  const int u0 = rank * units;
  const int nu = max(0, min(units, h - u0));     // units this block owns
  const bool own = u < nu;
  const int n_parts = (C + kTile - 1) / kTile;
  const int mine = (n_parts - p + P - 1) / P;    // parts this cluster takes
  // the run's scratch (slab t: part t's partials; slab n_parts: the weight
  // exchange), found where it is used rather than held through the parts
  const size_t slab = slab_floats(CL, DIN, UP);
  auto slab_at = [&](int t) {
    return grid_args.part + (blockIdx.x / CL / P) *
        run_floats(CL, DIN, UP, n_parts) + t * slab;
  };

  // this block's units' weights into shared memory (zeros in the unowned
  // slots), and the moments of this thread's entries of the fold
  {
    const int lo = (int)((long)p * E / P), hi = (int)((long)(p + 1) * E / P);
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const int x = lo + tid + i * kThreads;
      if (x < hi && x % UP < nu) {
        int m;
        const size_t at = moment_at<DIN, UP>(x, u0, h, m);
        const float* const mu = m == 0 ? a.m_in[0] : m == 2 ? a.m_in[2]
                                                            : a.m_in[4];
        const float* const nv = m == 0 ? a.m_in[1] : m == 2 ? a.m_in[3]
                                                            : a.m_in[5];
        mom_s[0][i][tid] = mu[at];
        mom_s[1][i][tid] = nv[at];
      }
    }
  }
  for (int i = tid; i < KR * UP; i += kThreads) {
    const int k = i / UP, uu = i % UP;
    W1t[i] = uu >= nu ? 0.f
             : k < DIN ? a.w_in[0][(size_t)(u0 + uu) * DIN + k]
                       : a.w_in[1][u0 + uu];
  }
  for (int i = tid; i < kOut * UP; i += kThreads) {
    const int o = i / UP, uu = i % UP;
    W2s[i] = uu < nu ? a.w_in[2][(size_t)o * h + u0 + uu] : 0.f;
  }
  if (tid < kOut) {
    b2s[tid] = a.w_in[3][tid];
    b2m[tid] = a.m_in[6][tid];
    b2v[tid] = a.m_in[7][tid];
  }
  for (int i = tid; i < kTP; i += kThreads) Xs[DIN * kTP + i] = 1.f;

  const float t0 = a.s_in[0];
  float best = a.s_in[1];
  int pcount = (int)a.s_in[2];
  double scale = a.s_in[3];
  const float ds = (float)a.ds;
  const float inv[4] = {(float)a.inv[0], (float)a.inv[1], (float)a.inv[2],
                        (float)a.inv[3]};
  const float* X = a.cells[0];
  const float4* Hs4 = reinterpret_cast<const float4*>(Hs + u * kTP);
  int buf = 0;
  // the cluster's partial buffers, by rank (a larger cluster never runs:
  // the C entry's plan makes it 8 at most, or the card refuses it)
  if (CL > kMaxCluster) __trap();
  const float* peer[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    peer[r] = r < CL ? cluster.map_shared_rank(Pb, r) : Pb;

  for (int e = 0; e < a.n_epochs; ++e) {
    if (e % kThreads == 0 && e + tid < a.n_epochs)
      bc_s[tid] = bias_corrections((double)t0 + e + tid + 1);

    for (int t = p; t < n_parts; t += P) {
      const int c0 = t * kTile, n = min(kTile, C - c0), nq = (n + 3) / 4;
      float gW1[NK], gW2[NO], gB2[NO];
#pragma unroll
      for (int i = 0; i < NK; ++i) gW1[i] = 0.f;
#pragma unroll
      for (int i = 0; i < NO; ++i) gW2[i] = gB2[i] = 0.f;
      if (mine > 1 || e == 0) {
        // X part, transposed to DIN x kTile; the ragged edge is zero
        __syncthreads();
        for (int i = tid; i < kTile * DIN; i += kThreads) {
          const int c = i / DIN, k = i - c * DIN;
          Xs[k * kTP + c] = c < n ? X[(size_t)c0 * DIN + i] : 0.f;
        }
      }
      __syncthreads();

      // F1: A = b1 + W1 x, H = elu(A) for this thread's tile of 4 unit
      // slots x NQ cells (all the part's cells: those past n are zeros,
      // their H unused)
      {
        float acc[4][NQ];
        const float4 b = reinterpret_cast<const float4*>(W1t + DIN * UP)[tg];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < NQ; ++c) acc[i][c] = lane(b, i);
#pragma unroll 4
        for (int k = 0; k < DIN; ++k) {
          const float4 w = reinterpret_cast<const float4*>(W1t + k * UP)[tg];
          float x[NQ];
          load_cells<NQ>(x, Xs + k * kTP + NQ * tc);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < NQ; ++c) acc[i][c] += lane(w, i) * x[c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int c = 0; c < NQ; ++c) acc[i][c] = elu(acc[i][c]);
          store_cells<NQ>(Hs + (4 * tg + i) * kTP + NQ * tc, acc[i]);
        }
      }
      __syncthreads();

      // F2: this block's partial NN, P[o][c] = sum_u W2[o][u] H[u][c]
      float* Pp = Pb + buf * kOut * kTP;
      if (tid < 5 * kQuads) {
        const int q = tid % kQuads, og = tid / kQuads;
        if (q < nq) {
          float acc[5][4];
#pragma unroll
          for (int i = 0; i < 5; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
          for (int uu = 0; uu < nu; ++uu) {
            const float4 hv = reinterpret_cast<const float4*>(Hs + uu * kTP)[q];
#pragma unroll
            for (int i = 0; i < 5; ++i) {
              const float w = W2s[(og * 5 + i) * UP + uu];
              acc[i][0] += w * hv.x;
              acc[i][1] += w * hv.y;
              acc[i][2] += w * hv.z;
              acc[i][3] += w * hv.w;
            }
          }
#pragma unroll
          for (int i = 0; i < 5; ++i)
            reinterpret_cast<float4*>(Pp + (og * 5 + i) * kTP)[q] =
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        }
      }
      cluster.sync();

      // N: NN = the CL partials in rank order, + b2, into the other buffer
      float* G = Pb + (buf ^ 1) * kOut * kTP;
      {
        const int nc = 4 * nq;
#pragma unroll 2
        for (int i = tid; i < kOut * nc; i += kThreads) {
          const int o = i / nc, c = i - o * nc;
          const int at = (buf * kOut + o) * kTP + c;
          float pr[kMaxCluster];
#pragma unroll
          for (int r = 0; r < kMaxCluster; ++r)
            pr[r] = r < CL ? peer[r][at] : 0.f;
          float v = pr[0];
#pragma unroll
          for (int r = 1; r < kMaxCluster; ++r)
            if (r < CL) v += pr[r];
          G[o * kTP + c] = v + b2s[o];
        }
      }
      __syncthreads();

      // L: loss and cotangent of every cell of the part, G in place of NN
      if (tid < kTile) {
        float lc = 0.f;
        if (tid < n) {
          float nn[kOut], g[kOut];
#pragma unroll
          for (int o = 0; o < kOut; ++o) nn[o] = G[o * kTP + tid];
          const size_t gc = (size_t)(c0 + tid);
          lc = cell_loss(nn, a.cells[1] + gc * 19, a.cells[2] + gc * 6,
                         a.cells[3] + gc * 19, a.cells[4] + gc * 6,
                         a.cells[5] + gc * 3, ds, inv, g);
#pragma unroll
          for (int o = 0; o < kOut; ++o) G[o * kTP + tid] = g[o];
        } else if (tid < 4 * nq) {
#pragma unroll
          for (int o = 0; o < kOut; ++o) G[o * kTP + tid] = 0.f;
        }
        lc = warp_sum(lc);
        if ((tid & 31) == 0) wsum[tid >> 5] = lc;
      }
      __syncthreads();

      // B1: dW2[o][u] (and db2[o] on slot 0) for this thread's outputs
      if (own) {
#pragma unroll 4
        for (int q = 0; q < nq; ++q) {
          const float4 hv = Hs4[q];
#pragma unroll
          for (int i = 0; i < NO; ++i) {
            const int o = s + S * i;
            if (o < kOut) {
              const float4 gv =
                  reinterpret_cast<const float4*>(G + o * kTP)[q];
              gW2[i] += gv.x * hv.x;
              gW2[i] += gv.y * hv.y;
              gW2[i] += gv.z * hv.z;
              gW2[i] += gv.w * hv.w;
            }
          }
        }
      }
      if (u == 0) {
#pragma unroll 4
        for (int q = 0; q < nq; ++q) {
#pragma unroll
          for (int i = 0; i < NO; ++i) {
            const int o = s + S * i;
            if (o < kOut) {
              const float4 gv =
                  reinterpret_cast<const float4*>(G + o * kTP)[q];
              gB2[i] += ((gv.x + gv.y) + gv.z) + gv.w;
            }
          }
        }
      }
      __syncthreads();

      // B2: dA = (W2^T G) elu'(H) for this thread's tile, in place of H
      // (the cells past 4 nq read stale G and are never used)
      {
        float dh[4][NQ];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < NQ; ++c) dh[i][c] = 0.f;
#pragma unroll 5
        for (int o = 0; o < kOut; ++o) {
          const float4 w = reinterpret_cast<const float4*>(W2s + o * UP)[tg];
          float g[NQ];
          load_cells<NQ>(g, G + o * kTP + NQ * tc);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < NQ; ++c) dh[i][c] += lane(w, i) * g[c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* hr = Hs + (4 * tg + i) * kTP + NQ * tc;
          float hv[NQ];
          load_cells<NQ>(hv, hr);
#pragma unroll
          for (int c = 0; c < NQ; ++c) hv[c] = dh[i][c] * elu_grad(hv[c]);
          store_cells<NQ>(hr, hv);
        }
      }
      __syncthreads();

      // B3: dW1[u][k] (k = DIN: db1) for this thread's inputs
      if (own) {
#pragma unroll 4
        for (int q = 0; q < nq; ++q) {
          const float4 dv = Hs4[q];
#pragma unroll
          for (int i = 0; i < NK; ++i) {
            const int k = s + S * i;
            if (k < KR) {
              const float4 xv =
                  reinterpret_cast<const float4*>(Xs + k * kTP)[q];
              gW1[i] += dv.x * xv.x;
              gW1[i] += dv.y * xv.y;
              gW1[i] += dv.z * xv.z;
              gW1[i] += dv.w * xv.w;
            }
          }
        }
      }

      // the part's gradient and loss into its slab
      float* sl = slab_at(t);
      if (own) {
        float* mine_rows = sl + (size_t)rank * E + u;
#pragma unroll
        for (int i = 0; i < NK; ++i)
          if (s + S * i < KR) mine_rows[(s + S * i) * UP] = gW1[i];
#pragma unroll
        for (int i = 0; i < NO; ++i)
          if (s + S * i < kOut) mine_rows[(KR + s + S * i) * UP] = gW2[i];
      }
      if (rank == 0) {
        float* tail = sl + (size_t)CL * E;
        if (u == 0) {
#pragma unroll
          for (int i = 0; i < NO; ++i)
            if (s + S * i < kOut) tail[s + S * i] = gB2[i];
        }
        if (tid == 0) {
          float tl = wsum[0];
#pragma unroll
          for (int w = 1; w < kTile / 32; ++w) tl += wsum[w];
          tail[kOut] = tl;
        }
      }
      buf ^= 1;
    }

    // every part's slab is written: this thread's entries of the block's
    // slice folded over the parts and their moments loaded, db2 and the
    // loss folded alike; then reduce_on_plateau and Adam's constants, once
    unsigned* bar = grid_args.bar + 2 * (blockIdx.x / CL / P);
    if (P > 1) run_barrier(bar, P * CL);
    else cluster.sync();
    const int lo = (int)((long)p * E / P), hi = (int)((long)(p + 1) * E / P);
    const float* parts = slab_at(0) + (size_t)rank * E;
    float gs[EPT];
    if (hi - lo <= kThreads) {
      // at most an entry a thread
      if (lo + tid < hi && (lo + tid) % UP < nu)
        gs[0] = fold_parts(parts + lo + tid, n_parts, slab);
    } else {
      // every entry of this thread part by part, their loads together
      bool ok[EPT];
#pragma unroll
      for (int i = 0; i < EPT; ++i) {
        const int x = lo + tid + i * kThreads;
        ok[i] = x < hi && x % UP < nu;
        gs[i] = ok[i] ? parts[x] : 0.f;
      }
      for (int t = 1; t < n_parts; ++t) {
        float q[EPT];
#pragma unroll
        for (int i = 0; i < EPT; ++i)
          q[i] = ok[i] ? parts[t * slab + lo + tid + i * kThreads] : 0.f;
#pragma unroll
        for (int i = 0; i < EPT; ++i)
          if (ok[i]) gs[i] += q[i];
      }
    }
    if (tid <= kOut)
      fold_s[tid] = fold_parts(slab_at(0) + (size_t)CL * E + tid, n_parts,
                               slab);
    __syncthreads();
    if (tid == 0) {
      plateau_step(fold_s[kOut], a.rtol, a.patience, a.factor, best, pcount,
                   scale);
      step_s = adam_step(bc_s[e % kThreads], scale, a.lr, a.weight_decay,
                         a.clamp);
    }
    __syncthreads();
    const AdamStep st = step_s;
    // Adam(W) and the clamp (not b1's row) on those entries
    float* xch = slab_at(n_parts) + (size_t)rank * E;
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const int x = lo + tid + i * kThreads;
      if (x < hi && x % UP < nu) {
        const float w = adam_update(W1t[x], gs[i], &mom_s[0][i][tid],
                                    &mom_s[1][i][tid], st,
                                    x / UP != DIN);
        W1t[x] = w;
        if (P > 1) xch[x] = w;
      }
    }
    if (tid < kOut)
      b2s[tid] = adam_update(b2s[tid], fold_s[tid], b2m + tid, b2v + tid, st,
                             false);
    if (p == 0 && rank == 0 && tid == 0) a.losses[e] = fold_s[kOut];
    if (P > 1) {
      // the other clusters' slices of this block's units
      run_barrier(bar, P * CL);
      float w[EPT];
#pragma unroll
      for (int i = 0; i < EPT; ++i) {
        const int x = tid + i * kThreads;
        w[i] = x < E ? xch[x] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < EPT; ++i) {
        const int x = tid + i * kThreads;
        if (x < E && (x < lo || x >= hi) && x % UP < nu) W1t[x] = w[i];
      }
    }
    __syncthreads();
  }

  {
    const int lo = (int)((long)p * E / P), hi = (int)((long)(p + 1) * E / P);
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const int x = lo + tid + i * kThreads;
      if (x < hi && x % UP < nu) {
        int m;
        const size_t at = moment_at<DIN, UP>(x, u0, h, m);
        float* const mu = m == 0 ? a.m_out[0] : m == 2 ? a.m_out[2]
                                                      : a.m_out[4];
        float* const nv = m == 0 ? a.m_out[1] : m == 2 ? a.m_out[3]
                                                      : a.m_out[5];
        mu[at] = mom_s[0][i][tid];
        nv[at] = mom_s[1][i][tid];
      }
    }
  }
  if (p == 0) {
    for (int i = tid; i < nu * DIN; i += kThreads) {
      const int uu = i / DIN, k = i - uu * DIN;
      a.w_out[0][(size_t)u0 * DIN + i] = W1t[k * UP + uu];
    }
    for (int i = tid; i < nu; i += kThreads)
      a.w_out[1][u0 + i] = W1t[DIN * UP + i];
    for (int i = tid; i < kOut * nu; i += kThreads) {
      const int o = i / nu, uu = i % nu;
      a.w_out[2][(size_t)o * h + u0 + uu] = W2s[o * UP + uu];
    }
    if (rank == 0) {
      if (tid < kOut) {
        a.w_out[3][tid] = b2s[tid];
        a.m_out[6][tid] = b2m[tid];
        a.m_out[7][tid] = b2v[tid];
      }
      if (tid == 0) {
        a.s_out[0] = t0 + (float)a.n_epochs;
        a.s_out[1] = best;
        a.s_out[2] = (float)pcount;
        a.s_out[3] = (float)scale;
      }
    }
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

using Kernel = void (*)(const TrainArgs, int, int);

template <int DIN>
static Kernel kernel_for(int slots) {
  switch (slots) {
    case kMinSlots: return train_kernel<DIN, 1>;
    case 2 * kMinSlots: return train_kernel<DIN, 2>;
    case 4 * kMinSlots: return train_kernel<DIN, 4>;
    default: return nullptr;
  }
}

// The kernel of a plan, or null if the plan is not this file's for (din,
// hidden): threads, part, slots and shared memory follow from din and the
// units per block; the cluster size is the plan's (the card may refuse it).
static Kernel checked_kernel(const TrainPlan& p, int din, int hidden) {
  if (p.threads != kThreads || p.tile != kTile || p.cluster < 1 ||
      p.clusters < 1 ||
      p.units < 1 || (long)p.units * p.cluster < hidden ||
      (long)(p.units - 1) * p.cluster >= hidden)
    return nullptr;
  int up = kMinSlots;
  while (up < p.units) up *= 2;
  if (p.slots != up || p.smem != 4 * smem_floats(din, up)) return nullptr;
  return din == 28 ? kernel_for<28>(up) : din == 53 ? kernel_for<53>(up)
                                                     : nullptr;
}

// The launch config of G runs: G x plan.clusters clusters of plan.cluster
// blocks, cooperative (every cluster resident at once) when a run spans
// more than one cluster.
struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  Launch(const TrainPlan& p, int G, cudaStream_t stream) {
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3(G * p.clusters * p.cluster);
    cfg.blockDim = dim3(p.threads);
    cfg.dynamicSmemBytes = p.smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeCooperative;
    attr[1].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = p.clusters > 1 ? 2 : 1;
  }
};

static int launch(const TrainArgs* a, int G, const TrainPlan* p,
                  void* stream) {
  if (G < 1 || a->C < 1 || a->hidden < 1 || a->n_epochs < 1 ||
      (G > 1 && !a->ds_grid) || !a->part ||
      p->clusters > (a->C + kTile - 1) / kTile ||
      (p->clusters > 1 && !a->bar))
    return (int)cudaErrorInvalidValue;
  const Kernel kern = checked_kernel(*p, a->din, a->hidden);
  if (!kern) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p->smem);
  if (err == cudaSuccess) {
    Launch l(*p, G, (cudaStream_t)stream);
    err = cudaLaunchKernelEx(&l.cfg, kern, *a, p->units, p->clusters);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();   // the error is returned, not left behind
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// C entry points (bound with ctypes in ops/_build.py). Pointers are device
// pointers of contiguous float32 tensors (part: run_floats(plan.cluster,
// din, plan.slots, parts) floats a run; bar: two zeroed unsigned ints a
// run). Each returns the launch's CUDA error (0 on success); a refused
// launch leaves no error behind.
//   K4: one run on plan.clusters clusters.
extern "C" int knode_train(const TrainArgs* a, const TrainPlan* plan,
                           void* stream) {
  return launch(a, 1, plan, stream);
}

//   K5: G runs, plan.clusters each; every pointer holds G runs stacked on a
//   leading axis (the runs share C, din, hidden and the hyperparameters)
//   and ds_grid their G step sizes.
extern "C" int knode_train_grid(const TrainArgs* a, int G,
                                const TrainPlan* plan, void* stream) {
  return launch(a, G, plan, stream);
}

//   How many of a plan's clusters the card holds at once
//   (cudaOccupancyMaxActiveClusters), into *clusters.
extern "C" int knode_train_clusters(int din, int hidden,
                                    const TrainPlan* plan, int* clusters) {
  const Kernel kern = checked_kernel(*plan, din, hidden);
  if (!kern) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, plan->smem);
  if (err == cudaSuccess) {
    TrainPlan one = *plan;
    one.clusters = 1;
    Launch l(one, 1, nullptr);
    err = cudaOccupancyMaxActiveClusters(clusters, kern, &l.cfg);
  }
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

//   The name of a CUDA error code, for the wrappers' messages.
extern "C" const char* knode_error_name(int code) {
  return cudaGetErrorName((cudaError_t)code);
}
