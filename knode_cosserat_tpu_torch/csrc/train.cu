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
// seed) cells). Cluster g trains cell g on its own slabs, net, moments,
// scalars and ds (grid_cell below); the cells of one launch share C, din,
// hidden, the hyperparameters and the loss denominators (one trajectory
// count: parallel/grid.py splits a grid into such sub-grids). The launch
// plan depends on (din, hidden) alone, so cluster g runs exactly K4's
// arithmetic on its cell and K5's cell g equals a K4 launch on cell g bit
// for bit. Plain version: train_run_reference per cell
// (ops/train.py::train_grid_reference).
//
// Design (the plan is ops/train.py::launch_plan, checked here). One run is
// one cluster of CL = 8 blocks of 512 threads. Block rank r owns the
// hidden units [r U, r U + U), U = ceil(h / CL): their W1 rows (transposed,
// with b1 as an extra row) and W2 columns stay in its shared memory for
// the launch, in UP unit slots (U rounded up to a power of two, >= 8;
// unowned slots hold zeros). The cells stream through shared memory in
// tiles of 256 (the whole of bench_data.npz's 232 cells: X is then staged
// once per launch). For the accumulations, thread t is slot u = t % UP of
// cell slice s = t / UP, one of S = 512 / UP slices; for the products over
// a tile it takes 4 slots x UP / 8 cells; so every width keeps all 512
// threads busy. Per tile:
//   F1  A = b1 + W1 x, H = elu(A) -> Hs (UP x 256), 4 slots x UP / 8
//       cells a thread (per input, a float4 of W1 and UP / 8 cells of X)
//   F2  this block's partial NN over its units, 4 cells x 5 outputs per
//       thread -> its partial buffer P[buf] (25 x 256)
//   --  cluster.sync(): every block's partial is complete
//   N   every block reads the CL partials of each (output, cell) through
//       distributed shared memory and sums them in rank order 0..CL-1,
//       plus b2: every block holds the same bits of NN
//   L   every block takes the loss and cotangent G of every cell of the
//       tile (one thread per cell), the same in every block, so the epoch's
//       loss, the plateau decisions and b2's update need no further message
//   B1  thread (u, s) accumulates dW2[o][u] for the outputs o = s + S i
//       over all the tile's cells (slot 0 also db2[o]), in registers
//   B2  dA = (W2^T G) elu'(H) in place of H, tiled as F1
//   B3  thread (u, s) accumulates dW1[u][k] for the inputs k = s + S i
//       over all the tile's cells (k = din is db1: X's extra row of ones)
// The partial buffers alternate between tiles (the other one holds this
// tile's NN, then G): a block rewrites a buffer only after the next
// cluster.sync, when every block has read it, so one cluster barrier a
// tile suffices. At the epoch's end thread (u, s) applies Adam(W) and the
// clamp to exactly the entries it accumulated (W1[u][k], b1, W2[o][u]),
// its moments loaded first in one round trip, and every block updates b2
// alike (its moments in shared memory); rank 0 writes b2, the losses and
// the scalars. Adam's bias corrections (double-precision powers) are
// computed by all threads at once, 512 epochs ahead. No sum crosses
// threads in a varying order, so a run repeats bit for bit. Everything is
// float32 on the CUDA cores (no TF32); atan2/asin are the native ones. The
// plateau's comparison runs in double, as the plain version's (on Python
// floats).
//
// What bounds it: per epoch 2 C h (2 din + 75) FMA-flops, 31.1 MFLOP at
// C=232, h=512, din=28: 0.46 us at the card's 67 TFLOP/s float32 peak, and
// ~0.74 MB of cells, weights and moments read and written once (~0.2 us at
// 3.35 TB/s), so the bound is compute. A run takes CL = 8 of the 132 SMs,
// so one run's ceiling is 8/132 of that peak; K5 runs as many clusters as
// the card holds at once (cudaOccupancyMaxActiveClusters, printed by
// chip_smoke.py). Within a block, shared memory delivers 128 B a clock to
// registers, broadcast or not: a phase whose thread loads one float per
// FMA runs at a quarter of the FMA rate, hence F1's and B2's register
// tiles; B1 and B3 (one unit per thread) and N, which moves 25 x 256 x CL
// floats through distributed shared memory per tile, are the largest
// phases left (PERF.md).
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
};

// The launch shape, ops/train.py::launch_plan.
struct TrainPlan {
  int threads;   // per block
  int cluster;   // blocks per cluster: one cluster per run
  int units;     // hidden units owned by each block
  int slots;     // unit slots per block (units rounded up, >= 8)
  int tile;      // cells per tile
  int smem;      // dynamic shared memory per block, bytes
};

constexpr int kThreads = 512;
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kTile = 256;          // cells per tile
constexpr int kQuads = kTile / 4;   // cell quads per tile
constexpr int kTP = kTile + 4;      // row stride of the cell-wide buffers

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
    const TrainArgs grid_args, int units) {
  constexpr int S = kQuads / NQ;       // cell slices
  constexpr int UP = kThreads / S;     // unit slots
  constexpr int KR = DIN + 1;          // W1's rows and b1
  constexpr int NK = (KR + S - 1) / S;     // W1 / b1 rows per thread
  constexpr int NO = (kOut + S - 1) / S;   // W2 rows per thread
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const TrainArgs a = grid_cell(grid_args, blockIdx.x / CL);

  extern __shared__ float4 smem4[];
  __shared__ AdamStep step_s;                    // this epoch's Adam step
  __shared__ float2 bc_s[kThreads];              // bias corrections of the
                                                 // next kThreads epochs
  float* Xs = reinterpret_cast<float*>(smem4);   // KR x kTP
  float* Hs = Xs + KR * kTP;                     // UP x kTP
  float* Pb = Hs + UP * kTP;                     // 2 x 25 x kTP
  float* W1t = Pb + 2 * kOut * kTP;              // KR x UP
  float* W2s = W1t + KR * UP;                    // 25 x UP
  float* b2s = W2s + kOut * UP;                  // 25 (32)
  float* b2m = b2s + 32;                         // b2's moments
  float* b2v = b2m + 32;
  float* wsum = b2v + 32;                        // the tile's warp losses

  const int tid = threadIdx.x, h = a.hidden, C = a.C;
  const int u = tid % UP, s = tid / UP;      // B1 / B3 / the update
  const int tg = tid % (UP / 4), tc = tid / (UP / 4);   // F1 / B2 tiles
  const int u0 = rank * units;
  const int nu = max(0, min(units, h - u0));     // units this block owns
  const bool own = u < nu;
  const int j = u0 + u;                          // its hidden unit

  // this block's units: moments in -> out (then updated in place there),
  // weights into shared memory (zeros in the unowned slots)
  for (int p = 0; p < 3; ++p) {
    const int w = p == 0 ? DIN : p == 1 ? 1 : kOut;
    for (int i = tid; i < nu * w; i += kThreads) {
      const size_t at = p == 2 ? (size_t)(i / nu) * h + u0 + i % nu
                               : (size_t)u0 * w + i;
      a.m_out[2 * p][at] = a.m_in[2 * p][at];
      a.m_out[2 * p + 1][at] = a.m_in[2 * p + 1][at];
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
  const int n_tiles = (C + kTile - 1) / kTile;
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
    float gW1[NK], gW2[NO], gB2[NO];
#pragma unroll
    for (int i = 0; i < NK; ++i) gW1[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NO; ++i) gW2[i] = gB2[i] = 0.f;
    float eloss = 0.f;

    for (int t = 0; t < n_tiles; ++t) {
      const int c0 = t * kTile, n = min(kTile, C - c0), nq = (n + 3) / 4;
      if (n_tiles > 1 || e == 0) {
        // X tile, transposed to DIN x kTile; the ragged edge is zero
        __syncthreads();
        for (int i = tid; i < kTile * DIN; i += kThreads) {
          const int c = i / DIN, k = i - c * DIN;
          Xs[k * kTP + c] = c < n ? X[(size_t)c0 * DIN + i] : 0.f;
        }
      }
      __syncthreads();

      // F1: A = b1 + W1 x, H = elu(A) for this thread's tile of 4 unit
      // slots x NQ cells (all the tile's cells: those past n are zeros,
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
      float* P = Pb + buf * kOut * kTP;
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
            reinterpret_cast<float4*>(P + (og * 5 + i) * kTP)[q] =
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
          float p[kMaxCluster];
#pragma unroll
          for (int r = 0; r < kMaxCluster; ++r)
            p[r] = r < CL ? peer[r][at] : 0.f;
          float v = p[0];
#pragma unroll
          for (int r = 1; r < kMaxCluster; ++r)
            if (r < CL) v += p[r];
          G[o * kTP + c] = v + b2s[o];
        }
      }
      __syncthreads();

      // L: loss and cotangent of every cell of the tile, G in place of NN
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
      {
        float tl = wsum[0];
#pragma unroll
        for (int w = 1; w < kTile / 32; ++w) tl += wsum[w];
        eloss += tl;
      }

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
      buf ^= 1;
    }

    // reduce_on_plateau on this epoch's loss and Adam's constants, once,
    // then each thread updates the entries it accumulated
    if (tid == 0) {
      plateau_step(eloss, a.rtol, a.patience, a.factor, best, pcount, scale);
      step_s = adam_step(bc_s[e % kThreads], scale, a.lr, a.weight_decay,
                         a.clamp);
    }
    __syncthreads();
    const AdamStep st = step_s;
    if (own) {
      // every moment this thread updates, loaded first (one round trip)
      float* mp[NK + NO][2];
      float mv[NK + NO][2];
      float *mw0 = a.m_out[0], *mw1 = a.m_out[1], *mb0 = a.m_out[2],
            *mb1 = a.m_out[3];
#pragma unroll
      for (int i = 0; i < NK; ++i) {
        const int k = min(s + S * i, DIN);
        const size_t at = k < DIN ? (size_t)j * DIN + k : j;
        mp[i][0] = (k < DIN ? mw0 : mb0) + at;
        mp[i][1] = (k < DIN ? mw1 : mb1) + at;
      }
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        const size_t at = (size_t)min(s + S * i, kOut - 1) * h + j;
        mp[NK + i][0] = a.m_out[4] + at;
        mp[NK + i][1] = a.m_out[5] + at;
      }
#pragma unroll
      for (int i = 0; i < NK + NO; ++i) {
        mv[i][0] = *mp[i][0];
        mv[i][1] = *mp[i][1];
      }
#pragma unroll
      for (int i = 0; i < NK; ++i) {
        const int k = s + S * i;
        if (k < KR) {
          W1t[k * UP + u] = adam_update(W1t[k * UP + u], gW1[i], &mv[i][0],
                                        &mv[i][1], st, k < DIN);
          *mp[i][0] = mv[i][0];
          *mp[i][1] = mv[i][1];
        }
      }
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        const int o = s + S * i;
        if (o < kOut) {
          W2s[o * UP + u] = adam_update(W2s[o * UP + u], gW2[i],
                                        &mv[NK + i][0], &mv[NK + i][1], st,
                                        true);
          *mp[NK + i][0] = mv[NK + i][0];
          *mp[NK + i][1] = mv[NK + i][1];
        }
      }
    }
    if (u == 0) {
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        const int o = s + S * i;
        if (o < kOut)
          b2s[o] = adam_update(b2s[o], gB2[i], b2m + o, b2v + o, st, false);
      }
    }
    if (rank == 0 && tid == 0) a.losses[e] = eloss;
    __syncthreads();
  }

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
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

using Kernel = void (*)(const TrainArgs, int);

template <int DIN>
static Kernel kernel_for(int slots) {
  switch (slots) {
    case 8: return train_kernel<DIN, 1>;
    case 16: return train_kernel<DIN, 2>;
    case 32: return train_kernel<DIN, 4>;
    case 64: return train_kernel<DIN, 8>;
    default: return nullptr;
  }
}

// The kernel of a plan, or null if the plan is not this file's for (din,
// hidden): threads, tile, slots and shared memory follow from din and the
// units per block; the cluster size is the plan's (the card may refuse it).
static Kernel checked_kernel(const TrainPlan& p, int din, int hidden) {
  if (p.threads != kThreads || p.tile != kTile || p.cluster < 1 ||
      p.units < 1 || (long)p.units * p.cluster < hidden ||
      (long)(p.units - 1) * p.cluster >= hidden)
    return nullptr;
  int up = 8;
  while (up < p.units) up *= 2;
  if (p.slots != up || p.smem != 4 * smem_floats(din, up)) return nullptr;
  return din == 28 ? kernel_for<28>(up) : din == 53 ? kernel_for<53>(up)
                                                     : nullptr;
}

// The launch config of G runs: G clusters of plan.cluster blocks.
struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  Launch(const TrainPlan& p, int G, cudaStream_t stream) {
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3(G * p.cluster);
    cfg.blockDim = dim3(p.threads);
    cfg.dynamicSmemBytes = p.smem;
    cfg.stream = stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = p.cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

static int launch(const TrainArgs* a, int G, const TrainPlan* p,
                  void* stream) {
  if (G < 1 || a->C < 1 || a->hidden < 1 || a->n_epochs < 1 ||
      (G > 1 && !a->ds_grid))
    return (int)cudaErrorInvalidValue;
  const Kernel kern = checked_kernel(*p, a->din, a->hidden);
  if (!kern) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p->smem);
  if (err == cudaSuccess) {
    Launch l(*p, G, (cudaStream_t)stream);
    err = cudaLaunchKernelEx(&l.cfg, kern, *a, p->units);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();   // the error is returned, not left behind
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// C entry points (bound with ctypes in ops/_build.py). Pointers are device
// pointers of contiguous float32 tensors. Each returns the launch's CUDA
// error (0 on success); a refused launch leaves no error behind.
//   K4: one run, one cluster.
extern "C" int knode_train(const TrainArgs* a, const TrainPlan* plan,
                           void* stream) {
  return launch(a, 1, plan, stream);
}

//   K5: G runs, one cluster each; every pointer holds G runs stacked on a
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
    Launch l(*plan, 1, nullptr);
    err = cudaOccupancyMaxActiveClusters(clusters, kern, &l.cfg);
  }
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

//   The name of a CUDA error code, for the wrappers' messages.
extern "C" const char* knode_error_name(int code) {
  return cudaGetErrorName((cudaError_t)code);
}
