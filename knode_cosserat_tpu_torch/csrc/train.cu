// K4: the whole KNODE training run, n_epochs per launch, in one thread
// block.
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
// seed) cells). gridDim.x = G, and block g trains cell g on its own slabs,
// net, moments, scalars and ds (grid_cell below); the cells of one launch
// share C, din, hidden, the hyperparameters and the loss denominators (one
// trajectory count: parallel/grid.py splits a grid into such sub-grids).
// Block g runs exactly K4's arithmetic on its cell, so K5's cell g equals a
// K4 launch on cell g bit for bit. Plain version: train_run_reference per
// cell (ops/train.py::train_grid_reference). The blocks are independent, so
// G <= 132 runs take one run's time on as many SMs.
//
// Design: one block of 512 threads trains one run (a grid of such blocks
// is K5, the grid trainer). Thread j owns hidden unit j (hidden <= 512):
// its dW1 row and dW2 column are register accumulators over the whole
// epoch, and it alone updates its row of W1, its b1 and its column of W2.
// W1 (transposed, din x h) and W2 (25 x h) stay in shared memory for the
// launch; the moments stay in device memory (L2), read and written once an
// epoch. The cells stream through shared memory in tiles of TILE (32 cells
// for 28 inputs, 16 for 53): the tile's X (din x TILE), its hidden
// activations H (TILE x h) and its 25 x TILE outputs, then their
// cotangents. elu'(a) is taken from the stored activation (h > 0 ? 1 :
// h + 1), so the pre-activations are not kept. NN = W2 H reduces over the
// hidden units: each warp takes TILE/16 cells, its lanes split the hidden
// units, and a butterfly of shuffles sums them. The loss of a tile is
// reduced by warp 0 in a fixed order, so a run repeats bit for bit and the
// plateau decisions with it. Everything is float32 on the CUDA cores (no
// TF32); atan2/asin are the native ones (the TPU kernel's Chebyshev atan,
// within ~1e-9, existed because Mosaic has none). The plateau's comparison
// runs in double, as the plain version's (on Python floats) does.
//
// What bounds it: per epoch 2 C h (2 din + 75) FMA-flops, 31.1 MFLOP at
// C=232, h=512, din=28: 0.46 us at the card's 67 TFLOP/s float32 peak, and
// ~0.74 MB of cells, weights and moments read and written once (~0.2 us at
// 3.35 TB/s), so the bound is compute. One block runs on one SM, 1/132 of
// that peak, and its inner loops issue about one shared-memory load per
// FMA, so the launch is tens of milliseconds per 200-epoch chunk, not the
// bound's 0.1 ms. The next design is a cluster of up to 8 blocks splitting
// the hidden units (64 each), reducing the 25 output rows over
// distributed shared memory in rank order.
#include "train_common.cuh"

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

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

template <int DIN, int TILE>
__global__ void __launch_bounds__(kThreads, 1) train_kernel(
    const TrainArgs grid_args) {
  const TrainArgs a = grid_cell(grid_args, blockIdx.x);
  static_assert(TILE % 16 == 0 && TILE <= 32, "TILE: 16 or 32 cells");
  constexpr int CPW = TILE / kWarps;  // cells per warp in NN = W2 H
  extern __shared__ float4 smem4[];
  const int h = a.hidden, C = a.C, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  float* Xs = reinterpret_cast<float*>(smem4);  // DIN x TILE
  float* NNs = Xs + DIN * TILE;                 // 25 x TILE: NN, then G
  float* Hs = NNs + kOut * TILE;                // TILE x h
  float* W2s = Hs + TILE * h;                   // 25 x h
  float* W1t = W2s + kOut * h;                  // DIN x h (W1 transposed)
  float* b2s = W1t + DIN * h;                   // 25
  float* red = b2s + 28;                        // epoch loss broadcast

  // moments: copy in -> out, then update them in place
  const int msize[4] = {h * DIN, h, kOut * h, kOut};
  for (int p = 0; p < 4; ++p)
    for (int i = tid; i < msize[p]; i += kThreads) {
      a.m_out[2 * p][i] = a.m_in[2 * p][i];
      a.m_out[2 * p + 1][i] = a.m_in[2 * p + 1][i];
    }
  for (int i = tid; i < h * DIN; i += kThreads)
    W1t[(i % DIN) * h + i / DIN] = a.w_in[0][i];
  for (int i = tid; i < kOut * h; i += kThreads) W2s[i] = a.w_in[2][i];
  if (tid < kOut) b2s[tid] = a.w_in[3][tid];
  const bool own = tid < h;  // this thread owns hidden unit j = tid
  const int j = tid;
  float b1j = own ? a.w_in[1][j] : 0.f;

  const float t0 = a.s_in[0];
  float best = a.s_in[1];
  int pcount = (int)a.s_in[2];
  double scale = a.s_in[3];
  const float ds = (float)a.ds;
  const float inv[4] = {(float)a.inv[0], (float)a.inv[1], (float)a.inv[2],
                        (float)a.inv[3]};
  const float* X = a.cells[0];
  __syncthreads();

  for (int e = 0; e < a.n_epochs; ++e) {
    float dW1[DIN], dW2[kOut];
#pragma unroll
    for (int k = 0; k < DIN; ++k) dW1[k] = 0.f;
#pragma unroll
    for (int o = 0; o < kOut; ++o) dW2[o] = 0.f;
    float dB1 = 0.f, dB2 = 0.f, eloss = 0.f;

    for (int c0 = 0; c0 < C; c0 += TILE) {
      const int n = min(TILE, C - c0);
      // X tile, transposed to DIN x TILE; the ragged edge is zero
      for (int i = tid; i < TILE * DIN; i += kThreads) {
        const int c = i / DIN, k = i - c * DIN;
        Xs[k * TILE + c] = c < n ? X[(size_t)c0 * DIN + i] : 0.f;
      }
      __syncthreads();

      // forward, hidden layer: thread j, all cells of the tile
      if (own) {
        float acc[TILE];
#pragma unroll
        for (int c = 0; c < TILE; ++c) acc[c] = b1j;
#pragma unroll 4
        for (int k = 0; k < DIN; ++k) {
          const float w = W1t[k * h + j];
          const float4* xr = reinterpret_cast<const float4*>(Xs + k * TILE);
#pragma unroll
          for (int q = 0; q < TILE / 4; ++q) {
            const float4 v = xr[q];
            acc[4 * q] += w * v.x;
            acc[4 * q + 1] += w * v.y;
            acc[4 * q + 2] += w * v.z;
            acc[4 * q + 3] += w * v.w;
          }
        }
#pragma unroll
        for (int c = 0; c < TILE; ++c)
          Hs[c * h + j] = acc[c] > 0.f ? acc[c] : expm1f(acc[c]);
      }
      __syncthreads();

      // forward, output layer: NN[o][c] = b2[o] + sum_j W2[o][j] H[c][j]
      {
        float acc[CPW][kOut];
#pragma unroll
        for (int r = 0; r < CPW; ++r)
#pragma unroll
          for (int o = 0; o < kOut; ++o) acc[r][o] = 0.f;
        for (int jj = lane; jj < h; jj += 32) {
          float hv[CPW];
#pragma unroll
          for (int r = 0; r < CPW; ++r) hv[r] = Hs[(warp + kWarps * r) * h + jj];
#pragma unroll
          for (int o = 0; o < kOut; ++o) {
            const float w2 = W2s[o * h + jj];
#pragma unroll
            for (int r = 0; r < CPW; ++r) acc[r][o] += w2 * hv[r];
          }
        }
#pragma unroll
        for (int r = 0; r < CPW; ++r)
#pragma unroll
          for (int o = 0; o < kOut; ++o) {
            const float v = warp_sum(acc[r][o]);
            if (lane == 0) NNs[o * TILE + warp + kWarps * r] = v + b2s[o];
          }
      }
      __syncthreads();

      // loss and its cotangent, one cell per lane of warp 0
      if (warp == 0) {
        float lc = 0.f;
        if (lane < TILE) {
          float g[kOut];
#pragma unroll
          for (int o = 0; o < kOut; ++o) g[o] = 0.f;
          if (lane < n) {
            float nn[kOut];
#pragma unroll
            for (int o = 0; o < kOut; ++o) nn[o] = NNs[o * TILE + lane];
            const size_t gc = (size_t)(c0 + lane);
            lc = cell_loss(nn, a.cells[1] + gc * 19, a.cells[2] + gc * 6,
                           a.cells[3] + gc * 19, a.cells[4] + gc * 6,
                           a.cells[5] + gc * 3, ds, inv, g);
          }
#pragma unroll
          for (int o = 0; o < kOut; ++o) NNs[o * TILE + lane] = g[o];
        }
        lc = warp_sum(lc);
        if (lane == 0) eloss += lc;
      }
      __syncthreads();

      // backward: thread j accumulates its dW2 column, db1 and dW1 row
      if (own) {
        for (int c = 0; c < TILE; ++c) {
          const float hv = Hs[c * h + j];
          float dh = 0.f;
#pragma unroll
          for (int o = 0; o < kOut; ++o) {
            const float g = NNs[o * TILE + c];
            dW2[o] += g * hv;
            dh += W2s[o * h + j] * g;
          }
          const float da = dh * (hv > 0.f ? 1.f : hv + 1.f);
          dB1 += da;
#pragma unroll
          for (int k = 0; k < DIN; ++k) dW1[k] += da * Xs[k * TILE + c];
        }
      }
      if (tid < kOut)
        for (int c = 0; c < TILE; ++c) dB2 += NNs[tid * TILE + c];
      __syncthreads();
    }

    // reduce_on_plateau on this epoch's loss (every thread alike)
    if (tid == 0) red[0] = eloss;
    __syncthreads();
    const float L = red[0];
    plateau_step(L, a.rtol, a.patience, a.factor, best, pcount, scale);
    const AdamStep st = adam_step((double)t0 + e + 1, scale, a.lr,
                                  a.weight_decay, a.clamp);
    if (own) {
#pragma unroll
      for (int k = 0; k < DIN; ++k) {
        const int i = j * DIN + k;
        W1t[k * h + j] = adam_update(W1t[k * h + j], dW1[k], a.m_out[0] + i,
                                     a.m_out[1] + i, st, true);
      }
      b1j = adam_update(b1j, dB1, a.m_out[2] + j, a.m_out[3] + j, st, false);
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
        const int i = o * h + j;
        W2s[i] = adam_update(W2s[i], dW2[o], a.m_out[4] + i, a.m_out[5] + i,
                             st, true);
      }
    }
    if (tid < kOut)
      b2s[tid] = adam_update(b2s[tid], dB2, a.m_out[6] + tid,
                             a.m_out[7] + tid, st, false);
    if (tid == 0) a.losses[e] = L;
    __syncthreads();
  }

  for (int i = tid; i < h * DIN; i += kThreads)
    a.w_out[0][i] = W1t[(i % DIN) * h + i / DIN];
  for (int i = tid; i < kOut * h; i += kThreads) a.w_out[2][i] = W2s[i];
  if (own) a.w_out[1][j] = b1j;
  if (tid < kOut) a.w_out[3][tid] = b2s[tid];
  if (tid == 0) {
    a.s_out[0] = t0 + (float)a.n_epochs;
    a.s_out[1] = best;
    a.s_out[2] = (float)pcount;
    a.s_out[3] = (float)scale;
  }
}

template <int DIN, int TILE>
static int launch(const TrainArgs& a, int G, cudaStream_t stream) {
  const size_t floats = (size_t)DIN * TILE + kOut * TILE + (size_t)TILE * a.hidden
                        + (size_t)kOut * a.hidden + (size_t)DIN * a.hidden + 28 + 4;
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      train_kernel<DIN, TILE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  train_kernel<DIN, TILE><<<G, kThreads, bytes, stream>>>(a);
  return 0;
}

static int launch_din(const TrainArgs* a, int G, int threads, void* stream) {
  if (threads != kThreads || G < 1 || a->C < 1 || a->hidden < 1 ||
      a->hidden > kThreads || a->n_epochs < 1 || (G > 1 && !a->ds_grid))
    return (int)cudaErrorInvalidValue;
  int bad;
  switch (a->din) {
    case 28:
      bad = launch<28, 32>(*a, G, (cudaStream_t)stream);
      break;
    case 53:
      bad = launch<53, 16>(*a, G, (cudaStream_t)stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (bad) return bad;
  return (int)cudaGetLastError();
}

// C entry points (bound with ctypes in ops/_build.py). Pointers are device
// pointers of contiguous float32 tensors. Each returns cudaGetLastError()
// after the launch.
//   K4: one run, one block.
extern "C" int knode_train(const TrainArgs* a, int threads, void* stream) {
  return launch_din(a, 1, threads, stream);
}

//   K5: G runs, one block each; every pointer holds G runs stacked on a
//   leading axis (the runs share C, din, hidden and the hyperparameters)
//   and ds_grid their G step sizes.
extern "C" int knode_train_grid(const TrainArgs* a, int G, int threads,
                                void* stream) {
  return launch_din(a, G, threads, stream);
}
