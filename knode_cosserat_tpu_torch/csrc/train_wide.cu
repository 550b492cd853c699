// K6: the whole KNODE training run for any hidden width, the weights and
// both Adam moments in device memory, updated in place.
//
// Replaces knode_cosserat_tpu/ops/pallas_train_wide.py::_make_run_one (via
// make_wide_training_run). Plain version:
// knode_cosserat_tpu_torch/ops/train.py::train_run_reference, the same
// function as K4's at any hidden width. The per-cell constants are K4's
// (ops/train.py::precompute, cell-major); so are the loss, its cotangent,
// reduce-on-plateau, Adam(W) and the clamp (train_common.cuh), and the
// opaque state (8 moments + 4 scalars), so chunked runs compose and a run
// can switch between K4 and K6 at a chunk boundary.
//
// The TPU kernel streams (DP|32, HT) weight tiles through VMEM in two
// passes per epoch. Here one epoch is three launches on one stream:
//   A  wide_forward, a block per tile of CT cells: H = elu(W1 X + b1) for
//      its cells, 256 hidden units at a time, NN = W2 H + b2 summed over
//      all hidden units in the block (lanes split the units, a butterfly of
//      shuffles sums them), then each cell's loss and its cotangent
//      g = dL/dNN, written to scratch (C x 25, and C losses).
//   S  wide_step, one block: the epoch's loss and db2 = sum_c g, each
//      reduced over the cells in a fixed order; the plateau step, the
//      epoch's loss, b2's Adam update, and the run's state (best, plateau
//      count and scale in double, as K4 keeps them in registers).
//   B  wide_backward, a block per 32 hidden units (lane l owns unit
//      32 b + l): recompute a = W1 x + b1 and elu(a) per cell, then
//      dW2 = g H^T, da = (W2^T g) elu'(a), dW1 = da X^T, db1 = sum da,
//      accumulated in registers; the 8 warps split the cells and their sums
//      are added in warp order through shared memory; then the owner
//      applies Adam(W) and the clamp to its row of W1, its b1 and its
//      column of W2, in place. The ragged last tile of units is masked.
// Why three launches and not one cooperative persistent launch: the phases
// need a barrier across all blocks, and three launches give it with no
// co-residency condition on the grid (any width, any occupancy) and no way
// to deadlock the card; the price is ~3 launch latencies per epoch, a
// small share of an epoch at h = 8192, and the epochs are enqueued from C
// in one call (knode_train_wide), so the host does no per-epoch work.
// Every reduction runs in a fixed order, so a run repeats bit for bit and
// chunked runs compose exactly. b1 rides as its own vector; the clamp
// spares b1 and b2, as in K4 (the TPU kernel folded b1 into W1 as a row
// and masked the clamp there). Everything is float32 on the CUDA cores,
// no TF32; the TPU kernel's products run at DEFAULT precision (one bf16
// pass on the MXU), which this port does not copy.
//
// What bounds it: per epoch 2 C h (2 din + 75) flops (forward, the
// recompute, and the two weight gradients), 5.65 GFLOP at the train-real
// shape (C = 1,904, h = 8,192, din = 53): 84 us at 67 TFLOP/s float32; the
// weights and moments, ~3 x 1.7 MB, are read and written once an epoch
// (~5 us at 3.35 TB/s), so the bound is compute. Each block's inner loop
// reads its x and g from shared memory as broadcasts and keeps its
// unit's weights in registers.
#include "train_common.cuh"

struct WideArgs {
  const float* cells[6];  // x, y_base, z_phys, tgt_y, tgt_z, e_tgt
  float* w[4];            // W1 (h, din), b1 (h), W2 (25, h), b2 (25): in place
  float* m[8];            // mu, nu of W1, b1, W2, b2: in place
  const float* s_in;      // count, best, plateau count, scale
  float* s_out;
  float* losses;          // (n_epochs,)
  float* g;               // scratch (C, 25): dL/dNN per cell
  float* cell_loss;       // scratch (C,)
  double* run;            // (3): best, plateau count, scale of the run
  int C, din, hidden, n_epochs, patience, clamp;
  double lr, weight_decay, factor, rtol, ds;
  double inv[4];          // mean denominators: pos, states, eul, z
};

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCT = 16;       // cells per forward block
constexpr int kCC = 64;       // cells per shared-memory chunk, backward
constexpr int kUnits = 32;    // hidden units per backward block

// Phase A: forward, loss and cotangent for a tile of kCT cells.
template <int DIN>
__global__ void __launch_bounds__(kThreads, 1) wide_forward(const WideArgs a) {
  constexpr int CPW = kCT / kWarps;  // cells per warp in NN = W2 H
  __shared__ __align__(16) float Xs[DIN * kCT];  // DIN x kCT
  __shared__ float Hs[kCT * kThreads];           // kCT x 256 units
  __shared__ float NNs[kOut * kCT];
  const int h = a.hidden, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * kCT, n = min(kCT, a.C - c0);
  const float* X = a.cells[0];
  for (int i = tid; i < kCT * DIN; i += kThreads) {
    const int c = i / DIN, k = i - c * DIN;
    Xs[k * kCT + c] = c < n ? X[(size_t)c0 * DIN + i] : 0.f;
  }
  float acc2[CPW][kOut];
#pragma unroll
  for (int r = 0; r < CPW; ++r)
#pragma unroll
    for (int o = 0; o < kOut; ++o) acc2[r][o] = 0.f;
  __syncthreads();

  for (int u0 = 0; u0 < h; u0 += kThreads) {
    const int u = u0 + tid;
    if (u < h) {
      const float* w1 = a.w[0] + (size_t)u * DIN;
      const float b1 = a.w[1][u];
      float acc[kCT];
#pragma unroll
      for (int c = 0; c < kCT; ++c) acc[c] = b1;
#pragma unroll 4
      for (int k = 0; k < DIN; ++k) {
        const float w = w1[k];
        const float4* xr = reinterpret_cast<const float4*>(Xs + k * kCT);
#pragma unroll
        for (int q = 0; q < kCT / 4; ++q) {
          const float4 v = xr[q];
          acc[4 * q] += w * v.x;
          acc[4 * q + 1] += w * v.y;
          acc[4 * q + 2] += w * v.z;
          acc[4 * q + 3] += w * v.w;
        }
      }
#pragma unroll
      for (int c = 0; c < kCT; ++c)
        Hs[c * kThreads + tid] = acc[c] > 0.f ? acc[c] : expm1f(acc[c]);
    } else {
#pragma unroll
      for (int c = 0; c < kCT; ++c) Hs[c * kThreads + tid] = 0.f;
    }
    __syncthreads();
    // NN += W2[:, u0:u0+256] H: warp w takes cells w + 8 r, lanes the units
    for (int jj = lane; jj < kThreads && u0 + jj < h; jj += 32) {
      float hv[CPW];
#pragma unroll
      for (int r = 0; r < CPW; ++r)
        hv[r] = Hs[(warp + kWarps * r) * kThreads + jj];
      const float* w2 = a.w[2] + u0 + jj;
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
        const float w = w2[(size_t)o * h];
#pragma unroll
        for (int r = 0; r < CPW; ++r) acc2[r][o] += w * hv[r];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < CPW; ++r)
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      const float v = warp_sum(acc2[r][o]);
      if (lane == 0) NNs[o * kCT + warp + kWarps * r] = v + a.w[3][o];
    }
  __syncthreads();

  if (warp == 0 && lane < n) {
    const float inv[4] = {(float)a.inv[0], (float)a.inv[1], (float)a.inv[2],
                          (float)a.inv[3]};
    float nn[kOut], g[kOut];
#pragma unroll
    for (int o = 0; o < kOut; ++o) nn[o] = NNs[o * kCT + lane];
    const size_t gc = (size_t)(c0 + lane);
    const float lc = cell_loss(nn, a.cells[1] + gc * 19, a.cells[2] + gc * 6,
                               a.cells[3] + gc * 19, a.cells[4] + gc * 6,
                               a.cells[5] + gc * 3, (float)a.ds, inv, g);
#pragma unroll
    for (int o = 0; o < kOut; ++o) a.g[gc * kOut + o] = g[o];
    a.cell_loss[gc] = lc;
  }
}

// Phase S: the epoch's loss, the plateau, b2's update, the run's state.
__global__ void __launch_bounds__(kThreads, 1) wide_step(const WideArgs a,
                                                         int e) {
  __shared__ float red[kOut + 1][kThreads];
  const int tid = threadIdx.x;
  float s[kOut + 1];
#pragma unroll
  for (int o = 0; o <= kOut; ++o) s[o] = 0.f;
  for (int c = tid; c < a.C; c += kThreads) {
    s[0] += a.cell_loss[c];
#pragma unroll
    for (int o = 0; o < kOut; ++o) s[1 + o] += a.g[(size_t)c * kOut + o];
  }
#pragma unroll
  for (int o = 0; o <= kOut; ++o) red[o][tid] = s[o];
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (tid < w)
#pragma unroll
      for (int o = 0; o <= kOut; ++o) red[o][tid] += red[o][tid + w];
    __syncthreads();
  }
  const float L = red[0][0];
  float best = (float)a.run[0];
  int pcount = (int)a.run[1];
  double scale = a.run[2];
  plateau_step(L, a.rtol, a.patience, a.factor, best, pcount, scale);
  const float t0 = a.s_in[0];
  const AdamStep st = adam_step((double)t0 + e + 1, scale, a.lr,
                                a.weight_decay, a.clamp);
  if (tid < kOut)
    a.w[3][tid] = adam_update(a.w[3][tid], red[1 + tid][0], a.m[6] + tid,
                              a.m[7] + tid, st, false);
  __syncthreads();   // every thread has read the old run state
  if (tid == 0) {
    a.run[0] = best;
    a.run[1] = pcount;
    a.run[2] = scale;
    a.losses[e] = L;
    if (e == a.n_epochs - 1) {
      a.s_out[0] = t0 + (float)a.n_epochs;
      a.s_out[1] = best;
      a.s_out[2] = (float)pcount;
      a.s_out[3] = (float)scale;
    }
  }
}

// Phase B: backward and update of kUnits hidden units.
template <int DIN>
__global__ void __launch_bounds__(kThreads, 1) wide_backward(const WideArgs a,
                                                             int e) {
  constexpr int NP = DIN + 1 + kOut;   // dW1 row, db1, dW2 column
  extern __shared__ float4 smem4[];
  float* Xc = reinterpret_cast<float*>(smem4);   // kCC x DIN, cell-major
  float* Gc = Xc + kCC * DIN;                    // kCC x 25
  float* red = Gc + kCC * kOut;                  // kWarps x NP x 32
  const int h = a.hidden, C = a.C, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int u = blockIdx.x * kUnits + lane;
  const bool own = u < h;
  float w1[DIN], w2[kOut], dW1[DIN], dW2[kOut];
  float b1 = 0.f, db1 = 0.f;
#pragma unroll
  for (int k = 0; k < DIN; ++k) {
    w1[k] = own ? a.w[0][(size_t)u * DIN + k] : 0.f;
    dW1[k] = 0.f;
  }
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    w2[o] = own ? a.w[2][(size_t)o * h + u] : 0.f;
    dW2[o] = 0.f;
  }
  if (own) b1 = a.w[1][u];

  for (int c0 = 0; c0 < C; c0 += kCC) {
    const int n = min(kCC, C - c0);
    for (int i = tid; i < n * DIN; i += kThreads)
      Xc[i] = a.cells[0][(size_t)c0 * DIN + i];
    for (int i = tid; i < n * kOut; i += kThreads)
      Gc[i] = a.g[(size_t)c0 * kOut + i];
    __syncthreads();
    for (int c = warp; c < n; c += kWarps) {
      const float* x = Xc + c * DIN;
      const float* g = Gc + c * kOut;
      float av = b1, dh = 0.f;
#pragma unroll
      for (int k = 0; k < DIN; ++k) av += w1[k] * x[k];
      const float hv = av > 0.f ? av : expm1f(av);
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
        dh += w2[o] * g[o];
        dW2[o] += g[o] * hv;
      }
      const float da = dh * (hv > 0.f ? 1.f : hv + 1.f);
      db1 += da;
#pragma unroll
      for (int k = 0; k < DIN; ++k) dW1[k] += da * x[k];
    }
    __syncthreads();
  }

  // the warps' sums, added in warp order
  float* mine = red + (size_t)warp * NP * 32;
#pragma unroll
  for (int k = 0; k < DIN; ++k) mine[k * 32 + lane] = dW1[k];
  mine[DIN * 32 + lane] = db1;
#pragma unroll
  for (int o = 0; o < kOut; ++o) mine[(DIN + 1 + o) * 32 + lane] = dW2[o];
  __syncthreads();
  for (int i = tid; i < NP * 32; i += kThreads) {
    float s = red[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[(size_t)w * NP * 32 + i];
    red[i] = s;
  }
  __syncthreads();

  if (warp == 0 && own) {
    const float t0 = a.s_in[0];
    const AdamStep st = adam_step((double)t0 + e + 1, a.run[2], a.lr,
                                  a.weight_decay, a.clamp);
#pragma unroll
    for (int k = 0; k < DIN; ++k) {
      const size_t i = (size_t)u * DIN + k;
      a.w[0][i] = adam_update(w1[k], red[k * 32 + lane], a.m[0] + i,
                              a.m[1] + i, st, true);
    }
    a.w[1][u] = adam_update(b1, red[DIN * 32 + lane], a.m[2] + u, a.m[3] + u,
                            st, false);
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      const size_t i = (size_t)o * h + u;
      a.w[2][i] = adam_update(w2[o], red[(DIN + 1 + o) * 32 + lane],
                              a.m[4] + i, a.m[5] + i, st, true);
    }
  }
}

template <int DIN>
static int run_epochs(const WideArgs& a, cudaStream_t stream) {
  const size_t bytes = sizeof(float) *
      ((size_t)kCC * DIN + kCC * kOut + (size_t)kWarps * (DIN + 1 + kOut) * 32);
  cudaError_t err = cudaFuncSetAttribute(
      wide_backward<DIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_fwd = (a.C + kCT - 1) / kCT;
  const int n_bwd = (a.hidden + kUnits - 1) / kUnits;
  for (int e = 0; e < a.n_epochs; ++e) {
    wide_forward<DIN><<<n_fwd, kThreads, 0, stream>>>(a);
    wide_step<<<1, kThreads, 0, stream>>>(a, e);
    wide_backward<DIN><<<n_bwd, kThreads, bytes, stream>>>(a, e);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// C entry point (bound with ctypes in ops/_build.py): n_epochs epochs, three
// launches each, on ``stream``. Pointers are device pointers of contiguous
// float32 tensors (``run`` float64), which the wrapper allocates; the
// weights and moments are updated in place. Returns cudaGetLastError().
extern "C" int knode_train_wide(const WideArgs* a, void* stream) {
  if (a->C < 1 || a->hidden < 1 || a->n_epochs < 1)
    return (int)cudaErrorInvalidValue;
  switch (a->din) {
    case 28:
      return run_epochs<28>(*a, (cudaStream_t)stream);
    case 53:
      return run_epochs<53>(*a, (cudaStream_t)stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
