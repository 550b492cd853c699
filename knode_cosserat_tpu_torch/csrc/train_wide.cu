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
// An epoch is the products of a skinny MLP, A = W1 X^T (K = din),
// NN = W2 H (K = h), dH = W2^T G (K = 25), dW1 = dA X and dW2 = G H^T
// (K = C), written as register-tiled float32 products on the CUDA cores
// (no TF32), in four launches on one stream, enqueued from C:
//   F  wide_forward, a 2-D grid of (128 units x cell group) blocks. W1 (with
//      b1 as an extra input row) and W2 of the unit tile are staged in
//      shared memory once; the group's tiles of 64 cells stream through two
//      buffers by cp.async (the next tile loads while this one computes),
//      cell-major with a column of ones. A = W1 [x; 1] as 8 units x 4
//      cells per thread (float4s along the inputs), H = elu(A) in shared
//      memory; the tile's partial NN over its units, 2 cells x 4 outputs
//      per thread, written to part[unit tile][c][25].
//   L  wide_loss, a block per 8 cells: NN = the unit tiles' partials summed
//      in tile order + b2, each cell's loss and cotangent G, and the
//      block's sums of both over its cells. The last block to arrive (an
//      atomic ticket) takes the epoch's step: the blocks' sums reduced in a
//      fixed order (the epoch's loss and db2), the plateau, Adam's
//      constants for the epoch (kept for U), b2's Adam update and the run's
//      state (best, plateau count and scale in double).
//   B  wide_backward, a 2-D grid of (64 units x cell slice) blocks. Per
//      chunk of 64 cells (X and G double-buffered by cp.async): A recomputed
//      (not stored: H at the train-real shape is 62 MB an epoch, and storing
//      it measured slower there), dH = W2^T G and dA = dH elu'(A) as 4 units
//      x 4 cells per thread, H and dA to shared memory; then dW1 (and db1,
//      X's column of ones) as 4 units x 4 inputs and dW2 as 4 outputs x 4
//      units per thread, accumulated in registers over the slice's cells,
//      and written as the slice's partial gradients.
//   U  wide_update, a thread per parameter: the slices' partials summed in
//      slice order, then Adam(W) and the clamp of W1, b1 and W2.
// The plan (ops/train_wide.py::launch_plan) fixes the tiles, the groups,
// the slices and the scratch sizes from (din, hidden, C); the C entry
// checks it. Every sum runs in an order fixed by the plan, so a run repeats
// bit for bit and chunked runs compose exactly. The clamp spares b1 and b2,
// as in K4. The TPU kernel's products run at DEFAULT precision (one bf16
// pass on the MXU), which this port does not copy.
//
// What bounds it: per epoch 2 C h (2 din + 75) flops (forward and the two
// weight gradients), 5.65 GFLOP at the train-real shape (C = 1,904,
// h = 8,192, din = 53): 84 us at 67 TFLOP/s float32; the weights and
// moments, ~3 x 1.7 MB, are read and written once an epoch (~5 us at
// 3.35 TB/s), so the bound is compute. The recompute of A adds 2 C h din
// (1.65 GFLOP there); the inputs are padded to a multiple of 4 (with the
// bias) and the 25 outputs to 28 in the products.
#include <utility>

#include "train_common.cuh"

struct WideArgs {
  const float* cells[6];  // x, y_base, z_phys, tgt_y, tgt_z, e_tgt
  float* w[4];            // W1 (h, din), b1 (h), W2 (25, h), b2 (25): in place
  float* m[8];            // mu, nu of W1, b1, W2, b2: in place
  const float* s_in;      // count, best, plateau count, scale
  float* s_out;
  float* losses;          // (n_epochs,)
  float* g;               // scratch (C, 25): dL/dNN per cell
  float* sums;            // scratch (loss blocks, 26): each block's sums of
                          // the loss and of G over its cells
  double* run;            // (3): best, plateau count, scale of the run
  int C, din, hidden, n_epochs, patience, clamp;
  double lr, weight_decay, factor, rtol, ds;
  double inv[4];          // mean denominators: pos, states, eul, z
  float* part;            // scratch (forward unit tiles, C, 25): partial NN
  float* grad;            // scratch (slices, h (din + 26)): partial gradients
  int* count;             // (1,): the loss blocks' arrival ticket, 0
  AdamStep* step;         // scratch: this epoch's Adam constants
};

// The launch shape, ops/train_wide.py::launch_plan.
struct WidePlan {
  int threads;
  int fwd_units, fwd_cells, fwd_tiles;   // forward tile, tiles per block
  int loss_cells;                        // cells per loss block
  int bwd_units, bwd_cells;              // backward unit tile, chunk cells
  int slices, chunks;                    // cell slices, chunks per slice
  int fwd_smem, bwd_smem;                // dynamic shared memory, bytes
  int part_floats, sums_floats, grad_floats, counters;
};

constexpr int kThreads = 256;
constexpr int kFU = 128, kFC = 64;   // forward tile: units x cells
constexpr int kFW = kFU + 4;         // row stride of the forward's W1
constexpr int kHP = kFC + 4;         // row stride of the forward's H
constexpr int kLC = 8;               // cells per loss block
constexpr int kBU = 64, kBC = 64;    // backward: units, cells per chunk
constexpr int kBP = kBU + 4;         // row stride of the backward's W1, H, dA
constexpr int kOP = 28;              // 25 outputs, padded to float4s

__host__ __device__ constexpr int in_cols(int din) {   // din + 1, to float4s
  return (din + 1 + 3) & ~3;
}

__host__ __device__ constexpr int fwd_floats(int din) {
  return in_cols(din) * kFW        // W1^T tile, + b1, padded
         + 2 * kFC * in_cols(din)  // two X tiles, + ones
         + kFU * kHP               // H
         + kFU * kOP               // W2^T tile
         + kFC * kOut;             // the partial NN, for a coalesced store
}

__host__ __device__ constexpr int bwd_floats(int din) {
  return in_cols(din) * kBP        // W1^T tile, + b1, padded
         + kOP * kBU               // W2 tile, padded
         + 2 * kBC * in_cols(din)  // two X chunks, + ones
         + 2 * kBC * kOP           // two G chunks, padded
         + 2 * kBC * kBP;          // H, dA (cell-major)
}

// 4 bytes global -> shared, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait for all but the most recent group
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// The last of n blocks to call this (with every thread) gets true, after
// all n have published their global writes; it re-arms the ticket.
__device__ bool last_to_arrive(int* ticket, int n) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1) == n - 1;
    if (last) *ticket = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Cells [c0, c0 + n) of x into a cell-major buffer of KP columns (columns
// DIN.. are set once by the caller), zeros past n; asynchronously.
template <int DIN, int KP, int CELLS>
__device__ void load_x(float* Xs, const float* x, int c0, int n) {
  for (int i = threadIdx.x; i < CELLS * DIN; i += kThreads) {
    const int c = i / DIN, k = i - c * DIN;
    cp_async4(Xs + c * KP + k, c < n ? x + (size_t)c0 * DIN + i : x, c < n);
  }
}

// The ones column (the bias) and the zero padding of a cell-major X buffer.
template <int DIN, int KP, int CELLS>
__device__ void x_columns(float* Xs) {
  for (int i = threadIdx.x; i < CELLS * (KP - DIN); i += kThreads) {
    const int c = i / (KP - DIN), k = DIN + i % (KP - DIN);
    Xs[c * KP + k] = k == DIN ? 1.f : 0.f;
  }
}

// W1 rows [u0, u0 + nu) and b1, transposed into W1s (KP x stride), zeros
// in the padded rows and past nu.
template <int DIN, int KP, int UNITS, int STRIDE>
__device__ void load_w1(float* W1s, const WideArgs& a, int u0, int nu) {
  for (int i = threadIdx.x; i < UNITS * KP; i += kThreads) {
    const int uu = i / KP, k = i - uu * KP;
    W1s[k * STRIDE + uu] = uu >= nu ? 0.f
        : k < DIN ? a.w[0][(size_t)(u0 + uu) * DIN + k]
        : k == DIN ? a.w[1][u0 + uu] : 0.f;
  }
}

// F: forward of kFU units over a group of kFC-cell tiles: each tile's
// partial NN over the units.
template <int DIN>
__global__ void __launch_bounds__(kThreads, 2) wide_forward(const WideArgs a,
                                                            int tiles) {
  constexpr int KP = in_cols(DIN);
  extern __shared__ float4 smem4[];
  float* W1s = reinterpret_cast<float*>(smem4);   // KP x kFW (row DIN: b1)
  float* Xb = W1s + KP * kFW;                     // 2 x kFC x KP
  float* Hs = Xb + 2 * kFC * KP;                  // kFU x kHP
  float* W2t = Hs + kFU * kHP;                    // kFU x kOP
  float* Ps = W2t + kFU * kOP;                    // kFC x 25
  const int h = a.hidden, C = a.C, tid = threadIdx.x;
  const int u0 = blockIdx.x * kFU, nu = min(kFU, h - u0);
  const int n_tiles = (C + kFC - 1) / kFC;
  const int t0 = blockIdx.y * tiles, t1 = min(t0 + tiles, n_tiles);
  const float* x = a.cells[0];

  load_x<DIN, KP, kFC>(Xb, x, t0 * kFC, min(kFC, C - t0 * kFC));
  cp_async_commit();
  load_w1<DIN, KP, kFU, kFW>(W1s, a, u0, nu);
  for (int i = tid; i < kOP * kFU; i += kThreads) {
    const int o = i / kFU, uu = i % kFU;
    W2t[uu * kOP + o] =
        o < kOut && uu < nu ? a.w[2][(size_t)o * h + u0 + uu] : 0.f;
  }
  x_columns<DIN, KP, 2 * kFC>(Xb);

  const int tu = tid % 16, tc = tid / 16;
  for (int t = t0; t < t1; ++t) {
    const int c0 = t * kFC, n = min(kFC, C - c0);
    const float* Xs = Xb + ((t - t0) & 1) * kFC * KP;
    if (t + 1 < t1)
      load_x<DIN, KP, kFC>(Xb + ((t + 1 - t0) & 1) * kFC * KP, x, c0 + kFC,
                           min(kFC, C - c0 - kFC));
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();

    // A = W1 [x; 1]: units 4 tu + i and 64 + 4 tu + i, cells 4 tc + j
    {
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
      for (int kq = 0; kq < KP / 4; ++kq) {
        float4 xv[4], wl[4], wh[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          xv[j] = reinterpret_cast<const float4*>(Xs + (4 * tc + j) * KP)[kq];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4* wr =
              reinterpret_cast<const float4*>(W1s + (4 * kq + kk) * kFW);
          wl[kk] = wr[tu];
          wh[kk] = wr[16 + tu];
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float w = lane(i < 4 ? wl[kk] : wh[kk], i & 3);
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += w * lane(xv[j], kk);
          }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int uu = (i < 4 ? 0 : 64) + 4 * tu + (i & 3);
        reinterpret_cast<float4*>(Hs + uu * kHP)[tc] =
            make_float4(elu(acc[i][0]), elu(acc[i][1]), elu(acc[i][2]),
                        elu(acc[i][3]));
      }
    }
    __syncthreads();

    // partial NN[c][o] = sum_u W2[o][u] H[u][c]: cells 2 tc + j, outputs
    // 4 og + i (og < 7: 28 outputs, the last 3 zero)
    if (tid < 7 * 32) {
      const int tc2 = tid % 32, og = tid / 32;
      float acc[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = 0.f;
#pragma unroll 4
      for (int uu = 0; uu < nu; ++uu) {
        const float2 hv = reinterpret_cast<const float2*>(Hs + uu * kHP)[tc2];
        const float4 wv = reinterpret_cast<const float4*>(W2t + uu * kOP)[og];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] += lane(wv, i) * hv.x;
          acc[i][1] += lane(wv, i) * hv.y;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * og + i < kOut) {
          Ps[(2 * tc2) * kOut + 4 * og + i] = acc[i][0];
          Ps[(2 * tc2 + 1) * kOut + 4 * og + i] = acc[i][1];
        }
    }
    __syncthreads();
    float* out = a.part + ((size_t)blockIdx.x * C + c0) * kOut;
    for (int i = tid; i < n * kOut; i += kThreads) out[i] = Ps[i];
  }
}

// L: NN, loss and cotangent of kLC cells and the block's sums of both; the
// last block takes the step.
__global__ void __launch_bounds__(kThreads) wide_loss(const WideArgs a,
                                                      int n_tiles, int e) {
  constexpr int NS = kOut + 1;   // the loss, then G's 25 components
  constexpr int NR = 8;          // partial sums per quantity in the step
  __shared__ float NNs[kLC * kOut];
  __shared__ float cs[kLC][NS];
  __shared__ float red[NS][NR];
  const int C = a.C, tid = threadIdx.x;
  const int c0 = blockIdx.x * kLC, n = min(kLC, C - c0);
  const size_t stride = (size_t)C * kOut;
  for (int i = tid; i < n * kOut; i += kThreads) {
    const float* p = a.part + (size_t)c0 * kOut + i;
    float v = p[0];
#pragma unroll 16
    for (int t = 1; t < n_tiles; ++t) v += p[t * stride];
    NNs[i] = v + a.w[3][i % kOut];
  }
  __syncthreads();
  if (tid < n) {
    const float inv[4] = {(float)a.inv[0], (float)a.inv[1], (float)a.inv[2],
                          (float)a.inv[3]};
    float g[kOut];
    const size_t gc = (size_t)(c0 + tid);
    cs[tid][0] = cell_loss(NNs + tid * kOut, a.cells[1] + gc * 19,
                           a.cells[2] + gc * 6, a.cells[3] + gc * 19,
                           a.cells[4] + gc * 6, a.cells[5] + gc * 3,
                           (float)a.ds, inv, g);
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      a.g[gc * kOut + o] = g[o];
      cs[tid][1 + o] = g[o];
    }
  }
  __syncthreads();
  if (tid < NS) {
    float v = cs[0][tid];
    for (int c = 1; c < n; ++c) v += cs[c][tid];
    a.sums[(size_t)blockIdx.x * NS + tid] = v;
  }
  if (!last_to_arrive(a.count, gridDim.x)) return;

  // the step: the blocks' sums, each quantity in NR strided parts, then
  // the parts in order
  if (tid < NS * NR) {
    const int q = tid / NR, r = tid % NR;
    float v = 0.f;
    for (int b = r; b < (int)gridDim.x; b += NR)
      v += __ldcg(a.sums + (size_t)b * NS + q);
    red[q][r] = v;
  }
  __syncthreads();
  __shared__ AdamStep st;
  if (tid == 0) {
    float L = red[0][0];
#pragma unroll
    for (int r = 1; r < NR; ++r) L += red[0][r];
    float best = (float)a.run[0];
    int pcount = (int)a.run[1];
    double scale = a.run[2];
    plateau_step(L, a.rtol, a.patience, a.factor, best, pcount, scale);
    const float t0 = a.s_in[0];
    st = adam_step(bias_corrections((double)t0 + e + 1), scale, a.lr,
                   a.weight_decay, a.clamp);
    *a.step = st;   // for the update of W1, b1 and W2
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
  __syncthreads();
  if (tid < kOut) {
    float db2 = red[1 + tid][0];
#pragma unroll
    for (int r = 1; r < NR; ++r) db2 += red[1 + tid][r];
    a.w[3][tid] = adam_update(a.w[3][tid], db2, a.m[6] + tid, a.m[7] + tid,
                              st, false);
  }
}

// Cells [c0, c0 + n) of G into a cell-major buffer of kOP columns (the
// padding set once by the caller), zeros past n; asynchronously.
__device__ void load_g(float* Gc, const float* g, int c0, int n) {
  for (int i = threadIdx.x; i < kBC * kOut; i += kThreads) {
    const int c = i / kOut, o = i - c * kOut;
    cp_async4(Gc + c * kOP + o, c < n ? g + (size_t)c0 * kOut + i : g, c < n);
  }
}

// B: backward of kBU units over one slice of the cells: the slice's
// partial gradients.
template <int DIN>
__global__ void __launch_bounds__(kThreads, 2) wide_backward(
    const WideArgs a, int chunks) {
  constexpr int KP = in_cols(DIN), KR = DIN + 1;
  extern __shared__ float4 smem4[];
  float* W1s = reinterpret_cast<float*>(smem4);   // KP x kBP (row DIN: b1)
  float* W2s = W1s + KP * kBP;                    // kOP x kBU
  float* Xb = W2s + kOP * kBU;                    // 2 x kBC x KP
  float* Gb = Xb + 2 * kBC * KP;                  // 2 x kBC x kOP
  float* Hc = Gb + 2 * kBC * kOP;                 // kBC x kBP
  float* Dc = Hc + kBC * kBP;                     // kBC x kBP
  const int h = a.hidden, C = a.C, tid = threadIdx.x;
  const int u0 = blockIdx.x * kBU, nu = min(kBU, h - u0);
  const int n_chunks = (C + kBC - 1) / kBC;
  const int ch0 = blockIdx.y * chunks, ch1 = min(ch0 + chunks, n_chunks);
  const float* x = a.cells[0];

  load_x<DIN, KP, kBC>(Xb, x, ch0 * kBC, min(kBC, C - ch0 * kBC));
  load_g(Gb, a.g, ch0 * kBC, min(kBC, C - ch0 * kBC));
  cp_async_commit();
  load_w1<DIN, KP, kBU, kBP>(W1s, a, u0, nu);
  for (int i = tid; i < kOP * kBU; i += kThreads) {
    const int o = i / kBU, uu = i % kBU;
    W2s[i] = o < kOut && uu < nu ? a.w[2][(size_t)o * h + u0 + uu] : 0.f;
  }
  x_columns<DIN, KP, 2 * kBC>(Xb);
  for (int i = tid; i < 2 * kBC * (kOP - kOut); i += kThreads)
    Gb[(i / (kOP - kOut)) * kOP + kOut + i % (kOP - kOut)] = 0.f;

  const int tu = tid % 16, tc = tid / 16;   // 4 units x 4 cells / inputs /
  float gW1[4][4], gW2[4][4];               // outputs of this thread
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) gW1[i][j] = gW2[i][j] = 0.f;

  for (int ch = ch0; ch < ch1; ++ch) {
    const int c0 = ch * kBC, n = min(kBC, C - c0);
    const float* Xs = Xb + ((ch - ch0) & 1) * kBC * KP;
    const float* Gc = Gb + ((ch - ch0) & 1) * kBC * kOP;
    if (ch + 1 < ch1) {
      const int nn = min(kBC, C - c0 - kBC);
      load_x<DIN, KP, kBC>(Xb + ((ch + 1 - ch0) & 1) * kBC * KP, x,
                           c0 + kBC, nn);
      load_g(Gb + ((ch + 1 - ch0) & 1) * kBC * kOP, a.g, c0 + kBC, nn);
    }
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();

    // A = W1 [x; 1], dH = W2^T g, dA = dH elu'(A): units 4 tu + i, cells
    // 4 tc + j
    {
      float av[4][4], dh[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) av[i][j] = dh[i][j] = 0.f;
#pragma unroll 2
      for (int kq = 0; kq < KP / 4; ++kq) {
        float4 xv[4], wv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          xv[j] = reinterpret_cast<const float4*>(Xs + (4 * tc + j) * KP)[kq];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wv[kk] = reinterpret_cast<const float4*>(W1s + (4 * kq + kk) * kBP)[tu];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              av[i][j] += lane(wv[kk], i) * lane(xv[j], kk);
      }
#pragma unroll
      for (int oq = 0; oq < kOP / 4; ++oq) {
        float4 gv[4], wv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          gv[j] = reinterpret_cast<const float4*>(Gc + (4 * tc + j) * kOP)[oq];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wv[kk] = reinterpret_cast<const float4*>(W2s + (4 * oq + kk) * kBU)[tu];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              dh[i][j] += lane(wv[kk], i) * lane(gv[j], kk);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float hv[4], dv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          hv[i] = elu(av[i][j]);
          dv[i] = dh[i][j] * elu_grad(hv[i]);
        }
        const int row = (4 * tc + j) * kBP;
        reinterpret_cast<float4*>(Hc + row)[tu] =
            make_float4(hv[0], hv[1], hv[2], hv[3]);
        reinterpret_cast<float4*>(Dc + row)[tu] =
            make_float4(dv[0], dv[1], dv[2], dv[3]);
      }
    }
    __syncthreads();

    // dW1[u][k] += dA[c][u] X[c][k] (k = DIN: db1): units 4 tu + i, inputs
    // 4 tc + j
    if (tc < KP / 4) {
#pragma unroll 4
      for (int c = 0; c < n; ++c) {
        const float4 dv = reinterpret_cast<const float4*>(Dc + c * kBP)[tu];
        const float4 xv = reinterpret_cast<const float4*>(Xs + c * KP)[tc];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) gW1[i][j] += lane(dv, i) * lane(xv, j);
      }
    }
    // dW2[o][u] += G[c][o] H[c][u]: outputs 4 tc + i, units 4 tu + j
    if (tc < kOP / 4) {
#pragma unroll 4
      for (int c = 0; c < n; ++c) {
        const float4 gv = reinterpret_cast<const float4*>(Gc + c * kOP)[tc];
        const float4 hv = reinterpret_cast<const float4*>(Hc + c * kBP)[tu];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) gW2[i][j] += lane(gv, i) * lane(hv, j);
      }
    }
    __syncthreads();   // before the next chunk's loads reuse the buffers
  }

  // this slice's partial gradients: grad[slice] = dW1 | db1 (h x (DIN + 1),
  // unit-major as W1), then dW2 (25 x h, as W2)
  float* part = a.grad + (size_t)blockIdx.y * h * (KR + kOut);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int uu = 4 * tu + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * tc + j;
      if (uu < nu && k < KR) part[(size_t)(u0 + uu) * KR + k] = gW1[i][j];
    }
  }
  float* part2 = part + (size_t)h * KR;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = 4 * tc + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int uu = 4 * tu + j;
      if (uu < nu && o < kOut) part2[(size_t)o * h + u0 + uu] = gW2[i][j];
    }
  }
}

// U: one parameter of W1, b1 or W2 per thread: the slices' partial
// gradients summed in slice order, then Adam(W) and the clamp.
__global__ void __launch_bounds__(kThreads) wide_update(const WideArgs a,
                                                        int slices) {
  const int h = a.hidden, din = a.din, kr = din + 1;
  const size_t n1 = (size_t)h * kr, n = n1 + (size_t)kOut * h;
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float* gp = a.grad + i;
  float g = gp[0];
#pragma unroll 4
  for (int s = 1; s < slices; ++s) g += gp[s * n];
  const AdamStep st = *a.step;
  if (i < n1) {
    const int j = (int)(i / kr), p = (int)(i - (size_t)j * kr);
    if (p < din) {
      const size_t at = (size_t)j * din + p;
      a.w[0][at] = adam_update(a.w[0][at], g, a.m[0] + at, a.m[1] + at, st,
                               true);
    } else {
      a.w[1][j] = adam_update(a.w[1][j], g, a.m[2] + j, a.m[3] + j, st,
                              false);
    }
  } else {
    const size_t at = i - n1;   // o * h + j, as W2
    a.w[2][at] = adam_update(a.w[2][at], g, a.m[4] + at, a.m[5] + at, st,
                             true);
  }
}

// Whether the plan is this file's for (din, hidden, C).
static bool plan_ok(const WidePlan& p, int din, int h, int C) {
  const int n_fu = (h + kFU - 1) / kFU, n_ft = (C + kFC - 1) / kFC;
  const int n_chunks = (C + kBC - 1) / kBC;
  return p.threads == kThreads && p.fwd_units == kFU && p.fwd_cells == kFC &&
         p.fwd_tiles >= 1 && p.loss_cells == kLC && p.bwd_units == kBU &&
         p.bwd_cells == kBC && p.slices >= 1 && p.chunks >= 1 &&
         (long)p.slices * p.chunks >= n_chunks &&
         (long)(p.slices - 1) * p.chunks < n_chunks &&
         p.fwd_tiles <= n_ft &&
         p.fwd_smem == 4 * fwd_floats(din) &&
         p.bwd_smem == 4 * bwd_floats(din) &&
         p.part_floats == n_fu * C * kOut &&
         p.sums_floats == (C + kLC - 1) / kLC * (kOut + 1) &&
         p.grad_floats == p.slices * h * (din + 1 + kOut) &&
         p.counters == 1;
}

template <int DIN>
static int run_epochs(const WideArgs& a, const WidePlan& p,
                      cudaStream_t stream) {
  // the largest shared-memory carveout, so that two blocks fit on an SM
  cudaError_t err = cudaSuccess;
  for (auto [kern, smem] : {std::pair{(const void*)wide_forward<DIN>, p.fwd_smem},
                            std::pair{(const void*)wide_backward<DIN>, p.bwd_smem}}) {
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kern,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();   // the error is returned, not left behind
    return (int)err;
  }
  const int h = a.hidden, C = a.C;
  const int n_ft = (C + kFC - 1) / kFC;
  const dim3 fwd((h + kFU - 1) / kFU, (n_ft + p.fwd_tiles - 1) / p.fwd_tiles);
  const dim3 bwd((h + kBU - 1) / kBU, p.slices);
  const int n_loss = (C + kLC - 1) / kLC;
  const int n_upd = (int)(((size_t)h * (DIN + 1 + kOut) + kThreads - 1) /
                          kThreads);
  for (int e = 0; e < a.n_epochs; ++e) {
    wide_forward<DIN><<<fwd, kThreads, p.fwd_smem, stream>>>(a, p.fwd_tiles);
    wide_loss<<<n_loss, kThreads, 0, stream>>>(a, fwd.x, e);
    wide_backward<DIN><<<bwd, kThreads, p.bwd_smem, stream>>>(a, p.chunks);
    wide_update<<<n_upd, kThreads, 0, stream>>>(a, p.slices);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// C entry point (bound with ctypes in ops/_build.py): n_epochs epochs, four
// launches each, on ``stream``. Pointers are device pointers of contiguous
// float32 tensors (``run`` float64, ``count`` int32 zeros), which the
// wrapper allocates to the plan's sizes; the weights and the moments are
// updated in place. Returns the CUDA error of the launches (0: none).
extern "C" int knode_train_wide(const WideArgs* a, const WidePlan* plan,
                                void* stream) {
  if (a->C < 1 || a->hidden < 1 || a->n_epochs < 1 ||
      !plan_ok(*plan, a->din, a->hidden, a->C))
    return (int)cudaErrorInvalidValue;
  switch (a->din) {
    case 28:
      return run_epochs<28>(*a, *plan, (cudaStream_t)stream);
    case 53:
      return run_epochs<53>(*a, *plan, (cudaStream_t)stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
