// K1: the per-node hybrid Cosserat right-hand side, in two forms: one
// thread per lane (rhs_node), and one warp per lane with the MLP's hidden
// units spread over its 32 threads (rhs_node_coop).
//
// Replaces the per-node body of the TPU kernels,
// knode_cosserat_tpu/ops/pallas_sweep.py::make_rhs_rows, which K3
// (sweep.cu) and K2 (step.cu) inline here as they did there. Mirrors
// reference cosserat_ode.py:114-186 and the plain version
// knode_cosserat_tpu_torch/core/rhs.py::rhs step for step:
//   quaternion -> R; constitutive solve through the pre-inverted
//   Kse+c0*Bse, Kbt+c0*Bbt plus v_rest; BDF-2 history terms; drag,
//   gravity and tendon force; rod derivatives; optionally the KNODE MLP on
//   [y, z, tf] (28 inputs) or [y, yh, z, zh, tf] (53), added to dy (19)
//   and z (6).
//
// Where the H100 bounds it: the physics is ~400 flops on 19 states held
// in registers; the MLP is the cost, 2*(NNIN*H + 25*H) ~ 54 kflop per
// node at H = 512. In one thread (rhs_node, kept for K7, which has no
// net, and K8, one thread per cell) that is a chain of ~27k dependent
// FMAs, each with a weight load: bound by one thread's issue rate.
//
// rhs_node_coop, the body of K2 and of K3's hybrid instances: a group of
// threads evaluates one lane (rod x probe or candidate), a warp when the
// block holds a tile of lanes, one per warp, or the whole block when the
// phase has a single lane (K2's first, alpha = 1 and recording sweeps).
// Each thread holds the lane's state and runs the physics itself (a warp
// issues it once, as one thread would, and no broadcast is needed);
// thread s of the group computes the hidden units s, s+S, s+2S, ... and
// accumulates its partial sums of the 25 outputs; a butterfly of
// shuffles, and over a block a pass through shared memory, reduces them
// in an order fixed by H and the group's size alone, so a lane's bits do
// not depend on the batch, and every thread ends with the same sums.
// The weights are staged once per block into shared memory (stage_net:
// W1 transposed to (NNIN, H+1), so the threads of a warp read
// neighbouring words, b1, W2 (25, H), b2) when they fit in the 227 KB a
// block can have; otherwise (float64 with 53 inputs at H = 512, or wide
// nets) each thread walks its unit's row of W1 and column of W2 straight
// from global memory through the read-only path. What bounds it then:
// every lane reads every weight from shared memory once per node, one
// load per FMA (110.7 KB per node at H = 512, f32), so a node costs
// ~860 cycles of the SM's shared-memory bandwidth per lane; a thread that
// reused each loaded weight over several lanes (25 partial sums per lane
// in registers) would cut that, at a register cost float64 cannot pay.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

// Rod constants as the host fills them (float64, via ctypes). The layout
// must match RodConstsHost in knode_cosserat_tpu_torch/ops/_build.py.
struct RodConstsHost {
  double Kse_inv[9], Kbt_inv[9], Bse[9], Bbt[9], rhoJ[9];  // row-major 3x3
  double v_rest[3], rhoAg[3], C[3];
  double c0, rhoA, ds;
  double p0[3], h0[4], q0[3], w0[3], F_tip[3], M_tip[3];
};

// The same constants in the kernel's working type, passed by value (one
// build serves every rod; the TPU kernels baked them in as literals).
template <typename T>
struct RodConsts {
  T Kse_inv[9], Kbt_inv[9], Bse[9], Bbt[9], rhoJ[9];
  T v_rest[3], rhoAg[3], C[3];
  T c0, rhoA, ds;
  T p0[3], h0[4], q0[3], w0[3], F_tip[3], M_tip[3];
};

// (host and device: K7 casts its per-rod constants on the card)
template <typename T>
__host__ __device__ inline RodConsts<T> cast_consts(const RodConstsHost& h) {
  RodConsts<T> c;
  for (int i = 0; i < 9; ++i) {
    c.Kse_inv[i] = T(h.Kse_inv[i]);
    c.Kbt_inv[i] = T(h.Kbt_inv[i]);
    c.Bse[i] = T(h.Bse[i]);
    c.Bbt[i] = T(h.Bbt[i]);
    c.rhoJ[i] = T(h.rhoJ[i]);
  }
  for (int i = 0; i < 3; ++i) {
    c.v_rest[i] = T(h.v_rest[i]);
    c.rhoAg[i] = T(h.rhoAg[i]);
    c.C[i] = T(h.C[i]);
    c.p0[i] = T(h.p0[i]);
    c.q0[i] = T(h.q0[i]);
    c.w0[i] = T(h.w0[i]);
    c.F_tip[i] = T(h.F_tip[i]);
    c.M_tip[i] = T(h.M_tip[i]);
  }
  for (int i = 0; i < 4; ++i) c.h0[i] = T(h.h0[i]);
  c.c0 = T(h.c0);
  c.rhoA = T(h.rhoA);
  c.ds = T(h.ds);
  return c;
}

enum Activation { ACT_ELU = 0, ACT_TANH = 1, ACT_RELU = 2, ACT_SOFTPLUS = 3 };

// A 2-layer KNODE net: W1 (hidden, NNIN), b1 (hidden), W2 (25, hidden),
// b2 (25), all row-major as nn.Linear holds them. W1 == nullptr: no net.
template <typename T>
struct Mlp {
  const T* __restrict__ W1;
  const T* __restrict__ b1;
  const T* __restrict__ W2;
  const T* __restrict__ b2;
  int hidden;
  int act;
};

__device__ __forceinline__ float m_expm1(float x) { return expm1f(x); }
__device__ __forceinline__ double m_expm1(double x) { return expm1(x); }
__device__ __forceinline__ float m_tanh(float x) { return tanhf(x); }
__device__ __forceinline__ double m_tanh(double x) { return tanh(x); }
__device__ __forceinline__ float m_log1p(float x) { return log1pf(x); }
__device__ __forceinline__ double m_log1p(double x) { return log1p(x); }
__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }

template <typename T>
__device__ __forceinline__ T activate(T a, int act) {
  switch (act) {
    case ACT_ELU: return a > T(0) ? a : m_expm1(a);
    case ACT_TANH: return m_tanh(a);
    case ACT_RELU: return a > T(0) ? a : T(0);
    default:  // softplus = log1p(exp(-|a|)) + max(a, 0)
      return m_log1p(m_exp(-m_abs(a))) + (a > T(0) ? a : T(0));
  }
}

// M (row-major 3x3) @ x
template <typename T>
__device__ __forceinline__ void mv3(const T* M, const T* x, T* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[i] = M[3 * i] * x[0] + M[3 * i + 1] * x[1] + M[3 * i + 2] * x[2];
}

template <typename T>
__device__ __forceinline__ void cross3(const T* a, const T* b, T* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// The net's input (cosserat_ode.py:171-175): [y, z, tf] or
// [y, yh, z, zh, tf], z the physics strains.
template <typename T, int NNIN>
__device__ __forceinline__ void net_inputs(const T* y, const T* yh,
                                          const T* z, const T* zh,
                                          const T* tf, T* x) {
  int o = 0;
#pragma unroll
  for (int i = 0; i < 19; ++i) x[o++] = y[i];
  if constexpr (NNIN == 53) {
#pragma unroll
    for (int i = 0; i < 19; ++i) x[o++] = yh[i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) x[o++] = z[i];
  if constexpr (NNIN == 53) {
#pragma unroll
    for (int i = 0; i < 6; ++i) x[o++] = zh[i];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) x[o++] = tf[i];
}

// One node: y, yh (19), zh (6), tf (3) -> dy (19), z (6). yh, zh may point
// to global memory; y, dy, z are the thread's own arrays.
template <typename T, int NNIN>
__device__ __forceinline__ void rhs_node(const RodConsts<T>& rc,
                                         const Mlp<T>& mlp, const T* y,
                                         const T* yh, const T* zh,
                                         const T* tf, T* dy, T* z) {
  const T h1 = y[3], h2 = y[4], h3 = y[5], h4 = y[6];
  const T* n = y + 7;
  const T* m = y + 10;
  const T* q = y + 13;
  const T* w = y + 16;
  T vh[3], uh[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    vh[i] = zh[i];
    uh[i] = zh[3 + i];
  }

  // quaternion -> R, the reference's non-unit-safe form
  const T s = T(2) / (h1 * h1 + h2 * h2 + h3 * h3 + h4 * h4);
  T R[9];
  R[0] = T(1) + s * (-h3 * h3 - h4 * h4);
  R[1] = s * (h2 * h3 - h4 * h1);
  R[2] = s * (h2 * h4 + h3 * h1);
  R[3] = s * (h2 * h3 + h4 * h1);
  R[4] = T(1) + s * (-h2 * h2 - h4 * h4);
  R[5] = s * (h3 * h4 - h2 * h1);
  R[6] = s * (h2 * h4 - h3 * h1);
  R[7] = s * (h3 * h4 + h2 * h1);
  R[8] = T(1) + s * (-h2 * h2 - h3 * h3);

  // constitutive solve: v = Kinv (R^T n - Bse vh) + v_rest,
  //                     u = Kinv (R^T m - Bbt uh)
  T t0[3], t1[3], v[3], u[3];
  mv3(rc.Bse, vh, t1);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    t0[i] = R[i] * n[0] + R[3 + i] * n[1] + R[6 + i] * n[2] - t1[i];
  mv3(rc.Kse_inv, t0, v);
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] += rc.v_rest[i];
  mv3(rc.Bbt, uh, t1);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    t0[i] = R[i] * m[0] + R[3 + i] * m[1] + R[6 + i] * m[2] - t1[i];
  mv3(rc.Kbt_inv, t0, u);

  // BDF-2 time derivatives
  T vt[3], ut[3], qt[3], wt[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    vt[i] = rc.c0 * v[i] + vh[i];
    ut[i] = rc.c0 * u[i] + uh[i];
    qt[i] = rc.c0 * q[i] + yh[13 + i];
    wt[i] = rc.c0 * w[i] + yh[16 + i];
  }

  // body force: weight - R (C q|q|) + tendons
  T drag[3], fb[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) drag[i] = rc.C[i] * q[i] * m_abs(q[i]);
  mv3(R, drag, t0);
#pragma unroll
  for (int i = 0; i < 3; ++i) fb[i] = rc.rhoAg[i] - t0[i] + tf[i];

  // rod state derivatives
  T ps[3], ns[3], ms[3], qs[3], ws[3];
  mv3(R, v, ps);
  cross3(w, q, t0);
#pragma unroll
  for (int i = 0; i < 3; ++i) t0[i] += qt[i];
  mv3(R, t0, t1);
#pragma unroll
  for (int i = 0; i < 3; ++i) ns[i] = rc.rhoA * t1[i] - fb[i];

  T rJw[3], rJwt[3];
  mv3(rc.rhoJ, w, rJw);
  mv3(rc.rhoJ, wt, rJwt);
  cross3(w, rJw, t0);
#pragma unroll
  for (int i = 0; i < 3; ++i) t0[i] += rJwt[i];
  mv3(R, t0, t1);
  cross3(ps, n, t0);
#pragma unroll
  for (int i = 0; i < 3; ++i) ms[i] = t1[i] - t0[i];

  cross3(u, q, t0);
  cross3(w, v, t1);
#pragma unroll
  for (int i = 0; i < 3; ++i) qs[i] = vt[i] - t0[i] + t1[i];
  cross3(u, w, t0);
#pragma unroll
  for (int i = 0; i < 3; ++i) ws[i] = ut[i] - t0[i];

  const T u1 = u[0], u2 = u[1], u3 = u[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    dy[i] = ps[i];
    dy[7 + i] = ns[i];
    dy[10 + i] = ms[i];
    dy[13 + i] = qs[i];
    dy[16 + i] = ws[i];
    z[i] = v[i];
    z[3 + i] = u[i];
  }
  dy[3] = T(0.5) * (-u1 * h2 - u2 * h3 - u3 * h4);
  dy[4] = T(0.5) * (u1 * h1 + u3 * h3 - u2 * h4);
  dy[5] = T(0.5) * (u2 * h1 - u3 * h2 + u1 * h4);
  dy[6] = T(0.5) * (u3 * h1 + u2 * h2 - u1 * h3);

  if constexpr (NNIN > 0) {
    T x[NNIN];
    net_inputs<T, NNIN>(y, yh, z, zh, tf, x);

    // hidden layer streamed one unit at a time
    T out[25];
#pragma unroll
    for (int j = 0; j < 25; ++j) out[j] = T(0);
    const int H = mlp.hidden;
    for (int k = 0; k < H; ++k) {
      const T* wk = mlp.W1 + (size_t)k * NNIN;
      T a = T(0);
#pragma unroll
      for (int i = 0; i < NNIN; ++i) a += __ldg(wk + i) * x[i];
      a = activate(a + __ldg(mlp.b1 + k), mlp.act);
#pragma unroll
      for (int j = 0; j < 25; ++j) out[j] += __ldg(mlp.W2 + (size_t)j * H + k) * a;
    }
#pragma unroll
    for (int i = 0; i < 19; ++i) dy[i] += out[i] + __ldg(mlp.b2 + i);
#pragma unroll
    for (int i = 0; i < 6; ++i) z[i] += out[19 + i] + __ldg(mlp.b2 + 19 + i);
  }
}

// The cooperative form: the net as rhs_node_coop reads it. SMEM: staged
// by stage_net in shared memory (W1 transposed to (NNIN, H+1), b1, W2
// (25, H), b2, one after the other); otherwise the Mlp's own global
// arrays in nn.Linear's layout (W1 (H, NNIN) row-major).
constexpr int WARP = 32;

template <typename T, bool SMEM>
struct NetView {
  const T* W1;
  const T* b1;
  const T* W2;
  const T* b2;
  int H, act;
};

// Shared memory a staged net takes (the layout above), rounded up to 8
// bytes so that what follows is aligned; the launch plans
// (ops/sweep.py::net_smem_bytes) count the same.
template <typename T>
__host__ __device__ inline size_t net_smem_bytes(int nn_in, int H) {
  const size_t elems = (size_t)nn_in * (H + 1) + 26 * (size_t)H + 25;
  return (elems * sizeof(T) + 7) & ~(size_t)7;
}

template <bool SMEM, typename T>
__device__ __forceinline__ T ldw(const T* p) {
  if constexpr (SMEM) return *p;
  else return __ldg(p);
}

// W1[k][i]: unit k, input i
template <typename T, int NNIN, bool SMEM>
__device__ __forceinline__ T w1_at(const NetView<T, SMEM>& net, int k,
                                   int i) {
  if constexpr (SMEM) return net.W1[(size_t)i * (net.H + 1) + k];
  else return __ldg(net.W1 + (size_t)k * NNIN + i);
}

// Copies the net into shared memory s, all threads of the block, and
// waits for the copy: neighbouring threads read neighbouring global words;
// W1's transposed rows are H+1 long, so a warp's writes spread over banks.
template <typename T, int NNIN>
__device__ __forceinline__ NetView<T, true> stage_net(const Mlp<T>& m,
                                                      T* s) {
  const int H = m.hidden, ld = H + 1;
  T* W1t = s;
  T* b1 = W1t + (size_t)NNIN * ld;
  T* W2 = b1 + H;
  T* b2 = W2 + (size_t)25 * H;
  for (int e = threadIdx.x; e < H * NNIN; e += blockDim.x) {
    const int k = e / NNIN, i = e - k * NNIN;
    W1t[(size_t)i * ld + k] = __ldg(m.W1 + e);
  }
  for (int e = threadIdx.x; e < H; e += blockDim.x) b1[e] = __ldg(m.b1 + e);
  for (int e = threadIdx.x; e < 25 * H; e += blockDim.x)
    W2[e] = __ldg(m.W2 + e);
  for (int e = threadIdx.x; e < 25; e += blockDim.x) b2[e] = __ldg(m.b2 + e);
  __syncthreads();
  return NetView<T, true>{W1t, b1, W2, b2, H, m.act};
}

// The block's view of its net: staged into s (SMEM; every thread of the
// block must call it) or read in place.
template <typename T, int NNIN, bool SMEM>
__device__ __forceinline__ NetView<T, SMEM> net_view(const Mlp<T>& m, T* s) {
  if constexpr (SMEM) return stage_net<T, NNIN>(m, s);
  else return NetView<T, false>{m.W1, m.b1, m.W2, m.b2, m.hidden, m.act};
}

// out (25) = the group's 25 partial sums added up: a butterfly of xor
// shuffles adds a warp's 32; with `red` (a shared scratch of (warps + 1) x
// 25) each warp's sums then go to shared memory and are added warp by
// warp. The order is fixed by the group's size alone, and every thread of
// the group ends with the same bits.
template <typename T>
__device__ __forceinline__ void group_sum25(T* acc, T* out, T* red) {
#pragma unroll
  for (int m = WARP / 2; m > 0; m >>= 1) {
#pragma unroll
    for (int j = 0; j < 25; ++j)
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], m);
  }
  if (red) {
    const int nw = blockDim.x / WARP;
    T* fin = red + 25 * nw;
    if ((threadIdx.x & (WARP - 1)) == 0) {
#pragma unroll
      for (int j = 0; j < 25; ++j) red[25 * (threadIdx.x / WARP) + j] = acc[j];
    }
    __syncthreads();
    if (threadIdx.x < 25) {
      T v = red[threadIdx.x];
      for (int w = 1; w < nw; ++w) v += red[25 * w + threadIdx.x];
      fin[threadIdx.x] = v;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 25; ++j) acc[j] = fin[j];
  }
#pragma unroll
  for (int j = 0; j < 25; ++j) out[j] = acc[j];
}

// out (25) = W2 act(W1 x + b1), over the calling warp or, with `red`,
// the whole block: thread u of the group takes the units u, u+2S, ... and
// u+S, u+3S, ... (S the group's size, two at a time for two independent
// FMA chains) and sums its share of each output in unit order, then
// group_sum25 adds the shares. The order is fixed by H and the group's
// size alone. Units past H (a ragged last tile) are masked. Every thread
// of the group must call it.
template <typename T, int NNIN, bool SMEM>
__device__ __forceinline__ void mlp_coop(const NetView<T, SMEM>& net,
                                         const T* x, T* out, T* red,
                                         T* /*buf: deep nets only*/) {
  const int S = red ? (int)blockDim.x : WARP;
  const int s = red ? (int)threadIdx.x : (int)(threadIdx.x & (WARP - 1));
  const int H = net.H;
  T acc[25];
#pragma unroll
  for (int j = 0; j < 25; ++j) acc[j] = T(0);
  for (int k = s; k < H; k += 2 * S) {
    const int k2 = k + S;
    const bool two = k2 < H;
    const int kb = two ? k2 : k;
    T a = T(0), a2 = T(0);
#pragma unroll
    for (int i = 0; i < NNIN; ++i) {
      a += w1_at<T, NNIN, SMEM>(net, k, i) * x[i];
      a2 += w1_at<T, NNIN, SMEM>(net, kb, i) * x[i];
    }
    a = activate(a + ldw<SMEM>(net.b1 + k), net.act);
#pragma unroll
    for (int j = 0; j < 25; ++j)
      acc[j] += ldw<SMEM>(net.W2 + (size_t)j * H + k) * a;
    if (two) {
      a2 = activate(a2 + ldw<SMEM>(net.b1 + k2), net.act);
#pragma unroll
      for (int j = 0; j < 25; ++j)
        acc[j] += ldw<SMEM>(net.W2 + (size_t)j * H + k2) * a2;
    }
  }
  group_sum25(acc, out, red);
}

// ------------------------------------------------- nets of any depth
// The JAX kernels take a KNODE net of any depth (ops/pallas_sweep.py's
// dims loop); this is K1's form for three layers or more. The two-layer
// net keeps NetView and mlp_coop above, unchanged.
//
// The host passes the net as a layer table (NetTableHost, mirrored by
// ops/_build.py): layer l maps dims[l] inputs to dims[l+1] outputs, W[l]
// (dims[l+1], dims[l]) and b[l] in nn.Linear's layout. At the start of a
// block, deep_view writes the table the lanes read (DeepLayer, one per
// layer, at the head of the dynamic shared memory) and, when the whole net
// fits beside the scratch (`staged`, decided by the launch plans), copies
// the net into shared memory: each hidden layer transposed to (din,
// dout+1), so a warp's threads read neighbouring words, the output layer
// as it is. Otherwise every layer is read in place from global memory: a
// 512 x 512 middle layer is 1 MiB in float32 and no block can stage it.
//
// mlp_coop over a DeepView: layer 0 reads the lane's inputs from
// registers, thread s of the group (a warp, or the block with `red`)
// computing the units s, s+S, ... Every later layer reads the previous
// row from the lane's scratch `buf` (two rows of maxw, the widest hidden
// layer: one read, one written) in blocks of 32 units per warp
// (layer_blocks): lane s multiplies inputs s, s+32, ... into 32 partial
// sums, one per unit of the block, so the warp reads each weight row as
// consecutive words (coalesced from global memory, conflict-free from the
// staged transpose), and a transposing butterfly (31 shuffles) leaves the
// sum of unit k0+s on lane s. A __syncwarp (a __syncthreads over the
// block) separates the layers, since each unit of the next layer needs the
// whole previous row. The last hidden layer's units are not stored: each
// thread adds its unit into its 25 partial outputs at once, and
// group_sum25 adds the shares, as the two-layer form does. The order of
// every sum is fixed by the widths and the group's size, so a lane's bits
// do not depend on the batch.
constexpr int MAX_LAYERS = 8;

struct NetTableHost {
  const void* W[MAX_LAYERS];
  const void* b[MAX_LAYERS];
  int dims[MAX_LAYERS + 1];
  int n_layers, act, staged, maxw;
};

// One layer as the lanes read it: the weight of output o, input i at
// W[o * so + i * si] (generic pointers: shared or global memory).
struct DeepLayer {
  const void* W;
  const void* b;
  int so, si, din, dout;
};
static_assert(sizeof(DeepLayer) == 32, "ops/sweep.py::DEEP_TABLE_BYTES");
constexpr int DEEP_TABLE_BYTES = MAX_LAYERS * (int)sizeof(DeepLayer);

template <typename T>
struct DeepView {
  const DeepLayer* lay;
  int n, act, maxw;
};

// Elements of layers [0, upto) in the staged layout: a hidden layer
// din x (dout + 1) + dout, the output layer dout x din + dout.
__host__ __device__ inline size_t deep_net_elems(const int* dims, int L,
                                                 int upto) {
  size_t e = 0;
  for (int l = 0; l < upto; ++l) {
    const size_t din = dims[l], dout = dims[l + 1];
    e += (l < L - 1 ? din * (dout + 1) : dout * din) + dout;
  }
  return e;
}

// Bytes of the staged net, rounded up to 8 (ops/sweep.py::deep_net_bytes).
template <typename T>
__host__ __device__ inline size_t deep_net_bytes(const int* dims, int L) {
  return (deep_net_elems(dims, L, L) * sizeof(T) + 7) & ~(size_t)7;
}

// The dynamic shared memory a deep net takes ahead of anything else the
// kernel keeps there: the layer table, the staged net (if staged) and
// `groups` lanes' activation scratch of 2 x maxw.
template <typename T>
__host__ __device__ inline size_t deep_smem_bytes(const NetTableHost& t,
                                                  int groups) {
  return DEEP_TABLE_BYTES +
         (t.staged ? deep_net_bytes<T>(t.dims, t.n_layers) : 0) +
         (size_t)groups * 2 * t.maxw * sizeof(T);
}

// The host's checks of a table: 3..MAX_LAYERS layers, nn_in inputs, 25
// outputs, every pointer set, and maxw the widest hidden layer a lane
// keeps (layers 0 .. L-3 write the scratch).
inline bool deep_table_ok(const NetTableHost& t, int nn_in) {
  const int L = t.n_layers;
  if (L < 3 || L > MAX_LAYERS || t.dims[0] != nn_in || t.dims[L] != 25)
    return false;
  int w = 0;
  for (int l = 0; l < L; ++l) {
    if (!t.W[l] || !t.b[l] || t.dims[l + 1] <= 0) return false;
    if (l < L - 2 && t.dims[l + 1] > w) w = t.dims[l + 1];
  }
  return t.maxw == w;
}

// The block's view of its net (every thread of the block must call it):
// the layer table written, the net staged when t.staged, a barrier. `net`
// picks one net of a stack of nets (K2's one net per rod): each layer's
// pointers move on by `net` times that layer's size.
template <typename T>
__device__ __forceinline__ DeepView<T> deep_view(const NetTableHost& t,
                                                 unsigned char* smem,
                                                 size_t net) {
  DeepLayer* lay = reinterpret_cast<DeepLayer*>(smem);
  T* staged = reinterpret_cast<T*>(smem + DEEP_TABLE_BYTES);
  const int L = t.n_layers;
  for (int l = 0; l < L; ++l) {
    const int din = t.dims[l], dout = t.dims[l + 1];
    const bool last = l == L - 1;
    const T* W = static_cast<const T*>(t.W[l]) + net * din * dout;
    const T* b = static_cast<const T*>(t.b[l]) + net * dout;
    if (!t.staged) {
      if (threadIdx.x == 0) lay[l] = DeepLayer{W, b, din, 1, din, dout};
      continue;
    }
    T* Ws = staged + deep_net_elems(t.dims, L, l);
    T* bs = Ws + (size_t)din * (last ? dout : dout + 1);
    if (last) {
      for (int e = threadIdx.x; e < din * dout; e += blockDim.x)
        Ws[e] = W[e];
    } else {
      for (int e = threadIdx.x; e < din * dout; e += blockDim.x) {
        const int k = e / din, i = e - k * din;
        Ws[(size_t)i * (dout + 1) + k] = W[e];
      }
    }
    for (int e = threadIdx.x; e < dout; e += blockDim.x) bs[e] = b[e];
    if (threadIdx.x == 0)
      lay[l] = last ? DeepLayer{Ws, bs, din, 1, din, dout}
                    : DeepLayer{Ws, bs, 1, dout + 1, din, dout};
  }
  __syncthreads();
  return DeepView<T>{lay, L, t.act, t.maxw};
}

// The lane's activation scratch of group g (after the table and the net).
template <typename T>
__device__ __forceinline__ T* deep_scratch(const NetTableHost& t,
                                           unsigned char* smem, int g) {
  T* s = reinterpret_cast<T*>(
      smem + DEEP_TABLE_BYTES +
      (t.staged ? deep_net_bytes<T>(t.dims, t.n_layers) : 0));
  return s + (size_t)g * 2 * t.maxw;
}

__device__ __forceinline__ void group_sync(const void* red) {
  if (red) __syncthreads();
  else __syncwarp();
}

// On return, lane s of the warp holds in acc[0] the sum over the warp's
// lanes of their acc[s]: recursive halving, each step keeping half of the
// vector and adding the partner lane's other half (16 + 8 + 4 + 2 + 1
// shuffles).
template <typename T>
__device__ __forceinline__ T warp_transpose_sum32(T* acc) {
  const int lane = threadIdx.x & (WARP - 1);
#pragma unroll
  for (int m = WARP / 2; m > 0; m >>= 1) {
    const bool upper = lane & m;
#pragma unroll
    for (int j = 0; j < m; ++j) {
      const T send = upper ? acc[j] : acc[j + m];
      const T keep = upper ? acc[j + m] : acc[j];
      acc[j] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
  }
  return acc[0];
}

// The dot products of a layer over `cur` (its din inputs, shared memory),
// warp w of the group's nw warps taking the blocks of 32 units w, w+nw,
// ...: f(k, v) on lane s for the unit k = k0 + s < dout of each block, v
// its dot product. Every lane of the warp must call it. Indices past din
// or dout read an in-bounds weight (times a zero input, or into a sum
// that no lane keeps).
template <typename T, typename F>
__device__ __forceinline__ void layer_blocks(const DeepLayer& ly,
                                             const T* cur, int nw, int w,
                                             F&& f) {
  const int s = threadIdx.x & (WARP - 1);
  const T* W = static_cast<const T*>(ly.W);
  for (int k0 = WARP * w; k0 < ly.dout; k0 += WARP * nw) {
    T acc[WARP];
#pragma unroll
    for (int u = 0; u < WARP; ++u) acc[u] = T(0);
    for (int i0 = 0; i0 < ly.din; i0 += WARP) {
      const int i = i0 + s;
      const T h = i < ly.din ? cur[i] : T(0);
      const T* wi = W + (size_t)min(i, ly.din - 1) * ly.si;
#pragma unroll
      for (int u = 0; u < WARP; ++u)
        acc[u] += wi[(size_t)min(k0 + u, ly.dout - 1) * ly.so] * h;
    }
    const T v = warp_transpose_sum32(acc);
    if (k0 + s < ly.dout) f(k0 + s, v);
  }
}

template <typename T, int NNIN>
__device__ __forceinline__ void mlp_coop(const DeepView<T>& net, const T* x,
                                         T* out, T* red, T* buf) {
  const int S = red ? (int)blockDim.x : WARP;
  const int s = red ? (int)threadIdx.x : (int)(threadIdx.x & (WARP - 1));
  const int nw = S / WARP, w = s / WARP;
  const int L = net.n;
  T* cur = buf;
  T* nxt = buf + net.maxw;
  group_sync(red);             // the group's reads of the last call are done
  {
    const DeepLayer& ly = net.lay[0];
    const T* W = static_cast<const T*>(ly.W);
    const T* b = static_cast<const T*>(ly.b);
    for (int k = s; k < ly.dout; k += S) {
      T a = T(0);
#pragma unroll
      for (int i = 0; i < NNIN; ++i)
        a += W[(size_t)k * ly.so + (size_t)i * ly.si] * x[i];
      cur[k] = activate(a + b[k], net.act);
    }
  }
  group_sync(red);
  for (int l = 1; l < L - 2; ++l) {
    const T* b = static_cast<const T*>(net.lay[l].b);
    layer_blocks(net.lay[l], cur, nw, w, [&](int k, T v) {
      nxt[k] = activate(v + b[k], net.act);
    });
    group_sync(red);
    T* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  const DeepLayer& lo = net.lay[L - 1];
  const T* bh = static_cast<const T*>(net.lay[L - 2].b);
  const T* Wo = static_cast<const T*>(lo.W);
  T acc[25];
#pragma unroll
  for (int j = 0; j < 25; ++j) acc[j] = T(0);
  layer_blocks(net.lay[L - 2], cur, nw, w, [&](int k, T v) {
    const T a = activate(v + bh[k], net.act);
#pragma unroll
    for (int j = 0; j < 25; ++j)
      acc[j] += Wo[(size_t)j * lo.so + (size_t)k * lo.si] * a;
  });
  group_sum25(acc, out, red);
}

// How a kernel holds its net: the two-layer NetView in place
// (NET_GLOBAL) or staged (NET_SMEM), or a net of any depth (NET_DEEP).
// In: the kernel's argument; View: what the lanes read.
enum NetMode { NET_GLOBAL = 0, NET_SMEM = 1, NET_DEEP = 2 };

template <typename T, int NETM>
struct NetOf {
  using In = Mlp<T>;
  using View = NetView<T, NETM == NET_SMEM>;
};
template <typename T>
struct NetOf<T, NET_DEEP> {
  using In = NetTableHost;
  using View = DeepView<T>;
};

// Sets a kernel's dynamic shared memory limit where it needs more than
// the default 48 KB; returns the CUDA error (cleared), 0 on success.
template <typename Kern>
inline int allow_smem(Kern kern, int smem) {
  if (smem <= 48 * 1024) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) {
    cudaGetLastError();   // the error is returned, not left behind
    return (int)e;
  }
  return 0;
}

// The last layer's bias b[i] (the 25 outputs).
template <typename T, bool SMEM>
__device__ __forceinline__ T out_bias(const NetView<T, SMEM>& net, int i) {
  return ldw<SMEM>(net.b2 + i);
}
template <typename T>
__device__ __forceinline__ T out_bias(const DeepView<T>& net, int i) {
  return static_cast<const T*>(net.lay[net.n - 1].b)[i];
}

// rhs_node's function, evaluated by a warp (red null) or by the whole
// block (red: mlp_coop's scratch) for one lane: every thread passes the
// same y, yh, zh, tf and gets the same dy, z. Net: a two-layer NetView, or
// a DeepView with `buf` the lane's activation scratch (2 x maxw).
template <typename T, int NNIN, typename Net>
__device__ __forceinline__ void rhs_node_coop(const RodConsts<T>& rc,
                                              const Net& net, const T* y,
                                              const T* yh, const T* zh,
                                              const T* tf, T* dy, T* z,
                                              T* red, T* buf) {
  rhs_node<T, 0>(rc, Mlp<T>{}, y, yh, zh, tf, dy, z);
  T x[NNIN], out[25];
  net_inputs<T, NNIN>(y, yh, z, zh, tf, x);
  mlp_coop<T, NNIN>(net, x, out, red, buf);
#pragma unroll
  for (int i = 0; i < 19; ++i) dy[i] += out[i] + out_bias(net, i);
#pragma unroll
  for (int i = 0; i < 6; ++i) z[i] += out[19 + i] + out_bias(net, 19 + i);
}

// One spatial step at node j with the right-hand side rhs(y, yh, zh, tf,
// dy, z): y (19) advanced in place to node j+1, z (6) the strains at node
// j. Euler, or RK4 with the linear history midpoints 0.5*(yh_j + yh_j+1)
// formed here (knode.py:80-81).
template <typename T, bool RK4, typename Rhs>
__device__ __forceinline__ void node_step(const T ds, const Rhs& rhs, T* y,
                                          const T* yh_j, const T* zh_j,
                                          const T* tf, T* z) {
  T k1[19];
  rhs(y, yh_j, zh_j, tf, k1, z);
  if constexpr (!RK4) {
#pragma unroll
    for (int i = 0; i < 19; ++i) y[i] += ds * k1[i];
  } else {
    const T* yh_j1 = yh_j + 19;   // node j+1 follows node j
    const T* zh_j1 = zh_j + 6;
    T yhm[19], zhm[6], yt[19], k[19], acc[19], zd[6];
#pragma unroll
    for (int i = 0; i < 19; ++i) yhm[i] = T(0.5) * (yh_j[i] + yh_j1[i]);
#pragma unroll
    for (int i = 0; i < 6; ++i) zhm[i] = T(0.5) * (zh_j[i] + zh_j1[i]);
#pragma unroll
    for (int i = 0; i < 19; ++i) yt[i] = y[i] + k1[i] * (ds / T(2));
    rhs(yt, yhm, zhm, tf, k, zd);                                 // k2
#pragma unroll
    for (int i = 0; i < 19; ++i) {
      acc[i] = k[i];
      yt[i] = y[i] + k[i] * (ds / T(2));
    }
    rhs(yt, yhm, zhm, tf, k, zd);                                 // k3
#pragma unroll
    for (int i = 0; i < 19; ++i) {
      acc[i] += k[i];
      yt[i] = y[i] + k[i] * ds;
    }
    rhs(yt, yh_j1, zh_j1, tf, k, zd);                             // k4
#pragma unroll
    for (int i = 0; i < 19; ++i)
      y[i] += ds * (k1[i] + T(2) * acc[i] + k[i]) / T(6);
  }
}

// node_step over the one-thread body.
template <typename T, int NNIN, bool RK4>
__device__ __forceinline__ void node_update(const RodConsts<T>& rc,
                                            const Mlp<T>& mlp, T* y,
                                            const T* yh_j, const T* zh_j,
                                            const T* tf, T* z) {
  node_step<T, RK4>(
      rc.ds,
      [&](const T* a, const T* ah, const T* azh, const T* atf, T* dy,
          T* az) { rhs_node<T, NNIN>(rc, mlp, a, ah, azh, atf, dy, az); },
      y, yh_j, zh_j, tf, z);
}

// Base node y0 = [p0, h0, G, q0, w0] (cosserat_ode.py:194).
template <typename T>
__device__ __forceinline__ void base_node(const RodConsts<T>& rc, const T* G,
                                          T* y) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    y[i] = rc.p0[i];
    y[13 + i] = rc.q0[i];
    y[16 + i] = rc.w0[i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) y[3 + i] = rc.h0[i];
#pragma unroll
  for (int i = 0; i < 6; ++i) y[7 + i] = G[i];
}

// Tip residual [F_tip - n_L, M_tip - m_L] (cosserat_ode.py:204-211).
template <typename T>
__device__ __forceinline__ void tip_residual(const RodConsts<T>& rc,
                                             const T* y, T* r) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    r[i] = rc.F_tip[i] - y[7 + i];
    r[3 + i] = rc.M_tip[i] - y[10 + i];
  }
}

// One lane's base-to-tip sweep from base reaction G (6): the tip residual
// r and, where yo is not null, the rod, y (N, 19) to yo and z (N-1, 6) to
// zo, written by the thread with `writer` set. NNIN > 0: the calling
// warp's 32 threads (red null) or the whole block (red: mlp_coop's
// scratch) run it together (rhs_node_coop), each with the same arguments,
// `buf` the lane's activation scratch when Net is a DeepView (else
// unused); NNIN == 0: one thread (rhs_node).
template <typename T, int NNIN, bool RK4, typename Net>
__device__ __forceinline__ void sweep_lane(const RodConsts<T>& rc,
                                           const Net& net, int N, const T* G,
                                           const T* yhb, const T* zhb,
                                           const T* tf, T* r, T* yo, T* zo,
                                           bool writer, T* red, T* buf) {
  T y[19], z[6];
  base_node(rc, G, y);
  if (yo && writer) {
#pragma unroll
    for (int i = 0; i < 19; ++i) yo[i] = y[i];
  }
  for (int j = 0; j < N - 1; ++j) {
    const T* yh_j = yhb + 19 * j;
    const T* zh_j = zhb + 6 * j;
    if constexpr (NNIN > 0) {
      node_step<T, RK4>(
          rc.ds,
          [&](const T* a, const T* ah, const T* azh, const T* atf, T* dy,
              T* az) {
            rhs_node_coop<T, NNIN>(rc, net, a, ah, azh, atf, dy, az, red,
                                   buf);
          },
          y, yh_j, zh_j, tf, z);
    } else {
      node_update<T, 0, RK4>(rc, Mlp<T>{}, y, yh_j, zh_j, tf, z);
    }
    if (yo && writer) {
#pragma unroll
      for (int i = 0; i < 19; ++i) yo[19 * (j + 1) + i] = y[i];
#pragma unroll
      for (int i = 0; i < 6; ++i) zo[6 * j + i] = z[i];
    }
  }
  tip_residual(rc, y, r);
}
