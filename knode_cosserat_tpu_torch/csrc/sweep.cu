// K3: the base-to-tip spatial sweep for a batch of (rod x G-candidate)
// lanes, Euler or RK4, returning the tip residual and optionally the rod.
//
// Replaces knode_cosserat_tpu/ops/pallas_sweep.py::make_sweep_kernel
// (both of its lowerings: the static node unroll and the grid pipeline
// over nodes, which existed for Mosaic compile time). Plain version:
// knode_cosserat_tpu_torch/ops/sweep.py::sweep_reference.
//
// Design: one thread per lane, the 19-state in registers, a runtime loop
// over the N-1 nodes calling K1 (rhs_rows.cuh). The rod is written
// straight into y (B, N, 19) and z (B, N-1, 6): no padding rows.
//
// Where the H100 bounds it: per lane a sweep is (N-1) x (1 or 4) K1 calls;
// physics-only that is ~300 flops per call on data that stays in
// registers, reading 25 history values per node from device memory (a
// strided, uncoalesced read per thread: neighbouring lanes are N*19 values
// apart). With the MLP it is ~54 kflop per call at hidden 512, issue- and
// load-latency bound in one thread (see rhs_rows.cuh). At the Newton
// loop's sizes (256 rods x 6 probes or 7 candidates = 1,536-1,792 lanes) the
// launch fills 48-56 warps of the card's 132 x 64: the card is mostly
// idle, and the sweep's time is one thread's serial chain of K1 calls.
// Later mappings: a warp per lane with the MLP's hidden units across its
// threads, and a node-major history layout for coalesced reads.
#include "rhs_rows.cuh"

template <typename T, int NNIN, bool RK4>
__global__ void sweep_kernel(const RodConsts<T> rc, const Mlp<T> mlp, int B,
                             int N, const T* __restrict__ G,
                             const T* __restrict__ yh,
                             const T* __restrict__ zh,
                             const T* __restrict__ tf, T* __restrict__ res,
                             T* __restrict__ y_out, T* __restrict__ z_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const T* yhb = yh + (size_t)b * N * 19;
  const T* zhb = zh + (size_t)b * N * 6;
  T tfb[3] = {tf[3 * b], tf[3 * b + 1], tf[3 * b + 2]};
  T y[19], z[6];
  base_node(rc, G + 6 * (size_t)b, y);
  if (y_out) {
#pragma unroll
    for (int i = 0; i < 19; ++i) y_out[(size_t)b * N * 19 + i] = y[i];
  }
  for (int j = 0; j < N - 1; ++j) {
    node_update<T, NNIN, RK4>(rc, mlp, y, yhb + 19 * j, zhb + 6 * j, tfb, z);
    if (y_out) {
      T* yo = y_out + ((size_t)b * N + j + 1) * 19;
      T* zo = z_out + ((size_t)b * (N - 1) + j) * 6;
#pragma unroll
      for (int i = 0; i < 19; ++i) yo[i] = y[i];
#pragma unroll
      for (int i = 0; i < 6; ++i) zo[i] = z[i];
    }
  }
  T r[6];
  tip_residual(rc, y, r);
#pragma unroll
  for (int i = 0; i < 6; ++i) res[6 * (size_t)b + i] = r[i];
}

template <typename T, int NNIN, bool RK4>
static void launch(const RodConstsHost* h, const void* W1, const void* b1,
                   const void* W2, const void* b2, int hidden, int act, int B,
                   int N, const void* G, const void* yh, const void* zh,
                   const void* tf, void* res, void* y, void* z, int block,
                   cudaStream_t stream) {
  const Mlp<T> mlp{(const T*)W1, (const T*)b1, (const T*)W2, (const T*)b2,
                   hidden, act};
  const int grid = (B + block - 1) / block;
  sweep_kernel<T, NNIN, RK4><<<grid, block, 0, stream>>>(
      cast_consts<T>(*h), mlp, B, N, (const T*)G, (const T*)yh,
      (const T*)zh, (const T*)tf, (T*)res, (T*)y, (T*)z);
}

template <typename T, int NNIN>
static void launch_m(int rk4, const RodConstsHost* h, const void* W1,
                     const void* b1, const void* W2, const void* b2,
                     int hidden, int act, int B, int N, const void* G,
                     const void* yh, const void* zh, const void* tf,
                     void* res, void* y, void* z, int block,
                     cudaStream_t stream) {
  if (rk4)
    launch<T, NNIN, true>(h, W1, b1, W2, b2, hidden, act, B, N, G, yh, zh,
                          tf, res, y, z, block, stream);
  else
    launch<T, NNIN, false>(h, W1, b1, W2, b2, hidden, act, B, N, G, yh, zh,
                           tf, res, y, z, block, stream);
}

template <typename T>
static int launch_t(int nn_in, int rk4, const RodConstsHost* h,
                    const void* W1, const void* b1, const void* W2,
                    const void* b2, int hidden, int act, int B, int N,
                    const void* G, const void* yh, const void* zh,
                    const void* tf, void* res, void* y, void* z, int block,
                    cudaStream_t stream) {
  switch (nn_in) {
    case 0:
      launch_m<T, 0>(rk4, h, W1, b1, W2, b2, hidden, act, B, N, G, yh, zh,
                     tf, res, y, z, block, stream);
      return 0;
    case 28:
      launch_m<T, 28>(rk4, h, W1, b1, W2, b2, hidden, act, B, N, G, yh, zh,
                      tf, res, y, z, block, stream);
      return 0;
    case 53:
      launch_m<T, 53>(rk4, h, W1, b1, W2, b2, hidden, act, B, N, G, yh, zh,
                      tf, res, y, z, block, stream);
      return 0;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// C entry point (bound with ctypes in ops/_build.py). Pointers are device
// pointers of contiguous tensors; y and z may be null (residual only).
// Returns cudaGetLastError() after the launch.
extern "C" int knode_sweep(int is_f64, int nn_in, int act, int rk4, int B,
                           int N, const RodConstsHost* consts, const void* G,
                           const void* yh, const void* zh, const void* tf,
                           const void* W1, const void* b1, const void* W2,
                           const void* b2, int hidden, void* res, void* y,
                           void* z, int block, void* stream) {
  if (B <= 0 || N < 2 || block <= 0 || (nn_in && !W1) || (y != nullptr) != (z != nullptr))
    return (int)cudaErrorInvalidValue;
  const int bad =
      is_f64 ? launch_t<double>(nn_in, rk4, consts, W1, b1, W2, b2, hidden,
                                act, B, N, G, yh, zh, tf, res, y, z, block,
                                (cudaStream_t)stream)
             : launch_t<float>(nn_in, rk4, consts, W1, b1, W2, b2, hidden,
                               act, B, N, G, yh, zh, tf, res, y, z, block,
                               (cudaStream_t)stream);
  if (bad) return bad;
  return (int)cudaGetLastError();
}
