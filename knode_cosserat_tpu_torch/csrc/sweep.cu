// K3: the base-to-tip spatial sweep for a batch of (rod x G-candidate)
// lanes, Euler or RK4, returning the tip residual and optionally the rod.
//
// Replaces knode_cosserat_tpu/ops/pallas_sweep.py::make_sweep_kernel
// (both of its lowerings: the static node unroll and the grid pipeline
// over nodes, which existed for Mosaic compile time). Plain version:
// knode_cosserat_tpu_torch/ops/sweep.py::sweep_reference.
//
// Design: a runtime loop over the N-1 nodes of K1 (rhs_rows.cuh), the rod
// written straight into y (B, N, 19) and z (B, N-1, 6), no padding rows.
// With the hybrid net, one block per tile of SWEEP_WARPS lanes, one warp
// per lane over rhs_node_coop: the block stages the net into shared
// memory once (or reads it from global memory where it does not fit, as
// ops/sweep.py::launch_plan decides), then each warp sweeps its lane with
// no further barrier. Physics-only, one thread per lane.
//
// Where the H100 bounds it: with the net, each lane-node reads the whole
// net from shared memory once (one load per FMA: ~860 cycles of an SM's
// shared-memory bandwidth per lane-node at hidden 512, f32), so the sweep
// is bound by shared-memory bandwidth over the SMs the tiles fill, plus
// one staging of the net per block. Physics-only, ~400 flops per node in
// registers against 25 history values read per node (a strided read:
// neighbouring lanes are N*19 values apart), latency-bound at the Newton
// loop's sizes. Left for later: a node-major history layout for coalesced
// reads, and more lanes per block to stage the net fewer times.
#include "rhs_rows.cuh"

constexpr int SWEEP_WARPS = 8;   // lanes (warps) per block with the net

// Lane b = blockIdx.x * lanes-per-block + (threadIdx.x / threads-per-lane).
template <typename T, int NNIN, bool RK4, int NETM>
__global__ void __launch_bounds__(NNIN ? SWEEP_WARPS * WARP : 32)
    sweep_kernel(const RodConsts<T> rc,
                 const typename NetOf<T, NETM>::In nin, int B, int N,
                 const T* __restrict__ G, const T* __restrict__ yh,
                 const T* __restrict__ zh, const T* __restrict__ tf,
                 T* __restrict__ res, T* __restrict__ y_out,
                 T* __restrict__ z_out) {
  constexpr int GS = NNIN ? WARP : 1;          // threads per lane
  extern __shared__ double smem_d[];
  typename NetOf<T, NETM>::View net{};
  T* buf = nullptr;
  if constexpr (NNIN > 0) {
    unsigned char* sm = reinterpret_cast<unsigned char*>(smem_d);
    if constexpr (NETM == NET_DEEP) {
      net = deep_view<T>(nin, sm, 0);
      buf = deep_scratch<T>(nin, sm, threadIdx.x / GS);
    } else {
      net = net_view<T, NNIN, NETM == NET_SMEM>(nin, (T*)smem_d);
    }
  }
  const int b = blockIdx.x * (blockDim.x / GS) + threadIdx.x / GS;
  if (b >= B) return;
  const bool writer = threadIdx.x % GS == 0;
  const T tfb[3] = {tf[3 * b], tf[3 * b + 1], tf[3 * b + 2]};
  T Gb[6], r[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) Gb[i] = G[6 * (size_t)b + i];
  sweep_lane<T, NNIN, RK4>(
      rc, net, N, Gb, yh + (size_t)b * N * 19, zh + (size_t)b * N * 6, tfb,
      r, y_out ? y_out + (size_t)b * N * 19 : nullptr,
      z_out ? z_out + (size_t)b * (N - 1) * 6 : nullptr, writer, nullptr,
      buf);
  if (writer) {
#pragma unroll
    for (int i = 0; i < 6; ++i) res[6 * (size_t)b + i] = r[i];
  }
}

template <typename T, int NNIN, bool RK4>
static int launch(const RodConstsHost* h, const Mlp<T>& mlp,
                  const NetTableHost* deep, int B, int N, const void* G,
                  const void* yh, const void* zh, const void* tf, void* res,
                  void* y, void* z, int threads, int smem, int staged,
                  cudaStream_t stream) {
  constexpr int want = NNIN ? SWEEP_WARPS * WARP : 32;
  const int lanes = NNIN ? SWEEP_WARPS : threads;
  if (threads != want || (staged && !NNIN)) return (int)cudaErrorInvalidValue;
  const int grid = (B + lanes - 1) / lanes;
  if constexpr (NNIN > 0) {
    if (deep) {           // a net of three layers or more
      if ((size_t)smem != deep_smem_bytes<T>(*deep, SWEEP_WARPS) ||
          staged != deep->staged)
        return (int)cudaErrorInvalidValue;
      auto kern = sweep_kernel<T, NNIN, RK4, NET_DEEP>;
      if (const int e = allow_smem(kern, smem)) return e;
      kern<<<grid, threads, smem, stream>>>(
          cast_consts<T>(*h), *deep, B, N, (const T*)G, (const T*)yh,
          (const T*)zh, (const T*)tf, (T*)res, (T*)y, (T*)z);
      return 0;
    }
  }
  const size_t need = staged ? net_smem_bytes<T>(NNIN, mlp.hidden) : 0;
  if ((size_t)smem != need) return (int)cudaErrorInvalidValue;
  void (*kern)(const RodConsts<T>, const Mlp<T>, int, int, const T*,
               const T*, const T*, const T*, T*, T*, T*) =
      sweep_kernel<T, NNIN, RK4, NET_GLOBAL>;
  if constexpr (NNIN > 0) {
    if (staged) kern = sweep_kernel<T, NNIN, RK4, NET_SMEM>;
  }
  if (const int e = allow_smem(kern, smem)) return e;
  kern<<<grid, threads, smem, stream>>>(
      cast_consts<T>(*h), mlp, B, N, (const T*)G, (const T*)yh,
      (const T*)zh, (const T*)tf, (T*)res, (T*)y, (T*)z);
  return 0;
}

template <typename T, int NNIN>
static int launch_m(int rk4, const RodConstsHost* h, const Mlp<T>& mlp,
                    const NetTableHost* deep, int B, int N, const void* G,
                    const void* yh, const void* zh, const void* tf, void* res,
                    void* y, void* z, int threads, int smem, int staged,
                    cudaStream_t stream) {
  return rk4 ? launch<T, NNIN, true>(h, mlp, deep, B, N, G, yh, zh, tf, res,
                                     y, z, threads, smem, staged, stream)
             : launch<T, NNIN, false>(h, mlp, deep, B, N, G, yh, zh, tf, res,
                                      y, z, threads, smem, staged, stream);
}

template <typename T>
static int launch_t(int nn_in, int rk4, const RodConstsHost* h,
                    const void* W1, const void* b1, const void* W2,
                    const void* b2, int hidden, int act,
                    const NetTableHost* deep, int B, int N, const void* G,
                    const void* yh, const void* zh, const void* tf, void* res,
                    void* y, void* z, int threads, int smem, int staged,
                    cudaStream_t stream) {
  const Mlp<T> mlp{(const T*)W1, (const T*)b1, (const T*)W2, (const T*)b2,
                   hidden, act};
  switch (nn_in) {
    case 0:
      return launch_m<T, 0>(rk4, h, mlp, nullptr, B, N, G, yh, zh, tf, res,
                            y, z, threads, smem, staged, stream);
    case 28:
      return launch_m<T, 28>(rk4, h, mlp, deep, B, N, G, yh, zh, tf, res, y,
                             z, threads, smem, staged, stream);
    case 53:
      return launch_m<T, 53>(rk4, h, mlp, deep, B, N, G, yh, zh, tf, res, y,
                             z, threads, smem, staged, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// C entry point (bound with ctypes in ops/_build.py). Pointers are device
// pointers of contiguous tensors; y and z may be null (residual only).
// A two-layer net comes as W1, b1, W2, b2 and hidden with `deep` null; a
// net of three layers or more as the layer table `deep` (a host pointer;
// W1 .. b2 unused). threads, smem and staged come from
// ops/sweep.py::launch_plan and are checked against the kernel's own
// shape. Returns the first CUDA error of the shared-memory attribute or
// the launch, 0 on success.
extern "C" int knode_sweep(int is_f64, int nn_in, int act, int rk4, int B,
                           int N, const RodConstsHost* consts, const void* G,
                           const void* yh, const void* zh, const void* tf,
                           const void* W1, const void* b1, const void* W2,
                           const void* b2, int hidden,
                           const NetTableHost* deep, void* res, void* y,
                           void* z, int threads, int smem, int staged,
                           void* stream) {
  if (B <= 0 || N < 2 || (y != nullptr) != (z != nullptr) ||
      (nn_in && !deep && (!W1 || hidden <= 0)) ||
      (deep && !deep_table_ok(*deep, nn_in)))
    return (int)cudaErrorInvalidValue;
  const int bad =
      is_f64 ? launch_t<double>(nn_in, rk4, consts, W1, b1, W2, b2, hidden,
                                act, deep, B, N, G, yh, zh, tf, res, y, z,
                                threads, smem, staged, (cudaStream_t)stream)
             : launch_t<float>(nn_in, rk4, consts, W1, b1, W2, b2, hidden,
                               act, deep, B, N, G, yh, zh, tf, res, y, z,
                               threads, smem, staged, (cudaStream_t)stream);
  if (bad) return bad;
  return (int)cudaGetLastError();
}
