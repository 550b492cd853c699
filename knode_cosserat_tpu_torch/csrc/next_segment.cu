// K8: the teacher-forced next segment over B flat cells, one warp per
// cell: y_grown = y + ds * rhs(y, yh, zh, tf) with the KNODE net, and z.
//
// Replaces knode_cosserat_tpu/ops/pallas_rhs.py::make_fused_next_segment
// (the training hot op of make_train_step(use_pallas=True)). Plain version:
// knode_cosserat_tpu_torch/ops/next_segment.py::next_segment_reference
// (core/spatial.next_segment_euler on the flat cells). The TPU kernel's
// padding of B to its block and the h = 1 rows the pad needed are gone.
// Its ELU was exp(x) - 1 (Mosaic has no expm1); K1's is expm1.
//
// Design: K3's hybrid mapping (sweep.cu) with a single node per lane. A
// block of C warps (C from B: ops/next_segment.py::launch_plan) stages the
// net once into shared memory with cp.async, in rhs_rows.cuh's layout
// (stage_net's: W1 transposed to (NNIN, H+1), b1, W2, b2), where it fits;
// otherwise (float64 with 53 inputs at hidden 512) each thread reads its
// units' weights from global memory through the read-only path. Then each
// warp takes cells b = blockIdx.x C + warp, + gridDim.x C, ... and runs
// K1's cooperative body rhs_node_coop on each: every thread runs the
// physics itself, thread s computes hidden units s, s+32, ..., and a
// butterfly of shuffles sums the 25 outputs in an order fixed by H and the
// warp alone, so a cell's bits do not depend on B, C, the grid or the
// cell's place in the batch.
//
// Where the H100 bounds it: B x 2 H (NNIN + 25) flops of the net (at
// B = 232, H = 512, 28 inputs: 12.6 Mflop) against ~110 KB of f32 weights
// and 72 values per cell (47 in, 25 out): a few microseconds at the card's
// rates. The cells of a block read the whole staged net once each, one
// shared-memory load per FMA (110.7 KB a cell at H = 512, f32), and each
// block first stages the net from L2. The staging sets the time: at 232
// cells 8 cells a block (29 blocks) took 0.0118 ms, 2 (116 blocks) 0.0177
// and 1 (132 blocks, two rounds) 0.0340; the same staging as plain loads
// and stores (stage_net) 0.0257 (H100, PERF.md). So the plan gives
// each block as many cells as it can, and the copies go through cp.async.
#include <cuda_pipeline.h>

#include "rhs_rows.cuh"

namespace {

constexpr int kMaxWarps = 8;    // cells a block runs at once

// stage_net's layout and result, the copies made as cp.async (one
// element each: W1's transpose scatters them) and waited for together.
template <typename T, int NNIN>
__device__ __forceinline__ NetView<T, true> stage_net_async(const Mlp<T>& m,
                                                            T* s) {
  const int H = m.hidden, ld = H + 1;
  T* W1t = s;
  T* b1 = W1t + (size_t)NNIN * ld;
  T* W2 = b1 + H;
  T* b2 = W2 + (size_t)25 * H;
  for (int e = threadIdx.x; e < H * NNIN; e += blockDim.x) {
    const int k = e / NNIN, i = e - k * NNIN;
    __pipeline_memcpy_async(W1t + (size_t)i * ld + k, m.W1 + e, sizeof(T));
  }
  for (int e = threadIdx.x; e < H; e += blockDim.x)
    __pipeline_memcpy_async(b1 + e, m.b1 + e, sizeof(T));
  for (int e = threadIdx.x; e < 25 * H; e += blockDim.x)
    __pipeline_memcpy_async(W2 + e, m.W2 + e, sizeof(T));
  for (int e = threadIdx.x; e < 25; e += blockDim.x)
    __pipeline_memcpy_async(b2 + e, m.b2 + e, sizeof(T));
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  return NetView<T, true>{W1t, b1, W2, b2, H, m.act};
}

template <typename T, int NNIN, int NETM>
__global__ void __launch_bounds__(kMaxWarps * WARP)
    next_segment_kernel(const RodConsts<T> rc,
                        const typename NetOf<T, NETM>::In nin, int B,
                        const T* __restrict__ y, const T* __restrict__ yh,
                        const T* __restrict__ zh, const T* __restrict__ tf,
                        T* __restrict__ y_grown, T* __restrict__ z_out) {
  extern __shared__ double smem_d[];
  typename NetOf<T, NETM>::View net{};
  T* buf = nullptr;
  if constexpr (NETM == NET_DEEP) {
    unsigned char* sm = reinterpret_cast<unsigned char*>(smem_d);
    net = deep_view<T>(nin, sm, 0);
    buf = deep_scratch<T>(nin, sm, threadIdx.x / WARP);
  } else if constexpr (NETM == NET_SMEM) {
    net = stage_net_async<T, NNIN>(nin, (T*)smem_d);
  } else {
    net = NetView<T, false>{nin.W1, nin.b1, nin.W2, nin.b2, nin.hidden,
                            nin.act};
  }
  const int C = blockDim.x / WARP;
  const bool writer = threadIdx.x % WARP == 0;
  for (int b = blockIdx.x * C + threadIdx.x / WARP; b < B;
       b += gridDim.x * C) {
    T yl[19], dy[19], z[6], tfl[3];
#pragma unroll
    for (int i = 0; i < 19; ++i) yl[i] = y[19 * (size_t)b + i];
#pragma unroll
    for (int i = 0; i < 3; ++i) tfl[i] = tf[3 * (size_t)b + i];
    rhs_node_coop<T, NNIN>(rc, net, yl, yh + 19 * (size_t)b,
                           zh + 6 * (size_t)b, tfl, dy, z, nullptr, buf);
    if (writer) {
#pragma unroll
      for (int i = 0; i < 19; ++i)
        y_grown[19 * (size_t)b + i] = yl[i] + rc.ds * dy[i];
#pragma unroll
      for (int i = 0; i < 6; ++i) z_out[6 * (size_t)b + i] = z[i];
    }
  }
}

template <typename T, int NNIN>
int launch(const RodConstsHost* h, const Mlp<T>& mlp,
           const NetTableHost* deep, int B, const void* y, const void* yh,
           const void* zh, const void* tf, void* yg, void* z, int threads,
           int blocks, int smem, int staged, cudaStream_t stream) {
  if (threads % WARP || threads > kMaxWarps * WARP || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  if (deep) {             // a net of three layers or more
    if ((size_t)smem != deep_smem_bytes<T>(*deep, threads / WARP) ||
        staged != deep->staged)
      return (int)cudaErrorInvalidValue;
    auto kern = next_segment_kernel<T, NNIN, NET_DEEP>;
    if (const int e = allow_smem(kern, smem)) return e;
    kern<<<blocks, threads, smem, stream>>>(
        cast_consts<T>(*h), *deep, B, (const T*)y, (const T*)yh,
        (const T*)zh, (const T*)tf, (T*)yg, (T*)z);
    return 0;
  }
  const size_t need = staged ? net_smem_bytes<T>(NNIN, mlp.hidden) : 0;
  if ((size_t)smem != need) return (int)cudaErrorInvalidValue;
  void (*kern)(const RodConsts<T>, const Mlp<T>, int, const T*, const T*,
               const T*, const T*, T*, T*) =
      staged ? next_segment_kernel<T, NNIN, NET_SMEM>
             : next_segment_kernel<T, NNIN, NET_GLOBAL>;
  if (const int e = allow_smem(kern, smem)) return e;
  kern<<<blocks, threads, smem, stream>>>(
      cast_consts<T>(*h), mlp, B, (const T*)y, (const T*)yh, (const T*)zh,
      (const T*)tf, (T*)yg, (T*)z);
  return 0;
}

template <typename T>
int launch_t(int nn_in, int act, int B, const RodConstsHost* h,
             const void* W1, const void* b1, const void* W2, const void* b2,
             int hidden, const NetTableHost* deep, const void* y,
             const void* yh, const void* zh, const void* tf, void* yg,
             void* z, int threads, int blocks, int smem, int staged,
             cudaStream_t stream) {
  const Mlp<T> mlp{(const T*)W1, (const T*)b1, (const T*)W2, (const T*)b2,
                   hidden, act};
  switch (nn_in) {
    case 28:
      return launch<T, 28>(h, mlp, deep, B, y, yh, zh, tf, yg, z, threads,
                           blocks, smem, staged, stream);
    case 53:
      return launch<T, 53>(h, mlp, deep, B, y, yh, zh, tf, yg, z, threads,
                           blocks, smem, staged, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point (bound with ctypes in ops/_build.py). Pointers are device
// pointers of contiguous tensors of the working type: y, yh (B, 19),
// zh (B, 6), tf (B, 3) -> yg (B, 19), z (B, 6); the net (28 or 53 inputs)
// as in rhs_rows.cuh: two layers as W1, b1, W2, b2 and hidden with `deep`
// null, three or more as the layer table `deep` (a host pointer). threads,
// blocks, smem and staged come from ops/next_segment.py::launch_plan and
// are checked against the kernel's own shape. Returns the first CUDA
// error of the shared-memory attribute or the launch, 0 on success.
extern "C" int knode_next_segment(int is_f64, int nn_in, int act, int B,
                                  const RodConstsHost* consts, const void* W1,
                                  const void* b1, const void* W2,
                                  const void* b2, int hidden,
                                  const NetTableHost* deep, const void* y,
                                  const void* yh, const void* zh,
                                  const void* tf, void* yg, void* z,
                                  int threads, int blocks, int smem,
                                  int staged, void* stream) {
  if (B <= 0 || (deep ? !deep_table_ok(*deep, nn_in)
                      : (hidden <= 0 || !W1)))
    return (int)cudaErrorInvalidValue;
  const int bad =
      is_f64 ? launch_t<double>(nn_in, act, B, consts, W1, b1, W2, b2, hidden,
                                deep, y, yh, zh, tf, yg, z, threads, blocks,
                                smem, staged, (cudaStream_t)stream)
             : launch_t<float>(nn_in, act, B, consts, W1, b1, W2, b2, hidden,
                               deep, y, yh, zh, tf, yg, z, threads, blocks,
                               smem, staged, (cudaStream_t)stream);
  if (bad) return bad;
  return (int)cudaGetLastError();
}
