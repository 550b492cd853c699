// K8: the teacher-forced next segment over B flat cells, one thread per
// cell: y_grown = y + ds * rhs(y, yh, zh, tf) with the KNODE net, and z.
//
// Replaces knode_cosserat_tpu/ops/pallas_rhs.py::make_fused_next_segment
// (the training hot op of make_train_step(use_pallas=True)). Plain version:
// knode_cosserat_tpu_torch/ops/next_segment.py::next_segment_reference
// (core/spatial.next_segment_euler on the flat cells). The per-cell body is
// K1 (rhs_rows.cuh, rhs_node<T, NNIN>) with the 2-layer net of 28 or 53
// inputs, streamed one hidden unit at a time. The TPU kernel's padding of
// B to its block and the h = 1 rows the pad needed are gone: threads past B
// return. Its ELU was exp(x) - 1 (Mosaic has no expm1); K1's is expm1.
//
// Where the H100 bounds it: B x 2 H (NNIN + 25) flops of the net (at
// B = 232, H = 512, 28 inputs: 12.6 Mflop) against ~110 KB of f32 weights
// and 72 values per cell (47 in, 25 out): at the card's rates a few
// microseconds. One thread per cell leaves B threads (232, or 1,904 at the
// train-real shape) on a card of 132 SMs, each running a serial chain of
// H (NNIN + 25) dependent FMAs, so the launch is bound by one thread's
// chain: the first target for later work (a warp per cell with the hidden
// units across its lanes, or the net as two tensor-core products over the
// cells).
#include "rhs_rows.cuh"

namespace {

template <typename T, int NNIN>
__global__ void next_segment_kernel(const RodConsts<T> rc, const Mlp<T> mlp,
                                    int B, const T* __restrict__ y,
                                    const T* __restrict__ yh,
                                    const T* __restrict__ zh,
                                    const T* __restrict__ tf,
                                    T* __restrict__ y_grown,
                                    T* __restrict__ z_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  T yl[19], dy[19], z[6], tfl[3];
#pragma unroll
  for (int i = 0; i < 19; ++i) yl[i] = y[19 * (size_t)b + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) tfl[i] = tf[3 * (size_t)b + i];
  rhs_node<T, NNIN>(rc, mlp, yl, yh + 19 * (size_t)b, zh + 6 * (size_t)b,
                    tfl, dy, z);
#pragma unroll
  for (int i = 0; i < 19; ++i)
    y_grown[19 * (size_t)b + i] = yl[i] + rc.ds * dy[i];
#pragma unroll
  for (int i = 0; i < 6; ++i) z_out[6 * (size_t)b + i] = z[i];
}

template <typename T>
int launch(int nn_in, int act, int B, const RodConstsHost* h,
           const void* W1, const void* b1, const void* W2, const void* b2,
           int hidden, const void* y, const void* yh, const void* zh,
           const void* tf, void* yg, void* z, int block,
           cudaStream_t stream) {
  const Mlp<T> mlp{(const T*)W1, (const T*)b1, (const T*)W2, (const T*)b2,
                   hidden, act};
  const RodConsts<T> rc = cast_consts<T>(*h);
  const int grid = (B + block - 1) / block;
#define K8_ARGS                                                              \
  rc, mlp, B, (const T*)y, (const T*)yh, (const T*)zh, (const T*)tf, (T*)yg, \
      (T*)z
  switch (nn_in) {
    case 28:
      next_segment_kernel<T, 28><<<grid, block, 0, stream>>>(K8_ARGS);
      return 0;
    case 53:
      next_segment_kernel<T, 53><<<grid, block, 0, stream>>>(K8_ARGS);
      return 0;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef K8_ARGS
}

}  // namespace

// C entry point (bound with ctypes in ops/_build.py). Pointers are device
// pointers of contiguous tensors of the working type: y, yh (B, 19),
// zh (B, 6), tf (B, 3) -> yg (B, 19), z (B, 6); the net (28 or 53 inputs)
// as in rhs_rows.cuh. Returns cudaGetLastError() after the launch.
extern "C" int knode_next_segment(int is_f64, int nn_in, int act, int B,
                                  const RodConstsHost* consts, const void* W1,
                                  const void* b1, const void* W2,
                                  const void* b2, int hidden, const void* y,
                                  const void* yh, const void* zh,
                                  const void* tf, void* yg, void* z,
                                  int block, void* stream) {
  if (B <= 0 || block <= 0 || !W1) return (int)cudaErrorInvalidValue;
  const int bad =
      is_f64 ? launch<double>(nn_in, act, B, consts, W1, b1, W2, b2, hidden, y,
                              yh, zh, tf, yg, z, block, (cudaStream_t)stream)
             : launch<float>(nn_in, act, B, consts, W1, b1, W2, b2, hidden, y,
                             yh, zh, tf, yg, z, block, (cudaStream_t)stream);
  if (bad) return bad;
  return (int)cudaGetLastError();
}
