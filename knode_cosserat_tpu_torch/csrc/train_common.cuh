// Device code shared by the training kernels: K4 / K5 (train.cu) and K6
// (train_wide.cu). The loss of one cell and its cotangent through the
// reference's quaternion->Euler map, the Adam(W) update of one parameter
// (training/train.py:AdamPlateau's order of operations), the ELU and its
// derivative, a float4's i-th lane and a warp sum.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

constexpr int kOut = 25;

// Adam's constants and this epoch's step, as AdamPlateau computes them.
struct AdamStep {
  float b1, omb1, b2, omb2, eps, bc1, bc2, neg_lr, scale, wd;
  bool clamp;
};

// One parameter's Adam(W) update; its moments are updated in place.
__device__ __forceinline__ float adam_update(float P, float g, float* mu_p,
                                             float* nu_p, const AdamStep& s,
                                             bool is_weight) {
  const float mu = s.omb1 * g + s.b1 * (*mu_p);
  const float nu = s.omb2 * (g * g) + s.b2 * (*nu_p);
  *mu_p = mu;
  *nu_p = nu;
  float u = (mu / s.bc1) / (sqrtf(nu / s.bc2) + s.eps);
  if (s.wd != 0.f) u = u + s.wd * P;
  u = u * s.neg_lr;
  u = u * s.scale;
  P = P + u;
  return (is_weight && s.clamp) ? fmaxf(P, 0.f) : P;
}

__device__ __forceinline__ float elu(float a) {
  return a > 0.f ? a : expm1f(a);
}

// d elu / d a from the activation h = elu(a): 1 above 0, else h + 1
__device__ __forceinline__ float elu_grad(float h) {
  return h > 0.f ? 1.f : h + 1.f;
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Loss of one cell and its cotangent g = dL/dNN (25) given the cell's net
// output nn (25). The Euler map and its derivative follow
// pallas_train.py::_euler_forward / _euler_backward.
__device__ float cell_loss(const float* nn, const float* yb, const float* zp,
                           const float* ty, const float* tz, const float* te,
                           float ds, const float* inv, float* g) {
  float yg[19];
#pragma unroll
  for (int i = 0; i < 19; ++i) yg[i] = yb[i] + ds * nn[i];
  float sp = 0.f, ss = 0.f, sz = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float d = yg[i] - ty[i];
    sp += d * d;
    g[i] = 2.f * ds * inv[0] * d;
  }
#pragma unroll
  for (int i = 7; i < 19; ++i) {
    const float d = yg[i] - ty[i];
    ss += d * d;
    g[i] = 2.f * ds * inv[1] * d;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float d = zp[i] + nn[19 + i] - tz[i];
    sz += d * d;
    g[19 + i] = 2.f * inv[3] * d;
  }
  // Euler angles of the normalized quaternion, the reference's convention;
  // the floor keeps a zero quaternion finite
  const float qw = yg[3], qx = yg[4], qy = yg[5], qz = yg[6];
  const float s = rsqrtf(fmaxf(qw * qw + qx * qx + qy * qy + qz * qz, 1e-30f));
  const float w = qw * s, x = qx * s, y = qy * s, z = qz * s;
  const float A = 2.f * (w * y + x * z), B = 1.f - 2.f * (y * y + z * z);
  const float Cv = 2.f * (w * z - x * y);
  const float Cc = fminf(fmaxf(Cv, -1.f), 1.f);
  const float D = 2.f * (w * x + y * z), E = 1.f - 2.f * (x * x + z * z);
  const float de0 = atan2f(A, B) - te[0];
  const float de1 = asinf(Cc) - te[1];
  const float de2 = atan2f(D, E) - te[2];
  const float se = de0 * de0 + de1 * de1 + de2 * de2;
  // backward: roll = atan2(A, B), pitch = asin(clip(C)) (no gradient
  // outside the clip), yaw = atan2(D, E)
  const float rden = 2.f * inv[2] * de0 / (A * A + B * B);
  const float cA = B * rden, cB = -A * rden;
  const float pden = fabsf(Cv) < 1.f
      ? 2.f * inv[2] * de1 * rsqrtf(fmaxf(1.f - Cc * Cc, 1e-30f)) : 0.f;
  const float yden = 2.f * inv[2] * de2 / (D * D + E * E);
  const float cD = E * yden, cE = -D * yden;
  const float dw = cA * 2.f * y + pden * 2.f * z + cD * 2.f * x;
  const float dx = cA * 2.f * z - pden * 2.f * y + cD * 2.f * w + cE * (-4.f * x);
  const float dy = cA * 2.f * w + cB * (-4.f * y) - pden * 2.f * x + cD * 2.f * z;
  const float dz = cA * 2.f * x + cB * (-4.f * z) + pden * 2.f * w + cD * 2.f * y
                   + cE * (-4.f * z);
  // through the normalization: dq = s (I - hn hn^T) dhn
  const float dot = w * dw + x * dx + y * dy + z * dz;
  g[3] = ds * s * (dw - w * dot);
  g[4] = ds * s * (dx - x * dot);
  g[5] = ds * s * (dy - y * dot);
  g[6] = ds * s * (dz - z * dot);
  return sp * inv[0] + ss * inv[1] + se * inv[2] + sz * inv[3];
}

// Adam's bias corrections 1 - beta^t for step t (the Adam count after the
// step), as AdamPlateau computes them: two double-precision powers, a long
// dependent chain, which the kernels take off their epoch's critical path.
__device__ __forceinline__ float bias_correction(double beta, double t) {
  return (float)(1.0 - pow(beta, t));
}

__device__ __forceinline__ float2 bias_corrections(double t) {
  return make_float2(bias_correction(0.9, t), bias_correction(0.999, t));
}

// Adam's step constants for bias corrections ``bc`` at plateau scale
// ``scale``.
__device__ __forceinline__ AdamStep adam_step(float2 bc, double scale,
                                              double lr, double wd,
                                              int clamp) {
  return AdamStep{0.9f, (float)(1.0 - 0.9), 0.999f, (float)(1.0 - 0.999),
                  1e-8f, bc.x, bc.y, (float)(-lr), (float)scale, (float)wd,
                  clamp != 0};
}

// reduce_on_plateau on this epoch's loss L (rtol, atol = 0, cooldown = 0);
// the comparison runs in double, as the plain version's on Python floats.
__device__ __forceinline__ void plateau_step(float L, double rtol,
                                             int patience, double factor,
                                             float& best, int& pcount,
                                             double& scale) {
  const bool improved = (double)L < (1.0 - rtol) * (double)best;
  if (improved) best = L;
  int cnt = improved ? 0 : pcount + 1;
  if (cnt == patience) {
    scale = fmax(scale * factor, 0.0);
    cnt = 0;
  }
  pcount = cnt;
}
