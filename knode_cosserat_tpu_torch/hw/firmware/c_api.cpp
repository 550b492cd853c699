// C ABI for the portable firmware core, consumed by Python via ctypes
// (knode_cosserat_tpu_torch/hw/bridge.py) for software-in-the-loop tests and
// by any host-side tooling. bridge.build_library() compiles it with
// tension_controller.cpp into build/hw_firmware/<hash>/libknode_hw.so.

#include "tension_controller.h"

extern "C" {

using knode_hw::AutoTare;
using knode_hw::PidGains;
using knode_hw::TensionController;

void* knode_hw_create(float kp, float ki, float kd) {
  PidGains g;
  if (kp > 0) g.kp = kp;
  if (ki > 0) g.ki = ki;
  if (kd > 0) g.kd = kd;
  return new TensionController(g);
}

void knode_hw_destroy(void* h) { delete (TensionController*)h; }

int knode_hw_parse_line(void* h, const char* line) {
  return ((TensionController*)h)->ParseLine(line) ? 1 : 0;
}

void knode_hw_set_setpoints(void* h, const float* sp) {
  ((TensionController*)h)->SetSetpoints(sp);
}

void knode_hw_get_setpoints(void* h, float* out) {
  ((TensionController*)h)->GetSetpoints(out);
}

void knode_hw_step(void* h, const float* readings, float dt, float* pwm_out) {
  ((TensionController*)h)->Step(readings, dt, pwm_out);
}

int knode_hw_estopped(void* h) {
  return ((TensionController*)h)->estopped() ? 1 : 0;
}

int knode_hw_telemetry(void* h, char* buf, int buflen) {
  return ((TensionController*)h)->Telemetry(buf, (size_t)buflen) ? 1 : 0;
}

void* knode_hw_tare_create() { return new AutoTare(); }
void knode_hw_tare_destroy(void* h) { delete (AutoTare*)h; }
float knode_hw_tare_step(void* h, float reading) {
  return ((AutoTare*)h)->Step(reading);
}
int knode_hw_tare_done(void* h) { return ((AutoTare*)h)->done() ? 1 : 0; }

}  // extern "C"
