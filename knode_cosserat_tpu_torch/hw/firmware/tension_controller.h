// Portable tension-control firmware core.
//
// Re-implementation of the reference Arduino firmware's control logic
// (reference: firmware/firmware.ino, TensionMotor.{h,cpp},
// AnalogLoadCell.{h,cpp}) as hardware-independent C++: the PID loop with
// integral anti-windup, the >MAX_TENSION emergency stop (reverse-pulse then
// halt forever), the two-phase auto-tare sequence, the "T1 T2 T3 T4\n"
// serial setpoint protocol (grams) and the CSV telemetry line. The Arduino
// sketch becomes a thin shim that feeds analogRead values in and PWM values
// out; host builds compile this file directly for tests and
// software-in-the-loop simulation (see c_api.cpp / bridge.py).

#pragma once

#include <cstddef>

namespace knode_hw {

struct PidGains {
  // firmware.ino:11-22
  float kp = 0.1512f * 3.0f;
  float ki = 0.005f;
  float kd = 0.001f;
};

constexpr int kNumMotors = 4;
constexpr float kMaxTensionGrams = 2300.0f;  // firmware.ino:8
constexpr float kEstopReversePwm = -0.4f;    // firmware.ino:105
constexpr float kEstopReverseSeconds = 0.5f; // firmware.ino:106
constexpr float kDefaultSetpoint = 300.0f;   // firmware.ino:63
constexpr int kTelemetryEvery = 10;          // firmware.ino:6

// Calibrated analog load cell: reading = (raw - offset) * scale
// (AnalogLoadCell.cpp:3-17).
class LoadCellCal {
 public:
  void set_scale(float scale) { scale_ = scale; }
  void tare(float raw) { offset_ = raw; }
  float convert(float raw) const { return (raw - offset_) * scale_; }

 private:
  float scale_ = 1.0f;
  float offset_ = 0.0f;
};

// Four-channel tension PID with e-stop; step() maps (readings[g], dt[s]) ->
// pwm[-1, 1] per motor (firmware.ino:94-133).
class TensionController {
 public:
  explicit TensionController(const PidGains& gains = PidGains());

  // Parse a "T1 T2 T3 T4" setpoint line in grams (firmware.ino:76-92).
  // Returns true when the line was a valid 4-int command.
  bool ParseLine(const char* line);

  void SetSetpoints(const float setpoints[kNumMotors]);
  void GetSetpoints(float out[kNumMotors]) const;

  // One control iteration. readings are calibrated grams.
  void Step(const float readings[kNumMotors], float dt,
            float pwm_out[kNumMotors]);

  bool estopped() const { return estop_state_ != EstopState::kRunning; }

  // CSV telemetry: "r0,r1,r2,r3,o0,o1,o2,o3,avg_dt_ms" emitted every
  // kTelemetryEvery iterations (firmware.ino:98-137). Returns false when
  // this iteration is not a printing one.
  bool Telemetry(char* buf, size_t buflen);

 private:
  enum class EstopState { kRunning, kReversing, kHalted };

  PidGains gains_;
  float setpoints_[kNumMotors];
  float previous_errors_[kNumMotors] = {0, 0, 0, 0};
  float integrated_errors_[kNumMotors] = {0, 0, 0, 0};
  float last_readings_[kNumMotors] = {0, 0, 0, 0};
  float last_outputs_[kNumMotors] = {0, 0, 0, 0};
  EstopState estop_state_ = EstopState::kRunning;
  float estop_timer_ = 0.0f;
  unsigned long counter_ = 0;
  float accum_dt_ = 0.0f;
};

// Two-phase auto-tare state machine (TensionMotor.cpp:13-57): drive +0.2
// until the reading jumps by more than +30 g (tension engaged), then back
// off at -0.1 until successive readings change by less than 5 g.
class AutoTare {
 public:
  // Feed the current reading; returns the pwm to apply. done() flips when
  // the sequence completes (pwm 0 from then on).
  float Step(float reading);
  bool done() const { return phase_ == Phase::kDone; }

 private:
  enum class Phase { kTensionUp, kBackOff, kDone };
  Phase phase_ = Phase::kTensionUp;
  bool have_prev_ = false;
  float previous_value_ = 0.0f;
};

// Clamp a [-1, 1] speed like TensionMotor::writePWM (TensionMotor.cpp:69-87).
float ClampPwm(float speed);

}  // namespace knode_hw
