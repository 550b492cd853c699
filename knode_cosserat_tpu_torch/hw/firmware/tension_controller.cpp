#include "tension_controller.h"

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace knode_hw {

float ClampPwm(float speed) {
  if (speed < -1.0f) return -1.0f;
  if (speed > 1.0f) return 1.0f;
  return speed;
}

TensionController::TensionController(const PidGains& gains) : gains_(gains) {
  for (int i = 0; i < kNumMotors; ++i) setpoints_[i] = kDefaultSetpoint;
}

bool TensionController::ParseLine(const char* line) {
  // firmware.ino:76-92 splits on three spaces and toInt()s each token.
  long v[kNumMotors];
  char* end = nullptr;
  const char* p = line;
  for (int i = 0; i < kNumMotors; ++i) {
    v[i] = std::strtol(p, &end, 10);
    if (end == p) return false;  // no digits
    p = end;
  }
  for (int i = 0; i < kNumMotors; ++i) setpoints_[i] = (float)v[i];
  return true;
}

void TensionController::SetSetpoints(const float setpoints[kNumMotors]) {
  for (int i = 0; i < kNumMotors; ++i) setpoints_[i] = setpoints[i];
}

void TensionController::GetSetpoints(float out[kNumMotors]) const {
  for (int i = 0; i < kNumMotors; ++i) out[i] = setpoints_[i];
}

void TensionController::Step(const float readings[kNumMotors], float dt,
                             float pwm_out[kNumMotors]) {
  ++counter_;
  accum_dt_ += dt;
  for (int i = 0; i < kNumMotors; ++i) last_readings_[i] = readings[i];

  // Emergency stop: any channel above the limit releases tension on all
  // motors for kEstopReverseSeconds, then halts forever (firmware.ino:
  // 102-110; the reference blocks in delay(500) — here the reverse phase is
  // timed through dt so the loop stays non-blocking).
  if (estop_state_ == EstopState::kRunning) {
    for (int i = 0; i < kNumMotors; ++i) {
      if (readings[i] > kMaxTensionGrams) {
        estop_state_ = EstopState::kReversing;
        estop_timer_ = 0.0f;
        break;
      }
    }
  }
  if (estop_state_ != EstopState::kRunning) {
    if (estop_state_ == EstopState::kReversing) {
      estop_timer_ += dt;
      if (estop_timer_ >= kEstopReverseSeconds)
        estop_state_ = EstopState::kHalted;
    }
    const float pwm =
        estop_state_ == EstopState::kReversing ? kEstopReversePwm : 0.0f;
    for (int i = 0; i < kNumMotors; ++i) {
      pwm_out[i] = pwm;
      last_outputs_[i] = pwm * 255.0f;
    }
    return;
  }

  // PID per motor (firmware.ino:113-133).
  for (int i = 0; i < kNumMotors; ++i) {
    const float error = setpoints_[i] - readings[i];
    const float error_derivative =
        dt > 0.0f ? (error - previous_errors_[i]) / dt : 0.0f;
    integrated_errors_[i] += error * dt;
    // Anti-windup: |I| <= 255/KI so the integral term alone cannot exceed
    // full drive (firmware.ino:117-119).
    const float limit = 255.0f / gains_.ki;
    if (std::fabs(integrated_errors_[i]) > limit)
      integrated_errors_[i] = std::copysign(limit, integrated_errors_[i]);
    previous_errors_[i] = error;
    const float output = gains_.kp * error + gains_.ki * integrated_errors_[i] +
                         gains_.kd * error_derivative;
    last_outputs_[i] = output;
    pwm_out[i] = ClampPwm(output / 255.0f);
  }
}

bool TensionController::Telemetry(char* buf, size_t buflen) {
  if ((counter_ % kTelemetryEvery) != 1 && kTelemetryEvery > 1) return false;
  const float avg_ms = accum_dt_ * 1000.0f / (float)kTelemetryEvery;
  accum_dt_ = 0.0f;
  std::snprintf(buf, buflen, "%.2f,%.2f,%.2f,%.2f,%.2f,%.2f,%.2f,%.2f,%.3f",
                last_readings_[0], last_readings_[1], last_readings_[2],
                last_readings_[3], last_outputs_[0], last_outputs_[1],
                last_outputs_[2], last_outputs_[3], avg_ms);
  return true;
}

float AutoTare::Step(float reading) {
  // TensionMotor.cpp:13-57 (thresholds TARE_THRESHOLD_BIG=30, SMALL=5).
  constexpr float kBig = 30.0f;
  constexpr float kSmall = 5.0f;
  if (!have_prev_) {
    previous_value_ = reading;
    have_prev_ = true;
    return phase_ == Phase::kTensionUp ? 0.2f : -0.1f;
  }
  switch (phase_) {
    case Phase::kTensionUp:
      if (reading > previous_value_ + kBig) {
        phase_ = Phase::kBackOff;
        // the reference keeps previous_value_ from the tension-up phase
        return -0.1f;
      }
      previous_value_ = reading;
      return 0.2f;
    case Phase::kBackOff:
      if (std::fabs(reading - previous_value_) < kSmall) {
        phase_ = Phase::kDone;
        return 0.0f;
      }
      previous_value_ = reading;
      return -0.1f;
    case Phase::kDone:
      return 0.0f;
  }
  return 0.0f;
}

}  // namespace knode_hw
