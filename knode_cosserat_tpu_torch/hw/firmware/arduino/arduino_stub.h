// Host-side Arduino API stub — JUST enough surface to syntax/type-check
// firmware_shim.ino with a plain C++ compiler when no AVR toolchain is
// installed (hw/bridge.py::check_arduino_shim). Every symbol below
// matches the signature the Arduino Mega core (reference firmware target,
// firmware.ino:1-22) exposes; nothing here ever runs.
#pragma once

#include <cstdint>

#define OUTPUT 0x1
#define LOW 0x0
#define HIGH 0x1

// Mega analog pin ids (arbitrary values; only identity matters here)
#define A4 58
#define A5 59
#define A6 60
#define A7 61

inline void pinMode(uint8_t, uint8_t) {}
inline void digitalWrite(uint8_t, uint8_t) {}
inline void analogWrite(uint8_t, int) {}
inline int analogRead(uint8_t) { return 0; }
inline unsigned long millis() { return 0; }
inline void delay(unsigned long) {}

class String {
 public:
  String() = default;
  String(const char*) {}
  const char* c_str() const { return ""; }
};

class StubSerial {
 public:
  void begin(long) {}
  int available() { return 0; }
  String readStringUntil(char) { return String(); }
  void println(const char*) {}
};

static StubSerial Serial;

// The Arduino IDE concatenates .ino files into a .cpp that calls these:
void setup();
void loop();
