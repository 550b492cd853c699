"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): build, check and
time the hand-written kernels, and drive the serving path.

    python3 chip_smoke.py

Phases, each printing its own lines (any failure ends the run non-zero):
  1. device: needs CUDA; prints the card's name and power limit
     (nvidia-smi).
  2. build: compiles csrc/*.cu with nvcc (ops/_build.py), prints seconds
     and each kernel's registers / spills (the full ptxas log is kept beside
     the library in build/torch_kernels/).
  3. K3 (sweep) against its plain PyTorch version, B=300 lanes, N=10/40,
     Euler/RK4, no net / for_knode(512) / for_knode(512, history=True),
     float64 and float32.
  4. K2 (whole Newton step) against its plain version, one BDF-2 step from
     a perturbed history, B=300 rods.
  5. the serving path, counted: CompiledStepper(fast=True) on the
     measured-hardware rod (N=10, f32) with the for_knode(512) net answers
     20 batched requests for 256 rods; a 256-rod x 50-step mega rollout
     (K2) is checked against the plain driver; a default-impl rollout runs
     the per-phase sweep (K3). The launch counts of this phase must show
     both kernels.
  6. timings, kernel vs plain, each with the card's name and power limit.
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
HIDDEN = 512
SWEEP_TOL = {torch.float64: (1e-10, 1e-12),   # K3 vs plain: (rtol, atol)
             torch.float32: (1e-4, 1e-5)}
STEP_F64 = (1e-9, 1e-10)          # K2 f64: rtol / atol on G, y, z, r2
STEP_F32_ATOL = {"G": 1e-4, "y": 1e-5}
ROLLOUT_F32 = (1e-4, 1e-4)        # mega vs plain rollout, f32 (rtol, atol)


def log(*a):
    print(*a, flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def import_port():
    """The port from this checkout (never an installed copy)."""
    sys.path.insert(0, HERE)
    import knode_cosserat_tpu_torch as K

    if not os.path.abspath(K.__file__).startswith(HERE + os.sep):
        raise RuntimeError(f"knode_cosserat_tpu_torch found at {K.__file__}, "
                           f"not in {HERE}")
    return K


# --------------------------------------------------------------------- inputs

def history_inputs(p, B, seed):
    """A perturbed BDF-2 history around the straight rod, tendon forces of
    5-7 N tensions and a base-reaction guess; float64 numpy."""
    from knode_cosserat_tpu_torch.core.stepper import initial_state

    g = np.random.RandomState(seed)
    y0, z0 = (a.cpu().double().numpy() for a in initial_state(p))
    y = y0 + 1e-3 * g.randn(B, p.N, 19)
    z = z0 + 1e-3 * g.randn(B, p.N, 6)
    c1, c2 = float(p.c1), float(p.c2)
    yh = c1 * y + c2 * y0
    zh = c1 * z + c2 * z0
    tf = (5 + 2 * g.rand(B, 4)) @ p.tendon_dirs.cpu().double().numpy()
    G = 0.05 * g.randn(B, 6)
    return G, yh, zh, tf


def on(dev, dtype, *arrays):
    return [torch.tensor(a, dtype=dtype, device=dev) for a in arrays]


def make_net(K, history, dtype, dev, scale=1.0):
    spec = K.MLPSpec.for_knode(HIDDEN, history=history)
    net = K.init_mlp(spec, torch.Generator().manual_seed(SEED), dtype, dev)
    with torch.no_grad():
        for t in net.parameters():
            t.mul_(scale)
    return spec, net


def close(a, b, rtol, atol):
    """(ok, max |a-b|) with allclose semantics."""
    a, b = a.double(), b.double()
    err = (a - b).abs()
    ok = bool(torch.isfinite(a).all() and torch.isfinite(b).all()
              and (err <= atol + rtol * b.abs()).all())
    return ok, float(err.max()) if err.numel() else 0.0


# ------------------------------------------------------------------- phases

def phase_build(K):
    from knode_cosserat_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    secs = time.perf_counter() - t0
    info = _build.build_info()
    log(f"[build] {secs:.1f} s (nvcc {_build.NVCC_FLAGS[1]}) -> "
        f"{os.path.relpath(info['path'], HERE)}")
    entry = None
    for line in info["ptxas"].splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m and entry:
            stack, spill = m.groups()
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            log(f"[build]   {entry[:60]:60s} regs {m.group(1):>3s} "
                f"stack {stack:>5s} B spill-st {spill:>5s} B")
            entry = None
    return secs


def phase_sweep(K, dev, errs):
    """K3 (and K1 inside it) against sweep_reference on the card."""
    from knode_cosserat_tpu_torch.ops.sweep import (make_sweep_kernel,
                                                    sweep_reference)
    B = 300
    for dtype in (torch.float64, torch.float32):
        rtol, atol = SWEEP_TOL[dtype]
        for N in (10, 40):
            p = K.experimental_rod(N=N).to(dev, dtype)
            G, yh, zh, tf = on(dev, dtype, *history_inputs(p, B, SEED + N))
            for hist in (None, False, True):
                spec, net = (None, None) if hist is None else make_net(
                    K, hist, dtype, dev)
                for method in ("euler", "rk4"):
                    k = make_sweep_kernel(p, spec, method=method)
                    with torch.no_grad():
                        got = k(G, yh, zh, tf, net)
                        want = sweep_reference(p, G, yh, zh, tf, net, method)
                    torch.cuda.synchronize()
                    parts = []
                    for name, a, b in zip(("res", "y", "z"), got, want):
                        ok, e = close(a, b, rtol, atol)
                        parts.append(f"{name} {e:.3e}")
                        errs.setdefault(("K3", dtype), []).append(e)
                        if not ok:
                            raise AssertionError(
                                f"K3 {dtype} N={N} net={hist} {method}: {name} "
                                f"max err {e:.3e} beyond rtol {rtol} atol {atol}")
                    log(f"[K3] {str(dtype)[6:]} N={N:2d} net="
                        f"{'none' if hist is None else ('53' if hist else '28')}"
                        f" {method:5s} ok  " + "  ".join(parts))


def phase_step(K, dev, errs):
    """K2 against step_reference: one BDF-2 step from a perturbed history."""
    from knode_cosserat_tpu_torch.ops.step import (make_step_kernel,
                                                   step_reference)
    B = 300
    cases = [(torch.float64, 10, "euler", None), (torch.float64, 10, "euler", False),
             (torch.float64, 10, "euler", True), (torch.float64, 10, "rk4", False),
             (torch.float64, 40, "euler", None), (torch.float32, 10, "euler", None),
             (torch.float32, 10, "euler", False), (torch.float32, 10, "rk4", True),
             (torch.float32, 40, "rk4", None)]
    for dtype, N, method, hist in cases:
        p = K.experimental_rod(N=N).to(dev, dtype)
        G, yh, zh, tf = on(dev, dtype, *history_inputs(p, B, SEED + 7 * N))
        G = torch.zeros_like(G)
        spec, net = (None, None) if hist is None else make_net(
            K, hist, dtype, dev, scale=1e-2)
        # both solvers run to their floor (a looser tol lets each stop at
        # its own point inside it, up to |r| ~ sqrt(tol))
        tol = 1e-18 if dtype == torch.float64 else 1e-13
        k = make_step_kernel(p, spec, tol=tol, max_iter=30, method=method)
        with torch.no_grad():
            got = k(G, yh, zh, tf, net)
            want = step_reference(p, G, yh, zh, tf, net, tol=tol, max_iter=30,
                                  method=method)
        torch.cuda.synchronize()
        parts = []
        for name, a, b in zip(("G", "y", "z", "r2"), got[:4], want[:4]):
            if dtype == torch.float64:
                ok, e = close(a, b, *STEP_F64)
            elif name in STEP_F32_ATOL:
                ok, e = close(a, b, 0.0, STEP_F32_ATOL[name])
            else:                       # z, r2 in f32: reported, finite
                ok, e = close(a, b, float("inf"), 0.0)
            parts.append(f"{name} {e:.3e}")
            errs.setdefault(("K2", dtype), []).append(e)
            if not ok:
                raise AssertionError(f"K2 {dtype} N={N} {method} net={hist}: "
                                     f"{name} max err {e:.3e}")
        log(f"[K2] {str(dtype)[6:]} N={N:2d} {method:5s} net="
            f"{'none' if hist is None else ('53' if hist else '28')} ok  "
            + "  ".join(parts) + f"  iters max {int(got[4].max())} "
            f"(plain {int(want[4].max())})")


def sine_tensions(p, R, T):
    from knode_cosserat_tpu_torch.controls import calc_controls

    return np.stack([calc_controls("sine", 0.5 + 1.5 * i / R, float(p.del_t), T)
                     for i in range(R)])


def phase_serving(K, dev):
    """The main path, counted: serving + mega rollout (K2), default-impl
    rollout (K3)."""
    from knode_cosserat_tpu_torch.core.fast_rollout import make_fast_rollout
    from knode_cosserat_tpu_torch.ops import step as kstep
    from knode_cosserat_tpu_torch.ops import sweep as ksweep

    p = K.experimental_rod(N=10, dtype=torch.float32).to(dev)
    spec, net = make_net(K, False, torch.float32, dev, scale=1e-3)
    R = 256
    ctl = sine_tensions(p, R, 50)
    stepper = K.CompiledStepper(p, spec, net, batch=R, fast=True)
    kstep.LAUNCHES = 0
    ksweep.LAUNCHES = 0
    state = stepper.reset()
    worst = 0.0
    for t in range(20):
        state, info = stepper.step(state, ctl[:, t])
        res = float(info["residual"])
        worst = max(worst, res)
        if not (res <= 1e-5 and bool(torch.isfinite(state.y).all())):
            raise AssertionError(f"serving request {t}: residual {res:.3e}, "
                                 f"finite {bool(torch.isfinite(state.y).all())}")
    log(f"[serve] 20 requests x {R} rods, hybrid {spec.dims}, f32: max residual "
        f"{worst:.3e} (<= 1e-5), states finite, y {tuple(state.y.shape)}")

    # the rollouts run each solve to the f32 floor, so that mega and plain
    # do not each stop at their own point inside |r| <= 1e-5
    mega = make_fast_rollout(p, spec, tol=1e-13, max_iter=30, impl="mega")
    traj, res, iters = mega(torch.tensor(ctl, device=dev), net)
    sweep_roll = make_fast_rollout(p, spec, tol=1e-13, max_iter=30,
                                   fd_order=1)           # impl="sweep" (K3)
    traj_s, res_s, _ = sweep_roll(torch.tensor(ctl[:, :10], device=dev), net)
    torch.cuda.synchronize()
    launches = {"K2": kstep.LAUNCHES, "K3": ksweep.LAUNCHES}
    log(f"[serve] main-path launches: ops.step.LAUNCHES {launches['K2']}, "
        f"ops.sweep.LAUNCHES {launches['K3']}")
    if launches["K2"] == 0 or launches["K3"] == 0:
        raise AssertionError(f"main path missed a kernel: {launches}")

    plain = make_fast_rollout(p, spec, tol=1e-13, max_iter=30, impl="plain",
                              fd_order=1)
    traj_p, res_p, _ = plain(torch.tensor(ctl, device=dev), net)
    ok, e = close(traj, traj_p, *ROLLOUT_F32)
    ok_s, e_s = close(traj_s, traj_p[:, :10], *ROLLOUT_F32)
    log(f"[serve] mega rollout {tuple(traj.shape)}: max err vs plain {e:.3e}, "
        f"max residual {float(res.max()):.3e}, iters max {int(iters.max())}; "
        f"sweep rollout (T=10) max err {e_s:.3e}")
    if not (ok and ok_s and bool(torch.isfinite(traj).all())):
        raise AssertionError(f"rollout vs plain beyond rtol/atol "
                             f"{ROLLOUT_F32}: mega {e:.3e}, sweep {e_s:.3e}")
    return launches


def timed(fn, n):
    """ms per call over n calls, CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase_timings(K, dev, name_power):
    """Kernel vs plain version at the main path's shapes (f32)."""
    from knode_cosserat_tpu_torch.core.fast_rollout import make_fast_rollout
    from knode_cosserat_tpu_torch.ops.step import (make_step_kernel,
                                                   step_reference)
    from knode_cosserat_tpu_torch.ops.sweep import (make_sweep_kernel,
                                                    sweep_reference)
    tag = f"[{name_power}]"
    dt = torch.float32
    ms = {}
    R = 256

    # K1: one node per lane (a K3 sweep over N=2), hybrid 512, 256x7 lanes
    p2 = K.experimental_rod(N=2).to(dev, dt)
    spec, net = make_net(K, False, dt, dev)
    G, yh, zh, tf = on(dev, dt, *history_inputs(p2, R * 7, SEED))
    k1 = make_sweep_kernel(p2, spec, want_rod=False)
    with torch.no_grad():
        ms["K1"] = (timed(lambda: k1(G, yh, zh, tf, net), 20),
                    timed(lambda: sweep_reference(p2, G, yh, zh, tf, net,
                                                  want_rod=False), 20))
        ok, e1 = close(k1(G, yh, zh, tf, net),
                       sweep_reference(p2, G, yh, zh, tf, net, want_rod=False),
                       *SWEEP_TOL[dt])
    if not ok:
        raise AssertionError(f"K1 one-node check: max err {e1:.3e}")
    ms["K1_err"] = e1
    log(f"[time] K1 one node, {R * 7} lanes, hybrid 512 f32: kernel "
        f"{ms['K1'][0]:.3f} ms, plain {ms['K1'][1]:.3f} ms (max err {e1:.3e}) {tag}")

    # K3: the line-search sweep of the FD driver, 256 rods x 7 candidates
    p = K.experimental_rod(N=10).to(dev, dt)
    G, yh, zh, tf = on(dev, dt, *history_inputs(p, R * 7, SEED))
    k3 = make_sweep_kernel(p, spec, want_rod=False)
    with torch.no_grad():
        ms["K3"] = (timed(lambda: k3(G, yh, zh, tf, net), 20),
                    timed(lambda: sweep_reference(p, G, yh, zh, tf, net,
                                                  want_rod=False), 20))
    log(f"[time] K3 sweep N=10, {R * 7} lanes, hybrid 512 f32: kernel "
        f"{ms['K3'][0]:.3f} ms, plain {ms['K3'][1]:.3f} ms {tag}")

    # K2: one serving step, 256 rods, hybrid (weights x1e-3)
    _, net3 = make_net(K, False, dt, dev, scale=1e-3)
    G, yh, zh, tf = on(dev, dt, *history_inputs(p, R, SEED))
    G = torch.zeros_like(G)
    k2 = make_step_kernel(p, spec, tol=1e-10, max_iter=20)
    with torch.no_grad():
        ms["K2"] = (timed(lambda: k2(G, yh, zh, tf, net3), 5),
                    timed(lambda: step_reference(p, G, yh, zh, tf, net3,
                                                 tol=1e-10, max_iter=20), 3))
    log(f"[time] K2 step N=10, {R} rods, hybrid 512 f32: kernel "
        f"{ms['K2'][0]:.3f} ms, plain {ms['K2'][1]:.3f} ms {tag}")

    # rod-steps/s of 256-rod rollouts (the plain driver over T=11 steps)
    for N, hybrid in ((10, False), (40, False), (10, True)):
        pr = K.experimental_rod(N=N, dtype=dt).to(dev)
        sp, nt = (spec, net3) if hybrid else (None, None)
        rates = []
        for impl, T in (("mega", 50), ("plain", 11)):
            roll = make_fast_rollout(pr, sp, tol=1e-10, max_iter=30, impl=impl,
                                     fd_order=1)
            ctl = torch.tensor(sine_tensions(pr, R, T), device=dev)
            roll(ctl[:, :3], nt)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            roll(ctl, nt)
            torch.cuda.synchronize()
            rates.append(R * (T - 1) / (time.perf_counter() - t0))
        log(f"[time] rollout {R} rods N={N} {'hybrid 512' if hybrid else 'physics'}"
            f" f32: mega {rates[0]:.1f} rod-steps/s (T=50), plain "
            f"{rates[1]:.1f} rod-steps/s (T=11) {tag}")

    # serving step latency, batch 1
    lat = []
    for impl in ("mega", "plain"):
        st = K.CompiledStepper(p, spec, net3, fast=True, fast_impl=impl)
        lat.append(st.benchmark(n=20, reps=3)["latency_ms"])
    log(f"[time] serving step latency, 1 rod, hybrid 512 f32: mega "
        f"{lat[0]:.3f} ms, plain {lat[1]:.3f} ms {tag}")
    return ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 1
    K = import_port()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name_power = card()
    log(name_power)                     # as nvidia-smi prints it
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")

    phase_build(K)
    errs = {}
    phase_sweep(K, dev, errs)
    phase_step(K, dev, errs)
    launches = phase_serving(K, dev)
    ms = phase_timings(K, dev, name_power)

    src = "knode_cosserat_tpu_torch/csrc/"
    k3_err = max(errs[("K3", torch.float32)] + errs[("K3", torch.float64)])
    k1_err = max(k3_err, ms["K1_err"])
    kernels = [
        {"name": "K1 rhs_rows (hybrid per-node RHS, inlined in K2/K3)",
         "route": "cuda", "source": src + "rhs_rows.cuh",
         "replaces": "knode_cosserat_tpu/ops/pallas_sweep.py:93",
         "launches": launches["K2"] + launches["K3"], "max_abs_err": k1_err,
         "ms": ms["K1"][0], "plain_ms": ms["K1"][1]},
        {"name": "K3 sweep", "route": "cuda", "source": src + "sweep.cu",
         "replaces": "knode_cosserat_tpu/ops/pallas_sweep.py:201",
         "launches": launches["K3"], "max_abs_err": k3_err,
         "ms": ms["K3"][0], "plain_ms": ms["K3"][1]},
        {"name": "K2 step", "route": "cuda", "source": src + "step.cu",
         "replaces": "knode_cosserat_tpu/ops/pallas_step.py:57",
         "launches": launches["K2"],
         "max_abs_err": max(errs[("K2", torch.float32)]
                            + errs[("K2", torch.float64)]),
         "ms": ms["K2"][0], "plain_ms": ms["K2"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
