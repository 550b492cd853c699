"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): build, check and
time the hand-written kernels, and drive the serving, training, CLI,
assembly and plate-pose MPC paths.

    python3 chip_smoke.py

Phases, each printing its own lines (any failure ends the run non-zero):
  1. device: needs CUDA; prints the card's name and power limit
     (nvidia-smi).
  2. build: compiles each csrc/*.cu with its own nvcc, all at once
     (ops/_build.py), prints seconds and each kernel's registers / spills
     (the ptxas logs are kept beside the libraries in build/torch_kernels/).
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
  6. K4 (whole training run) against its plain version, 40 epochs on
     tests/golden/bench_data.npz (232 cells, for_knode(512), nsw rod, f32):
     plain, weight decay, a plateau that fires, the 53-input net, 1,904
     cells (train-real's size, data made on the card), and the train-real
     configuration (53 inputs, AdamW 0.1) on random data of 1,904 cells at
     two seeds (train_real_data), after 1 and 40 epochs; 100 + 100 epochs
     against one 200-epoch launch.
  7. the training path, counted: train_knode at the reference configuration
     (for_knode(512), TRAIN_EPOCHS epochs, validation every 200 on 100
     steps); the
     generated data against bench_data.npz (RMSE <= 1e-7); the loss must
     fall, the DTWs be finite, and the run must launch K4 and K2.
  8. K5 (the grid trainer) against its plain version and against K4:
     grids of 8 runs x 232 cells (bench_data.npz) and 20 runs x 348 cells
     (3 trajectories), over the 4 mods (for_knode(512), 40 epochs); every
     run of a grid launch equals a K4 launch on that run bit for bit.
  9. the multitrain path, counted: ``python -m knode_cosserat_tpu_torch
     multitrain``'s function at the CLI's grid (2 datas x 4 mods x 5 seeds
     = 40 models, hidden 512, float32, MULTITRAIN_EPOCHS epochs) and its
     eval (2 schedules, 100 steps; K2 with the cells of a mod stacked);
     the launch counts must show K5 and K2 (per schedule and step one K2
     launch per mod for the cells and one per mod for the baselines; the
     references take the scan) and every DTW must be finite. Then K2 with
     the 10 trained nets of the nsw cells stacked (the eval's launch
     shape) against its plain version and against 10 single-net launches,
     bit for bit.
 10. the study's CLI, counted (the CLI's functions, in a temporary
     directory, each timed on the synchronised host clock):
     ``train sine sine 0.5 1.0 --mod nsw --epochs CLI_EPOCHS`` (K4; K2 in
     its validations); ``simulate --model <that checkpoint> --fast`` (K2
     with the net) against ``simulate --model`` (the plain scan), 100
     steps, the first 50 within ROLLOUT_F32; where the host has pandas,
     ``prepare`` and ``estimate`` of tests/fixtures/sil_step_1100;
     ``simulate --fast`` (physics-only K2) at two sine periods, 230 steps
     each, saved as ``prepare``'s files of the sinesine preset (the repo
     holds no recording that long); ``estimate`` on each (with the
     simulated rod's del_t the velocities within 0.05, mean abs, of the
     simulator's); ``train-real --data sinesine`` at its defaults (K4).
     The losses must fall and the launch counts show K2 and K4.
 11. K6 (the wide trainer) against its plain version: hidden 640 (five
     forward unit tiles of 128) on bench_data.npz and hidden 8192
     at the train-real shape (1,904 cells, 53 inputs, AdamW 0.1, random
     data, train_real_data, two seeds), after 1 and 20 epochs; 100 + 100
     epochs against one 200-epoch run, bit for bit.
 12. the wide training path, counted: train_knode at hidden 8192 on the
     train-real shape (cfg.fused="auto" routes to K6 on the card).
 13. K7 (one coupled-assembly Newton step) against its plain version:
     float64, one step and 20-step rollouts at M=2 (N=6) and M=3 (N=10),
     and one step at M=6 and M=9 (N=10), X / G / plate within 1e-9 (1e-8
     at M=6 and 9, K7_F64_WIDE), y and z within as much relative,
     iterations equal (in a rollout, at most
     K7_STRADDLES steps one apart, both converged); float32 at the bench's
     assembly (ASM_CFG), 20 steps: K7 and its plain version inside the
     float64 truth's envelope of the plain coupled Newton.
 14. the assembly path (A), counted: simulate_assembly(fused=True) at
     ASM_CFG, float32, T=101 and T=1001 (steps/s; K7 launches == T-1),
     the plain coupled Newton at T=21, and the CLI's simulate-assembly
     (20 steps, its .npz checked).
 15. the plate-pose MPC path (B), counted: make_assembly_planner(fused=
     True, w_du=0), horizon 8, 40 iterations, on a 1 cm sway and 0.1 mm
     lift (the cost must fall); the float64 gradient of its first cost
     through K7's roots against the plain Newton's (rtol 1e-6).
 16. K8 (the fused next segment) against its plain version on path C's
     cells: bench_data.npz at for_knode(512) (232 cells) and the train-real
     shape (53 inputs, 1,904 cells), float64 and float32.
 17. the fused training path (C), counted: FUSED_STEPS
     make_train_step(use_pallas=True) steps against as many plain steps
     from the same net (losses within rtol 1e-4), and 20 of each at the
     train-real shape.
 18. timings, kernel vs plain, each with the card's name and power limit,
     and each kernel's bound (the larger of its operations over the
     float32 peak and its bytes over the memory rate); K2 at batch 1, 40
     and 256, and K2's share of a mega rollout's wall time per step (CUDA
     events around its launches against the host clock) at 256 rods and
     at 1; K4 at 232 and 1,904 cells and K5 at 40 runs, with their
     launch plan (cluster size, units per block, tile, clusters resident
     at once); K6 against the plain epoch loop at hidden 1024 / 2048 /
     8192 (the routing's crossover), with its plan and, at 8192, one
     epoch's products as torch.matmul x 200 (a yardstick, not gated);
     each training kernel's share of its bound; K7 at M = 3, 6, 9 and K8
     at 232 and 1,904 cells: the wrapper's call by CUDA events (``ms``, as
     for every kernel) beside the kernel's device time by torch.profiler
     (``device_ms``).
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
# K4 vs its plain version: the JAX package's own fused-vs-scan tolerances
# (tests/test_pallas_train.py:49-54); both run float32 and sum in other
# orders, and over 40 epochs Adam carries that rounding forward
K4_LOSS = (2e-4, 1e-9)            # rtol, atol on the per-epoch losses
K4_PARAM = (3e-3, 3e-5)           # rtol, atol on the trained weights
# K4 and K6 on random data of the train-real shape (1,904 cells, 53
# inputs, AdamW 0.1), params: Adam's step divides by the gradient's own size
# (lr g / (|g| + eps) at the first epoch), so a weight whose gradient sums
# over the cells to within a few eps (1e-8) of 0 carries the rounding of
# that sum, taken in another order by each version, into its step: up to
# lr / 4 (2.5e-3) times its relative error. atol 2e-4 is 1/50 of lr; the
# checks print their readings after one epoch and after 20-40
RANDOM_PARAM = (3e-3, 2e-4)
RANDOM_SEEDS = (0, 1)             # the random data's seeds, each checked
DATA_RMSE = 1e-7                  # generated data vs bench_data.npz
# the H100 SXM's published peaks (NVIDIA's data sheet): float32 outside
# the tensor cores, and the device memory's rate
PEAK_F32 = 67e12                  # FLOP/s
PEAK_BYTES = 3.35e12              # B/s
# arithmetic of one node of the physics RHS besides the MLP (quaternion
# to rotation, two 3x3 solves, drag, cross products): an estimate, <1% of
# a hybrid node at hidden 512
PHYS_FLOPS = 400
BIG_SPECS = [("sine", 0.5), ("sine", 1.0), ("sine", 1.25), ("sine", 1.5)]
MODS = ["nsw", "short", "youngs", "lengthstiff"]
# train_knode's depth (the reference runs 2000; cut to keep the command
# inside its time with the grid and wide phases beside it)
TRAIN_EPOCHS = 1000
MULTITRAIN_EPOCHS = 1000          # the CLI's default
WIDE_HIDDEN = 8192                # the JAX bench's wide trainer shape
# phase_cli: train's depth (cut from the CLI's 2000 epochs to keep the
# script inside its time), the hybrid rollouts' length and how many of
# their steps are held to ROLLOUT_F32, the sinesine files' sine periods
# (s) and length (train-real's trim of 100 + its train_len of 120 + 10),
# and the bar on the estimated velocities (tests/test_realworld.py:78)
CLI_EPOCHS = 400
CLI_MODEL_STEPS, CLI_MODEL_HELD = 100, 50
CLI_PERIODS = (1.0, 3.0)
CLI_SIM_STEPS = 230
EST_VEL_BAR = 0.05
# the JAX bench's assembly (bench.py:517-525): 3 rods on a 5 cm ring, N=10
ASM_CFG = dict(n_rods=3, base_radius=0.05, N=10)
ASM_AMPS = (0.7, 1.0, 1.3)        # its sine schedule's parameter per rod
# K7 against its plain version in f64: both solve to 1e-24 (each stops at
# its floor, not somewhere of its own inside the fused default's 1e-16);
# X, G and the plate pose within 1e-9, y and z within 1e-9 of their largest
K7_TOL64, K7_F64 = 1e-24, 1e-9
# ... and the same Newton iterations, but for at most K7_STRADDLES of a
# rollout's 20 steps where the two end one iteration apart, both
# converged: the residual after an iteration spans 1e-30 to 1e-18 over a
# rollout (the plain version on the CPU), and where it lands near the
# tolerance the central differences' rounding (h = 1e-8 magnifies it
# 1e8-fold) decides the stop test (measured on the card: 3 vs 2
# iterations at one step, the residuals 100x apart, every value within
# 7e-11)
K7_STRADDLES = 2
# ... and at M = 6 and 9, one step, X, y and z within K7_F64_WIDE: the
# coupled Jacobian's condition number grows with M (~1e7 at M = 9, 1.2e5
# at M = 3; the plain version alone moves X by 1.6e-9 at M = 9 when the
# tendon forces change by 1e-15 relative, float64 on the CPU)
K7_F64_WIDE = 1e-8
MPC_GRAD_RTOL = 1e-6              # IFT gradient, K7's roots vs plain (f64)
# path B's target: sway (x) and lift (z) of the plate at the horizon's end,
# ramped from its start. The plan runs with w_du = 0 (the JAX package's
# planner test): with the default 1e-4 the penalty on Adam's first +-2 N
# tension steps outweighs mm-to-cm tracking errors on these stiff rods, and
# the cost climbs for the 40 iterations (measured on the CPU with the
# plain solver: 4.0e-5 -> 6.4e-5; with w_du = 0, 4.0e-5 -> 4.1e-8)
MPC_MOVE = (0.01, 0.0, 1e-4)
# K8 against its plain version, (rtol, atol): f64 to rounding; f32, where
# the net's 512-term sums run in another order (measured ~5e-7 on
# y_grown ~ 2 on the first chip run)
K8_TOL = {torch.float64: (1e-12, 1e-12), torch.float32: (1e-5, 1e-5)}
FUSED_STEPS = 200                 # path C: fused vs plain training steps
FUSED_LOSS_RTOL = 1e-4            # their losses, f32 (the JAX test's bar)


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


def beyond(a, b, tol):
    """How many entries of a lie outside allclose(b, rtol, atol)."""
    rtol, atol = tol
    return int(((a - b).abs() > atol + rtol * b.abs()).sum())


def compare_run(make, p, cfg, net, trajs, ctls, epochs, tol):
    """A training kernel's run against its plain version (``make`` is
    make_fused_training_run or make_wide_training_run): losses at K4_LOSS,
    weights at ``tol``. Returns (ok, max loss err, max param err, entries
    beyond K4_PARAM, the kernel's (net, losses, state))."""
    got = make(p, cfg.spec(), cfg, epochs)(net, trajs, ctls)
    want = make(p, cfg.spec(), cfg, epochs, plain=True)(net, trajs, ctls)
    torch.cuda.synchronize()
    ok, e_loss = close(got[1], want[1], *K4_LOSS)
    e_par, n_out = 0.0, 0
    for a, b in zip(got[0].parameters(), want[0].parameters()):
        ok_p, e = close(a.detach(), b.detach(), *tol)
        ok, e_par = ok and ok_p, max(e_par, e)
        n_out += beyond(a.detach(), b.detach(), K4_PARAM)
    return ok, e_loss, e_par, n_out, got


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
            p = K.experimental_rod(N=N, device=dev).to(dtype=dtype)
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
        p = K.experimental_rod(N=N, device=dev).to(dtype=dtype)
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


def check_step_per_rod(K, dev, errs, rod, nets, label):
    """K2 with one net per rod (a StackedMLP: the multitrain eval's cells of
    a mod) against its plain version with the same stack, and against one
    single-net launch per rod, bit for bit. float32, one BDF-2 step from a
    perturbed history, both solvers run to the f32 floor."""
    from knode_cosserat_tpu_torch.models.mlp import StackedMLP
    from knode_cosserat_tpu_torch.ops.step import (make_step_kernel,
                                                   step_reference)
    B, spec, stack = len(nets), nets[0].spec, StackedMLP(nets)
    G, yh, zh, tf = on(dev, torch.float32, *history_inputs(rod, B, SEED + 3))
    G = torch.zeros_like(G)
    k = make_step_kernel(rod, spec, tol=1e-13, max_iter=30)
    with torch.no_grad():
        got = k(G, yh, zh, tf, stack)
        want = step_reference(rod, G, yh, zh, tf, stack, tol=1e-13,
                              max_iter=30)
        singles = [k(G[b:b + 1], yh[b:b + 1], zh[b:b + 1], tf[b:b + 1],
                     nets[b]) for b in range(B)]
    torch.cuda.synchronize()
    parts = []
    for name, a, b in zip(("G", "y", "z", "r2"), got[:4], want[:4]):
        atol = STEP_F32_ATOL.get(name)
        ok, e = (close(a, b, 0.0, atol) if atol is not None
                 else close(a, b, float("inf"), 0.0))   # z, r2: finite
        parts.append(f"{name} {e:.3e}")
        errs.setdefault(("K2", torch.float32), []).append(e)
        if not ok:
            raise AssertionError(f"K2 per-rod nets ({label}): {name} max err "
                                 f"{e:.3e}")
    same = all(torch.equal(x[b:b + 1], w) for b in range(B)
               for x, w in zip(got, singles[b]))
    log(f"[K2] per-rod nets, {label}: {B} rods x {spec.dims} f32, vs plain "
        + "  ".join(parts) + f"  iters max {int(got[4].max())} (plain "
        f"{int(want[4].max())}); == {B} single-net launches bit for bit: "
        f"{same}")
    if not same:
        raise AssertionError(f"K2 per-rod nets ({label}) differ from "
                             f"single-net launches")


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

    p = K.experimental_rod(N=10, dtype=torch.float32, device=dev)
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


def k2_device_share(K, roll, ctl, net):
    """A mega rollout's K2 share: each K2 launch between CUDA events (its
    device time) against the rollout's host-clock wall time, synchronised.
    Returns (K2 ms per step, wall ms per step)."""
    from knode_cosserat_tpu_torch.ops import step as kstep

    pairs, orig = [], kstep._launch

    def launch(*a):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        out = orig(*a)
        e.record()
        pairs.append((s, e))
        return out

    roll(ctl[:, :3], net)
    torch.cuda.synchronize()
    kstep._launch = launch
    try:
        t0 = time.perf_counter()
        roll(ctl, net)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        kstep._launch = orig
    steps = ctl.shape[1] - 1
    return sum(s.elapsed_time(e) for s, e in pairs) / steps, wall / steps


def k2_bound(iters, N, hidden, din, dtype_bytes=4):
    """K2's bound from this run's iterations: per rod the first residual
    sweep, 6 probes and one line-search candidate per iteration and the
    recording sweep (a floor: failed candidates are not counted), each
    N-1 nodes; bytes: the net once, each rod's inputs and outputs once."""
    B = iters.numel()
    sweeps = int((2 + 7 * iters.long()).sum())
    w_bytes = dtype_bytes * (hidden * (din + 25) + hidden + 25)
    return sweeps, bound(sweeps * (N - 1) * node_flops(hidden, din),
                         w_bytes + dtype_bytes * B * (
                             6 + N * 25 + 3 + 6 + N * 19
                             + (N - 1) * 6 + 2))


def phase_timings(K, dev, name_power):
    """Kernel vs plain version at the main path's shapes (f32)."""
    from knode_cosserat_tpu_torch.core.fast_rollout import make_fast_rollout
    from knode_cosserat_tpu_torch.ops import step as kstep
    from knode_cosserat_tpu_torch.ops.step import (make_step_kernel,
                                                   step_reference)
    from knode_cosserat_tpu_torch.ops.sweep import (make_sweep_kernel,
                                                    sweep_reference)
    tag = f"[{name_power}]"
    dt = torch.float32
    ms = {}
    R = 256

    # K1: one node per lane (a K3 sweep over N=2), hybrid 512, 256x7 lanes
    p2 = K.experimental_rod(N=2, device=dev).to(dtype=dt)
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
        f"{ms['K1'][0]:.4f} ms, plain {ms['K1'][1]:.3f} ms (max err {e1:.3e}) {tag}")

    # K3: the line-search sweep of the FD driver, 256 rods x 7 candidates
    p = K.experimental_rod(N=10, device=dev).to(dtype=dt)
    G, yh, zh, tf = on(dev, dt, *history_inputs(p, R * 7, SEED))
    k3 = make_sweep_kernel(p, spec, want_rod=False)
    with torch.no_grad():
        ms["K3"] = (timed(lambda: k3(G, yh, zh, tf, net), 20),
                    timed(lambda: sweep_reference(p, G, yh, zh, tf, net,
                                                  want_rod=False), 20))
    log(f"[time] K3 sweep N=10, {R * 7} lanes, hybrid 512 f32: kernel "
        f"{ms['K3'][0]:.4f} ms, plain {ms['K3'][1]:.3f} ms {tag}")

    # K2: one serving step, hybrid (weights x1e-3), at batch 1, 40 (one
    # mod's stacked eval cells) and 256
    _, net3 = make_net(K, False, dt, dev, scale=1e-3)
    k2 = make_step_kernel(p, spec, tol=1e-10, max_iter=20)
    for B in (1, 40, R):
        G, yh, zh, tf = on(dev, dt, *history_inputs(p, B, SEED))
        G = torch.zeros_like(G)
        with torch.no_grad():
            k2_ms = timed(lambda: k2(G, yh, zh, tf, net3), 20)
            plain = timed(lambda: step_reference(p, G, yh, zh, tf, net3,
                                                 tol=1e-10, max_iter=20), 3)
            iters = k2(G, yh, zh, tf, net3)[4]
        sweeps, (b_ms, b_by) = k2_bound(iters, p.N, HIDDEN, 28)
        ms[f"K2 B={B}"] = dict(ms=k2_ms, plain_ms=plain, bound_ms=b_ms,
                               bound_by=b_by, sweeps=sweeps)
        log(f"[time] K2 step N=10, {B} rods, hybrid 512 f32: kernel "
            f"{k2_ms:.4f} ms, plain {plain:.3f} ms, bound {b_ms:.6f} ms "
            f"({b_by}; {sweeps} sweeps, iters max {int(iters.max())}) {tag}")
    ms["K2"] = (ms[f"K2 B={R}"]["ms"], ms[f"K2 B={R}"]["plain_ms"])
    ms["K2_bound"] = (ms[f"K2 B={R}"]["bound_ms"], ms[f"K2 B={R}"]["bound_by"])

    # rod-steps/s of 256-rod rollouts (the plain driver over T=11 steps)
    for N, hybrid in ((10, False), (40, False), (10, True)):
        pr = K.experimental_rod(N=N, dtype=dt, device=dev)
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

    # K2's share of a mega rollout's wall time per step (the rest is the
    # host's glue: history terms, tendon forces, records, the launch)
    for B in (R, 1):
        roll = make_fast_rollout(p, spec, tol=1e-10, max_iter=30, impl="mega")
        ctl = torch.tensor(sine_tensions(p, B, 50), device=dev)
        k2_step, wall = k2_device_share(K, roll, ctl, net3)
        ms[f"share B={B}"] = (k2_step, wall)
        log(f"[time] mega rollout {B} rods N=10 hybrid 512 f32: K2 "
            f"{k2_step:.4f} ms of {wall:.4f} ms wall per step "
            f"({100 * k2_step / wall:.1f}% on K2) {tag}")

    # serving step latency, batch 1
    lat = []
    for impl in ("mega", "plain"):
        st = K.CompiledStepper(p, spec, net3, fast=True, fast_impl=impl)
        lat.append(st.benchmark(n=20, reps=3)["latency_ms"])
    log(f"[time] serving step latency, 1 rod, hybrid 512 f32: mega "
        f"{lat[0]:.3f} ms, plain {lat[1]:.3f} ms {tag}")
    return ms


def bound(flops, nbytes):
    """(ms, "operations" | "bytes"): the least time the card could take."""
    t_ops, t_bytes = flops / PEAK_F32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def node_flops(hidden, din):
    """One hybrid RHS node: the 2-layer MLP, its ELU and the physics."""
    return 2 * hidden * (din + 25) + hidden + PHYS_FLOPS


def bench_data(dev):
    """tests/golden/bench_data.npz: 2 trajectories x 30 steps, N=10, f64."""
    d = np.load(os.path.join(HERE, "tests", "golden", "bench_data.npz"))
    trajs = np.moveaxis(d["trajs"], 2, 3)    # (B, T, 25, N) -> (B, T, N, 25)
    return (torch.tensor(trajs, device=dev),
            torch.tensor(d["controls"], device=dev))


def train_setup(K, dev, **cfg_kw):
    """The nsw rod (f32), a TrainConfig at hidden 512 and its fresh net."""
    cfg = K.TrainConfig(hidden=HIDDEN, **cfg_kw)
    p = K.apply_mod("nsw", dtype=torch.float32, device=dev)
    net = K.init_mlp(cfg.spec(), torch.Generator().manual_seed(SEED),
                     torch.float32, dev)
    return p, cfg, net


# the quaternion (1, 0, 0, 0): the rod's orientation at rest
IDENTITY = np.eye(1, 25, 3)[0]


def first_epoch(make, label, p, cfg, net, trajs, ctls):
    """A kernel against its plain version after one epoch on random data,
    where Adam's step is lr g / (|g| + eps) (RANDOM_PARAM); the log text."""
    ok, _, e, n, _ = compare_run(make, p, cfg, net, trajs, ctls, 1,
                                 RANDOM_PARAM)
    if not ok:
        raise AssertionError(f"{label}, 1 epoch: params {e:.3e} beyond "
                             f"{RANDOM_PARAM}")
    return f"; after 1 epoch params {e:.3e} ({n} beyond)"


def train_real_data(dev, N=10, seed=SEED):
    """Random data of the train-real shape (4 trajectories x 120 steps:
    1,904 cells at 4 keypoints), made as the JAX bench makes it
    (bench.py:612-623) plus the identity quaternion: the bench's random
    quaternions give Euler angles anywhere in (-pi, pi], and near the
    loss's +-pi wrap the loss jumps, so two float32 runs that differ only
    by rounding part there. A real rod's orientation stays near identity,
    far from the wrap."""
    g = np.random.default_rng(seed)
    trajs = torch.tensor(g.normal(size=(4, 120, N, 25)) * 0.01 + IDENTITY,
                         dtype=torch.float32, device=dev)
    ctls = torch.tensor(g.uniform(1, 3, size=(4, 120, 4)),
                        dtype=torch.float32, device=dev)
    return trajs, ctls


def near_wrap(q):
    """How many quaternions of q (..., 4) have a roll or yaw of the loss's
    Euler map within 1e-2 of its +-pi wrap."""
    from knode_cosserat_tpu_torch.ops.quaternion import quaternion_to_euler
    e = quaternion_to_euler(q.double())[..., [0, 2]]
    return int(((np.pi - e.abs()) < 1e-2).any(-1).sum())


def phase_k4(K, dev, errs):
    """K4 against train_run_reference on the card; returns the 232- and
    1,904-cell data for the timings."""
    from knode_cosserat_tpu_torch.ops.train import make_fused_training_run
    from knode_cosserat_tpu_torch.training.loss import DEFAULT_KEYPOINTS_REAL

    small = bench_data(dev)
    t0 = time.perf_counter()
    big = K.make_training_data(K.apply_mod(None, device=dev), BIG_SPECS,
                               train_len=120)
    torch.cuda.synchronize()
    log(f"[K4] train-real-size data {tuple(big[0].shape)} made on the card "
        f"in {time.perf_counter() - t0:.1f} s")
    cases = [("plain", small, {}), ("weight_decay=1e-4", small,
                                    dict(weight_decay=1e-4)),
             ("plateau_patience=4", small, dict(plateau_patience=4)),
             ("history (53 inputs)", small, dict(history=True)),
             ("1904 cells", big, {})]
    real = dict(history=True, weight_decay=0.1,
                keypoints=DEFAULT_KEYPOINTS_REAL)
    rest = torch.tensor(IDENTITY[3:7], device=dev)
    for s in RANDOM_SEEDS:
        data = train_real_data(dev, seed=s)
        q = data[0][..., 3:7]
        log(f"[K4] random data, seed {s}: {near_wrap(q)} of {q[..., 0].numel()}"
            f" node states have an Euler roll or yaw within 1e-2 of the "
            f"loss's +-pi wrap ({near_wrap(q - rest)} without the identity "
            f"quaternion, as bench.py makes them)")
        cases.append((f"1904 random, seed {s}", data, real))
    for name, (trajs, ctls), kw in cases:
        p, cfg, net = train_setup(K, dev, **kw)
        tol, first = K4_PARAM, ""
        if name.startswith("1904 random"):
            tol = RANDOM_PARAM
            first = first_epoch(make_fused_training_run, f"K4 {name}", p, cfg,
                                net, trajs, ctls)
        ok, e_loss, e_par, n_out, got = compare_run(
            make_fused_training_run, p, cfg, net, trajs, ctls, 40, tol)
        fired = float(got[2]["scalars"][3]) < 1.0
        errs.setdefault("K4", []).extend([e_loss, e_par])
        log(f"[K4] {name:20s} 40 epochs: loss {float(got[1][0]):.4e} -> "
            f"{float(got[1][-1]):.4e}, max err loss {e_loss:.3e} params "
            f"{e_par:.3e} ({n_out} entries beyond {K4_PARAM}){first}, "
            f"plateau fired {fired}")
        if not ok:
            raise AssertionError(f"K4 {name}: beyond loss {K4_LOSS} / params "
                                 f"{tol}: {e_loss:.3e} / {e_par:.3e}")
        if not float(got[1][-1]) < float(got[1][0]):
            raise AssertionError(f"K4 {name}: the loss did not fall")

    # chunks compose: 100 + 100 epochs == one 200-epoch launch
    p, cfg, net = train_setup(K, dev)
    trajs, ctls = small
    whole = make_fused_training_run(p, cfg.spec(), cfg, 200)(net, trajs, ctls)
    half = make_fused_training_run(p, cfg.spec(), cfg, 100)
    mid = half(net, trajs, ctls)
    end = half(mid[0], trajs, ctls, mid[2])
    ok, e = close(torch.cat([mid[1], end[1]]), whole[1], *K4_LOSS)
    for a, b in zip(end[0].parameters(), whole[0].parameters()):
        ok_p, e_p = close(a.detach(), b.detach(), *K4_PARAM)
        ok, e = ok and ok_p, max(e, e_p)
    log(f"[K4] 100 + 100 epochs vs one 200-epoch launch: max err {e:.3e}")
    if not ok:
        raise AssertionError(f"K4 chunks do not compose: {e:.3e}")
    plain = make_fused_training_run(p, cfg.spec(), cfg, 200, plain=True)(
        net, trajs, ctls)
    gap = float(((whole[1] - plain[1]).abs() / plain[1].abs()).max())
    log(f"[K4] 200 epochs, kernel vs plain (reported, not gated): max "
        f"relative loss gap {gap:.3e}, final loss {float(whole[1][-1]):.4e} "
        f"vs {float(plain[1][-1]):.4e}")
    return small, big


def phase_train(K, dev):
    """The training path, counted: train_knode at the reference config."""
    from knode_cosserat_tpu_torch.ops import step as kstep
    from knode_cosserat_tpu_torch.ops import sweep as ksweep
    from knode_cosserat_tpu_torch.ops import train as ktrain

    ref = K.apply_mod(None, device=dev)
    t0 = time.perf_counter()
    trajs, ctls = K.make_training_data(ref, [("sine", 0.5), ("sine", 1.0)],
                                       train_len=30)
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t0
    bt, bc = bench_data(dev)
    rmse = float(((trajs - bt) ** 2).mean().sqrt())
    log(f"[train] data {tuple(trajs.shape)} made on the card in {t_data:.1f} "
        f"s: RMSE vs bench_data.npz {rmse:.3e} (bar {DATA_RMSE}), controls "
        f"equal {bool(torch.equal(ctls, bc))}")
    if not (rmse <= DATA_RMSE and torch.equal(ctls, bc)):
        raise AssertionError(f"generated data RMSE {rmse:.3e} > {DATA_RMSE}")
    vc, vt = K.make_validation_reference(ref, ("sine", 1.25), 100)
    p_mod = K.apply_mod("nsw", dtype=torch.float32, device=dev)
    cfg = K.TrainConfig(hidden=HIDDEN, epochs=TRAIN_EPOCHS, eval_every=200,
                        eval_len=100, dtype="float32")
    kstep.LAUNCHES = ksweep.LAUNCHES = ktrain.LAUNCHES = 0
    t0 = time.perf_counter()
    r = K.train_knode(p_mod, trajs, ctls, cfg, vc, vt, log=None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K4": ktrain.LAUNCHES, "K2": kstep.LAUNCHES,
                "K3": ksweep.LAUNCHES}
    lh = r.loss_history
    dtws = [d for _, d in r.dtw_history]
    log(f"[train] train_knode for_knode(512), {TRAIN_EPOCHS} epochs, f32: "
        f"{wall:.1f} s, epochs_per_sec {r.epochs_per_sec:.1f} on {r.device}")
    log(f"[train] loss {lh[0]:.4e} -> {lh[-1]:.4e} ({len(lh)} entries); DTW "
        f"history {[(e, round(d, 6)) for e, d in r.dtw_history]}; best_dtw "
        f"{r.best_dtw:.6f}")
    log(f"[train] main-path launches: ops.train.LAUNCHES {launches['K4']}, "
        f"ops.step.LAUNCHES {launches['K2']}, ops.sweep.LAUNCHES "
        f"{launches['K3']}")
    if not (np.isfinite(lh).all() and lh[-1] < lh[0]):
        raise AssertionError(f"training loss did not fall: {lh[0]} -> {lh[-1]}")
    if not (np.isfinite(dtws).all() and np.isfinite(r.best_dtw)):
        raise AssertionError(f"non-finite DTW: {r.dtw_history}")
    if launches["K4"] == 0 or launches["K2"] == 0:
        raise AssertionError(f"the training path missed a kernel: {launches}")
    # one validation rollout alone, as train_knode runs it (K2, tol 1e-10)
    from knode_cosserat_tpu_torch.core.fast_rollout import make_fast_rollout
    roll = make_fast_rollout(p_mod, r.spec, tol=1e-10, max_iter=50,
                             impl="mega")
    t0 = time.perf_counter()
    _, res, iters = roll(torch.as_tensor(vc)[None], r.params)
    torch.cuda.synchronize()
    log(f"[train] one validation rollout (K2, 1 rod x {iters.shape[0]} steps, "
        f"final weights): {time.perf_counter() - t0:.2f} s, Newton iterations "
        f"per step mean {float(iters.float().mean()):.1f} max "
        f"{int(iters.max())}, residual max {float(res.max()):.3e}")
    return launches, r


def k4_plan_line(ktrain, din, hidden, dev):
    """K4's launch plan at (din, hidden) and how many of its clusters the
    card holds at once."""
    plan = ktrain.launch_plan(din, hidden)
    return (f"cluster {plan.cluster} x {plan.threads} threads, "
            f"{plan.units} units per block ({plan.slots} slots), tile "
            f"{plan.tile} cells, {plan.smem_bytes} B shared, "
            f"{ktrain.max_active_clusters(din, hidden, dev)} clusters "
            f"resident")


def phase_k4_timings(K, dev, name_power, data):
    """K4 per 200-epoch chunk against its plain version and its bound."""
    from knode_cosserat_tpu_torch.ops import train as ktrain

    tag = f"[{name_power}]"
    E = 200
    out = {}
    log(f"[time] K4 plan, hidden {HIDDEN}, 28 inputs: "
        f"{k4_plan_line(ktrain, 28, HIDDEN, dev)}")
    for label, (trajs, ctls) in zip(("232", "1904"), data):
        p, cfg, net = train_setup(K, dev)
        spec = cfg.spec()
        cells = ktrain.precompute(p, spec, cfg.keypoints, trajs, ctls)
        W = [t.detach() for wb in net.weights() for t in wb]
        state = ktrain.fused_state_from_optimizer(K.training.make_optimizer(
            cfg, net))
        hyper = ktrain.TrainHyper(cfg.lr, cfg.weight_decay, cfg.plateau_factor,
                                  cfg.plateau_patience, cfg.clamp_weights)
        C, din = cells.x.shape
        kern = timed(lambda: ktrain.train_run(cells, W, state, E, hyper), 3)
        plain = timed(lambda: ktrain.train_run_reference(cells, W, state, E,
                                                         hyper), 1)
        n_params = HIDDEN * (din + 25) + HIDDEN + 25
        flops = E * 2 * C * HIDDEN * (2 * din + 75)
        nbytes = 4 * (C * (din + 56) + 6 * n_params + E + 8)
        b_ms, b_by = bound(flops, nbytes)
        out[label] = dict(ms=kern, plain_ms=plain, bound_ms=b_ms, bound_by=b_by)
        log(f"[time] K4 {E}-epoch chunk, {C} cells, hidden {HIDDEN} f32: "
            f"kernel {kern:.3f} ms ({E / kern * 1e3:.1f} epochs/s), plain "
            f"{plain:.3f} ms ({E / plain * 1e3:.1f} epochs/s), bound "
            f"{b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.2f} MB), {100 * b_ms / kern:.2f}% of the bound "
            f"{tag}")
    return out


def phase_k5(K, dev, errs, small):
    """K5 against its plain version and against K4, cell by cell: 8 runs
    of 232 cells (2 trajectories), and 20 runs of 348 cells (3
    trajectories), the multitrain grid's two sub-grid shapes."""
    from knode_cosserat_tpu_torch.models.mlp import StackedMLP
    from knode_cosserat_tpu_torch.ops import train as ktrain

    trajs, ctls = small
    # a third trajectory between the two of bench_data.npz
    three = (torch.cat([trajs, trajs.mean(0, keepdim=True)]),
             torch.cat([ctls, ctls.mean(0, keepdim=True)]))
    cfg = K.TrainConfig(hidden=HIDDEN)
    spec = cfg.spec()
    for G, (trajs, ctls) in ((8, small), (20, three)):
        rods = [K.apply_mod(MODS[g % 4], dtype=torch.float32, device=dev)
                for g in range(G)]
        nets = [K.init_mlp(spec, torch.Generator().manual_seed(g),
                           torch.float32, dev) for g in range(G)]
        tg, cg = torch.stack([trajs] * G), torch.stack([ctls] * G)
        got = ktrain.make_fused_grid_training_run(spec, cfg, 40)(
            rods, StackedMLP(nets), tg, cg)
        want = ktrain.make_fused_grid_training_run(spec, cfg, 40, plain=True)(
            rods, StackedMLP(nets), tg, cg)
        torch.cuda.synchronize()
        ok, e_loss = close(got[1], want[1], *K4_LOSS)
        e_par = 0.0
        for a, b in zip(got[0].parameters(), want[0].parameters()):
            ok_p, e = close(a.detach(), b.detach(), *K4_PARAM)
            ok, e_par = ok and ok_p, max(e_par, e)
        errs.setdefault("K5", []).extend([e_loss, e_par])
        C = trajs.shape[0] * (trajs.shape[1] - 1) * len(cfg.keypoints)
        log(f"[K5] {G} runs ({', '.join(MODS)}) x {C} cells, hidden "
            f"{HIDDEN}, 40 epochs: max err vs plain loss {e_loss:.3e} "
            f"params {e_par:.3e}")
        if not ok:
            raise AssertionError(f"K5 {G} x {C} vs plain beyond loss "
                                 f"{K4_LOSS} / params {K4_PARAM}: "
                                 f"{e_loss:.3e} / {e_par:.3e}")
        unstacked = got[0].unstack()
        for g in range(G):
            one = ktrain.make_fused_training_run(rods[g], spec, cfg, 40)(
                nets[g], trajs, ctls)
            same = (torch.equal(got[1][g], one[1])
                    and torch.equal(got[2]["scalars"][g], one[2]["scalars"])
                    and all(torch.equal(a, b) for a, b in
                            zip(unstacked[g].parameters(),
                                one[0].parameters())))
            if not same:
                raise AssertionError(f"K5 {G} x {C}: cell {g} differs from "
                                     f"a K4 launch")
        log(f"[K5] {G} x {C}: every run of the grid launch == a K4 launch "
            f"on that run, bit for bit (losses, weights, scalars)")


def phase_multitrain(K, dev):
    """The multitrain path, counted: the CLI's multitrain function."""
    from knode_cosserat_tpu_torch import cli
    from knode_cosserat_tpu_torch.ops import step as kstep
    from knode_cosserat_tpu_torch.ops import sweep as ksweep
    from knode_cosserat_tpu_torch.ops import train as ktrain

    out_dir = os.path.join(HERE, "build", "multitrain")
    argv = ["multitrain", "--n_seeds", "5", "--epochs",
            str(MULTITRAIN_EPOCHS), "--layers", str(HIDDEN),
            "--save_dir", os.path.join(out_dir, "saved_models"),
            "--evals_dir", os.path.join(out_dir, "evals")]
    log(f"[multitrain] python -m knode_cosserat_tpu_torch {' '.join(argv)}")
    kstep.LAUNCHES = ksweep.LAUNCHES = 0
    ktrain.LAUNCHES = ktrain.GRID_LAUNCHES = 0
    t0 = time.perf_counter()
    out = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K5": ktrain.GRID_LAUNCHES, "K2": kstep.LAUNCHES,
                "K4": ktrain.LAUNCHES, "K3": ksweep.LAUNCHES}
    res, records, secs = out["result"], out["records"], out["seconds"]
    G = len(res.cells)
    rate = G * MULTITRAIN_EPOCHS / res.train_seconds
    worst = max(r.residual for r in records)
    n_steps, n_sched = cli.EVAL_LEN - 1, len(cli.EVAL_SETS[False])
    # per schedule and step: one launch per mod for the cells, one per mod
    # for the baselines (the reference rollouts take the scan)
    want_k2 = 2 * len(MODS) * n_sched * n_steps
    log(f"[multitrain] {G} models x {MULTITRAIN_EPOCHS} epochs, hidden "
        f"{HIDDEN} f32: grid training {res.train_seconds:.3f} s = "
        f"{rate:.1f} models x epochs/s; datagen+train "
        f"{secs['datagen+train']:.1f} s, eval {secs['eval']:.1f} s, "
        f"command {wall:.1f} s")
    log(f"[multitrain] loss {float(res.loss_history[0].mean()):.4e} -> "
        f"{float(res.loss_history[-1].mean()):.4e} (mean over cells); worst "
        f"served residual of the eval rollouts {worst:.3e}")
    log(f"[multitrain] main-path launches: ops.train.GRID_LAUNCHES "
        f"{launches['K5']}, ops.step.LAUNCHES {launches['K2']} (want "
        f"{want_k2}: 2 x {len(MODS)} mods x {n_sched} schedules x "
        f"{n_steps} steps), "
        f"ops.train.LAUNCHES {launches['K4']}, ops.sweep.LAUNCHES "
        f"{launches['K3']}")
    if launches["K5"] == 0 or launches["K2"] != want_k2:
        raise AssertionError(f"the multitrain path's launches: {launches}")
    if not (np.isfinite(res.loss_history).all()
            and all(np.isfinite(r.dtw) for r in records)):
        raise AssertionError("non-finite loss or DTW in the multitrain run")
    if not (res.loss_history[-1] < res.loss_history[0]).all():
        raise AssertionError("a grid cell's loss did not fall")
    return launches, res


def write_prepared(path, traj, controls, del_t):
    """A rollout (T, N, 50) saved in ``prepare``'s npz layout: t, traj,
    controls, the rod-grid poses ``interpolated`` (T, 7, N) and the marker
    nodes' positions (T, 5, 3)."""
    from knode_cosserat_tpu_torch.cli import MARKER_NODES

    T = len(traj)
    np.savez_compressed(path, t=np.arange(T) * del_t, traj=traj,
                        controls=controls,
                        interpolated=np.moveaxis(traj[:, :, :7], 1, 2),
                        positions=traj[:, MARKER_NODES, :3])


def phase_cli(K, dev, name_power):
    """The study's entry points, counted: the CLI's train, simulate,
    estimate and train-real functions on the card at hidden 512, in a
    temporary directory, each timed on the synchronised host clock."""
    import importlib.util
    import tempfile

    from knode_cosserat_tpu_torch import cli
    from knode_cosserat_tpu_torch.ops import step as kstep
    from knode_cosserat_tpu_torch.ops import sweep as ksweep
    from knode_cosserat_tpu_torch.ops import train as ktrain
    from knode_cosserat_tpu_torch.realworld import estimate_state, fit_curve
    from knode_cosserat_tpu_torch.training.checkpoint import load_checkpoint

    have = {m: importlib.util.find_spec(m) is not None
            for m in ("pandas", "matplotlib")}
    log(f"[cli] this host has pandas {have['pandas']}, matplotlib "
        f"{have['matplotlib']} (prepare needs pandas, playback and "
        f"simulate --gif matplotlib; without them they run on the CPU "
        f"tests only)")
    secs = {}

    def run(label, argv):
        log(f"[cli] python -m knode_cosserat_tpu_torch {' '.join(argv)}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = cli.main(argv)
        torch.cuda.synchronize()
        secs[label] = time.perf_counter() - t0
        log(f"[time] cli {label}: {secs[label]:.2f} s [{name_power}]")
        return out

    with tempfile.TemporaryDirectory(prefix="knode_cli_") as d:
        saved, datas = os.path.join(d, "saved_models"), os.path.join(d,
                                                                     "datas")
        kstep.LAUNCHES = ksweep.LAUNCHES = ktrain.LAUNCHES = 0
        # 1. train on the nsw rod (CLI_EPOCHS: cut from the CLI's 2000
        # epochs to keep the script inside its time), validation sine 1.25
        # every 200 epochs. The rod is modified: with the reference rod
        # itself the epoch-0 score of the rod without a net is 0, so the
        # kept "best" net would be the untrained one (the reference's
        # quirk: physics_train.py:275,380)
        res = run("train", ["train", "sine", "sine", "0.5", "1.0", "--mod",
                            "nsw", "--epochs", str(CLI_EPOCHS), "--save_dir",
                            saved])
        (name,) = os.listdir(saved)
        ckpt = os.path.join(saved, name)
        tree, meta = load_checkpoint(ckpt)
        lh = res.loss_history
        shapes = [tuple(l["w"].shape) for l in tree["params"]]
        log(f"[cli] train ({CLI_EPOCHS} epochs, cut from 2000): loss "
            f"{lh[0]:.4e} -> {lh[-1]:.4e}; DTW history "
            f"{[(e, round(v, 6)) for e, v in res.dtw_history]}; best DTW "
            f"{res.best_dtw:.6f}; {name}: weights {shapes}, hidden "
            f"{meta['train']['hidden']}")
        if not (np.isfinite(lh).all() and lh[-1] < lh[0]
                and np.isfinite(res.best_dtw)
                and shapes == [(HIDDEN, 28), (25, HIDDEN)]
                and meta["train"]["hidden"] == HIDDEN):
            raise AssertionError(f"cli train: loss {lh[0]} -> {lh[-1]}, best "
                                 f"DTW {res.best_dtw}, weights {shapes}")

        # 2. the hybrid rollout of that checkpoint: K2 with the net against
        # the plain autodiff-Newton scan, both on the card
        trajs = {}
        for label, fast in (("simulate --model --fast", ["--fast"]),
                            ("simulate --model", [])):
            out = os.path.join(d, f"model{len(trajs)}.npz")
            trajs[label] = run(label, ["simulate", "--model", ckpt,
                                       "--steps", str(CLI_MODEL_STEPS),
                                       "--save", out, *fast])
        a, b = (torch.tensor(t) for t in trajs.values())
        ok, e_held = close(a[:CLI_MODEL_HELD], b[:CLI_MODEL_HELD], *ROLLOUT_F32)
        e_all = float((a - b).abs().max())
        log(f"[cli] simulate --model --fast vs --model {tuple(a.shape)}: max "
            f"err {e_held:.3e} over the first {CLI_MODEL_HELD} steps (bar "
            f"rtol/atol {ROLLOUT_F32}), {e_all:.3e} over all {len(a)}; "
            f"finite {bool(torch.isfinite(a).all())} / "
            f"{bool(torch.isfinite(b).all())}")
        if not ok:
            raise AssertionError(f"cli simulate: mega vs scan {e_held:.3e} "
                                 f"beyond {ROLLOUT_F32}")

        # 3. the repo's recorded experiment (a software-in-the-loop
        # recording as per-topic CSVs, tests/fixtures/sil_step_1100):
        # prepare (ingestion, then its rollout on the card: float64, the
        # plain scan) and estimate, where this host has pandas to ingest it
        if have["pandas"]:
            fix_dir = os.path.join(d, "fixture")
            run("prepare (sil_step_1100)",
                ["prepare", os.path.join(HERE, "tests", "fixtures",
                                         "sil_step_1100"),
                 "--out_dir", fix_dir])
            run("estimate (sil_step_1100)",
                ["estimate", "sil_step_1100", "--data_dir", fix_dir])
            prep = np.load(os.path.join(fix_dir, "sil_step_1100.npz"))
            est = np.load(os.path.join(fix_dir,
                                       "sil_step_1100_estimated.npz"))
            T = len(prep["t"])
            log(f"[cli] prepare sil_step_1100: traj {prep['traj'].shape} "
                f"{prep['traj'].dtype}, interpolated "
                f"{prep['interpolated'].shape}; estimate: traj "
                f"{est['traj'].shape}")
            if not (prep["traj"].shape == (T, 10, 50)
                    and prep["traj"].dtype == np.float64
                    and np.isfinite(prep["traj"]).all()
                    and est["traj"].shape == (T, 25, 10)
                    and np.isfinite(est["traj"]).all()):
                raise AssertionError("cli prepare / estimate of the fixture")

        # 4. physics-only K2 rollouts saved as prepare's files of the
        # sinesine preset, then estimate each and train-real on them
        os.makedirs(datas)
        p_sim = K.apply_mod(None, dtype=torch.float32, device=dev)
        p_est = K.make_rod(device=dev)
        for fname, period in zip(cli.REAL_PRESETS["sinesine"], CLI_PERIODS):
            out = os.path.join(d, f"{fname}_sim.npz")
            traj = run(f"simulate --fast ({fname})",
                       ["simulate", "--fast", "--type", "sine", "--arg",
                        str(period), "--steps", str(CLI_SIM_STEPS), "--save",
                        out])
            ctl = np.load(out)["controls"]
            write_prepared(os.path.join(datas, fname + ".npz"), traj, ctl,
                           float(p_sim.del_t))
            run(f"estimate ({fname})", ["estimate", fname, "--data_dir",
                                        datas])
            est = np.load(os.path.join(datas, fname + "_estimated.npz"))
            sim = np.moveaxis(traj, 1, 2).astype(np.float64)  # (T, 50, N)
            grid = fit_curve(sim[:, :7, cli.MARKER_NODES], cli.MARKER_LOC,
                             p_sim.N)
            # the command estimates with the reference's CosseratRod()
            # defaults (del_t 0.005); with the simulated rod's own del_t
            # the velocities must track the simulator's
            # (tests/test_realworld.py:69-78)
            mine, _ = estimate_state(grid, ctl, p_sim)
            v_err = float(np.abs(mine[5:-5, 13:16, 5]
                                 - sim[5:-5, 13:16, 5]).mean())
            ratio = float(p_sim.del_t) / float(p_est.del_t)
            e_cmd = float(np.abs(est["traj"][:, 13:16] / ratio
                                 - mine[:, 13:16]).max())
            log(f"[cli] estimate {fname}: traj {est['traj'].shape}; "
                f"velocities with the simulated rod's del_t vs the "
                f"simulator's: mean abs {v_err:.3e} (bar {EST_VEL_BAR}); the "
                f"command's (del_t {float(p_est.del_t)}) / {ratio:g} vs "
                f"those: max {e_cmd:.3e}")
            if not (v_err < EST_VEL_BAR and e_cmd < 1e-9
                    and np.isfinite(est["traj"]).all()):
                raise AssertionError(f"cli estimate {fname}: velocity error "
                                     f"{v_err:.3e}, command {e_cmd:.3e}")
        res = run("train-real", ["train-real", "--data", "sinesine",
                                 "--data_dir", datas, "--save_path",
                                 os.path.join(d, "real_model")])
        lh = res.loss_history
        log(f"[cli] train-real (sinesine, 300 epochs, hidden {HIDDEN}, "
            f"noise 0.01): loss {lh[0]:.4e} -> {lh[-1]:.4e}")
        if not (np.isfinite(lh).all() and lh[-1] < lh[0]):
            raise AssertionError(f"cli train-real: loss {lh[0]} -> {lh[-1]}")
        torch.cuda.synchronize()
        launches = {"K2": kstep.LAUNCHES, "K3": ksweep.LAUNCHES,
                    "K4": ktrain.LAUNCHES}
    log(f"[cli] {sum(secs.values()):.1f} s in the commands; main-path "
        f"launches: ops.step.LAUNCHES {launches['K2']}, ops.sweep.LAUNCHES "
        f"{launches['K3']}, ops.train.LAUNCHES {launches['K4']}")
    if launches["K2"] == 0 or launches["K4"] == 0:
        raise AssertionError(f"the CLI path missed a kernel: {launches}")
    return launches


def wide_case(K, dev, hidden, data=None, seed=SEED):
    """A wide run's rod, config, net and data: ``data`` (bench_data.npz) at
    28 inputs, or the train-real shape (4 x 120 steps -> 1,904 cells, 53
    inputs, AdamW 0.1, keypoints (1, 3, 6, 9)) on random data made as the
    JAX bench makes it (bench.py:612-623)."""
    from knode_cosserat_tpu_torch.training.loss import DEFAULT_KEYPOINTS_REAL

    p = K.apply_mod("nsw", dtype=torch.float32, device=dev)
    if data is not None:
        cfg = K.TrainConfig(hidden=hidden)
        trajs, ctls = data
    else:
        trajs, ctls = train_real_data(dev, p.N, seed)
        cfg = K.TrainConfig(hidden=hidden, history=True, weight_decay=0.1,
                            keypoints=DEFAULT_KEYPOINTS_REAL)
    net = K.init_mlp(cfg.spec(), torch.Generator().manual_seed(SEED),
                     torch.float32, dev)
    return p, cfg, net, trajs, ctls


def phase_k6(K, dev, errs, small):
    """K6 against its plain version; chunks compose."""
    from knode_cosserat_tpu_torch.ops.train_wide import make_wide_training_run

    cases = [(640, small, SEED, "232 cells, 28 inputs")]
    cases += [(WIDE_HIDDEN, None, s, f"1904 random, seed {s}, 53 inputs, "
               f"AdamW 0.1") for s in RANDOM_SEEDS]
    for hidden, data, seed, name in cases:
        p, cfg, net, trajs, ctls = wide_case(K, dev, hidden, data, seed)
        tol, first = K4_PARAM, ""
        if data is None:
            tol = RANDOM_PARAM
            first = first_epoch(make_wide_training_run, f"K6 {name}", p, cfg,
                                net, trajs, ctls)
        ok, e_loss, e_par, n_out, got = compare_run(
            make_wide_training_run, p, cfg, net, trajs, ctls, 20, tol)
        errs.setdefault("K6", []).extend([e_loss, e_par])
        log(f"[K6] hidden {hidden}, {name}, 20 epochs: loss "
            f"{float(got[1][0]):.4e} -> {float(got[1][-1]):.4e}, max err "
            f"vs plain loss {e_loss:.3e} params {e_par:.3e} (params tol "
            f"{tol}; {n_out} entries beyond {K4_PARAM}){first}")
        if not ok:
            raise AssertionError(f"K6 hidden {hidden}: beyond loss {K4_LOSS} "
                                 f"/ params {tol}: {e_loss:.3e} / "
                                 f"{e_par:.3e}")
        if not float(got[1][-1]) < float(got[1][0]):
            raise AssertionError(f"K6 hidden {hidden}: the loss did not fall")
    # p, cfg, ... are the last train-real case's now
    whole = make_wide_training_run(p, cfg.spec(), cfg, 200)(net, trajs, ctls)
    half = make_wide_training_run(p, cfg.spec(), cfg, 100)
    mid = half(net, trajs, ctls)
    end = half(mid[0], trajs, ctls, mid[2])
    same = (torch.equal(torch.cat([mid[1], end[1]]), whole[1])
            and torch.equal(end[2]["scalars"], whole[2]["scalars"])
            and all(torch.equal(a, b) for a, b in
                    zip(end[0].parameters(), whole[0].parameters())))
    log(f"[K6] hidden {WIDE_HIDDEN}: 100 + 100 epochs == one 200-epoch run, "
        f"bit for bit: {same}")
    if not same:
        raise AssertionError("K6 chunks do not compose bit for bit")


def phase_wide_train(K, dev):
    """The wide training path, counted: train_knode at hidden 8192."""
    from knode_cosserat_tpu_torch.ops import train as ktrain
    from knode_cosserat_tpu_torch.ops import train_wide as kwide

    p, cfg, _, trajs, ctls = wide_case(K, dev, WIDE_HIDDEN)
    cfg.epochs, cfg.log_every = 400, 100
    kwide.LAUNCHES = ktrain.LAUNCHES = 0
    t0 = time.perf_counter()
    r = K.train_knode(p, trajs, ctls, cfg, log=None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K6": kwide.LAUNCHES, "K4": ktrain.LAUNCHES}
    lh = r.loss_history
    log(f"[wide] train_knode hidden {WIDE_HIDDEN}, 1904 cells, {cfg.epochs} "
        f"epochs (cfg.fused='auto'): {wall:.1f} s, epochs_per_sec "
        f"{r.epochs_per_sec:.1f} on {r.device}; loss {lh[0]:.4e} -> "
        f"{lh[-1]:.4e}")
    log(f"[wide] main-path launches: ops.train_wide.LAUNCHES "
        f"{launches['K6']}, ops.train.LAUNCHES {launches['K4']}")
    if launches["K6"] == 0 or not (np.isfinite(lh).all() and lh[-1] < lh[0]):
        raise AssertionError(f"the wide path: launches {launches}, loss "
                             f"{lh[0]} -> {lh[-1]}")
    return launches


def phase_train_timings(K, dev, name_power, small):
    """K5 at 40 cells and K6 at hidden 8192, 200 epochs each, against
    their plain versions and bounds; K6 against the plain epoch loop."""
    from knode_cosserat_tpu_torch.models.mlp import StackedMLP
    from knode_cosserat_tpu_torch.ops import train as ktrain
    from knode_cosserat_tpu_torch.ops import train_wide as kwide
    from knode_cosserat_tpu_torch.training.train import (make_epoch_scan,
                                                         make_optimizer)

    tag = f"[{name_power}]"
    E, out = 200, {}
    cfg = K.TrainConfig(hidden=HIDDEN)
    hyper = ktrain._hyper(cfg)

    # K5: 40 cells on bench_data.npz (the JAX bench's grid)
    G = 40
    trajs, ctls = small
    spec = cfg.spec()
    cells = [ktrain.precompute(K.apply_mod(MODS[g % 4], dtype=torch.float32,
                                           device=dev), spec, cfg.keypoints,
                               trajs, ctls) for g in range(G)]
    nets = StackedMLP([K.init_mlp(spec, torch.Generator().manual_seed(g),
                                  torch.float32, dev) for g in range(G)])
    W = [t.detach() for wb in nets.weights() for t in wb]
    state = ktrain._stack_states([ktrain.fresh_state([w[g] for w in W])
                                  for g in range(G)])
    kern = timed(lambda: ktrain.train_grid_run(cells, W, state, E, hyper), 3)
    plain = timed(lambda: ktrain.train_grid_reference(cells, W, state, E,
                                                      hyper), 1)
    C, din = cells[0].x.shape
    n_params = HIDDEN * (din + 25) + HIDDEN + 25
    flops = G * E * 2 * C * HIDDEN * (2 * din + 75)
    nbytes = G * 4 * (C * (din + 56) + 6 * n_params + E + 8)
    b_ms, b_by = bound(flops, nbytes)
    out["K5"] = dict(ms=kern, plain_ms=plain, bound_ms=b_ms, bound_by=b_by)
    log(f"[time] K5 {E} epochs, {G} runs x {C} cells, hidden {HIDDEN} f32: "
        f"kernel {kern:.3f} ms ({G * E / kern * 1e3:.1f} models x epochs/s), "
        f"plain {plain:.3f} ms, bound {b_ms:.4f} ms ({b_by}; "
        f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB), "
        f"{100 * b_ms / kern:.2f}% of the bound; plan: "
        f"{k4_plan_line(ktrain, din, HIDDEN, dev)} {tag}")

    # K6 at the train-real shape, and the plain epoch loop beside it
    for hidden in (1024, 2048, WIDE_HIDDEN):
        p, wcfg, net, wt, wc = wide_case(K, dev, hidden)
        wspec = wcfg.spec()
        cw = ktrain.precompute(p, wspec, wcfg.keypoints, wt, wc)
        Ww = [t.detach() for wb in net.weights() for t in wb]
        st = ktrain.fresh_state(Ww)
        wh = ktrain._hyper(wcfg)
        kern = timed(lambda: kwide.train_run(cw, Ww, st, E, wh), 3)
        loop_net = K.init_mlp(wspec, torch.Generator().manual_seed(SEED),
                              torch.float32, dev)
        loop = make_epoch_scan(p, wspec, make_optimizer(wcfg, loop_net),
                               wcfg.keypoints, wcfg.clamp_weights, E)
        loop_ms = timed(lambda: loop(loop_net, wt, wc), 1)
        C, din = cw.x.shape
        line = (f"[time] K6 {E} epochs, {C} cells, hidden {hidden}, {din} "
                f"inputs f32: kernel {kern:.3f} ms ({E / kern * 1e3:.1f} "
                f"epochs/s), plain epoch loop {loop_ms:.3f} ms "
                f"({E / loop_ms * 1e3:.1f} epochs/s)")
        if hidden == WIDE_HIDDEN:
            plain = timed(lambda: ktrain.train_run_reference(cw, Ww, st, E,
                                                             wh), 1)
            n_params = hidden * (din + 25) + hidden + 25
            flops = E * 2 * C * hidden * (2 * din + 75)
            nbytes = 4 * (C * (din + 56) + 6 * n_params + E + 8)
            b_ms, b_by = bound(flops, nbytes)
            out["K6"] = dict(ms=kern, plain_ms=plain, bound_ms=b_ms,
                             bound_by=b_by)
            mm = timed(lambda: epoch_products(cw, Ww), 20) * E
            plan = kwide.launch_plan(din, hidden, C)
            line += (f", plain version {plain:.3f} ms, bound {b_ms:.4f} ms "
                     f"({b_by}; {flops / 1e9:.2f} GFLOP, "
                     f"{nbytes / 1e6:.2f} MB), {100 * b_ms / kern:.2f}% of "
                     f"the bound; one epoch's products as torch.matmul "
                     f"(f32) x {E}: {mm:.3f} ms (reported, not gated); plan: "
                     f"forward {plan.fwd_units} units x {plan.fwd_cells} "
                     f"cells, backward {plan.bwd_units} units x "
                     f"{plan.slices} slices of {plan.chunks} x "
                     f"{plan.bwd_cells} cells")
        log(line + f" {tag}")
    return out


def epoch_products(cells, W):
    """One epoch's matrix products of the wide trainer in plain float32
    torch.matmul (the caller disables TF32): A = X W1^T, NN = H W2^T,
    dH = G W2, dW1 = dA^T X, dW2 = G^T H. A yardstick for K6's product
    work alone (no loss, ELU or update), not a version of K6."""
    W1, _, W2, _ = W
    X = cells.x
    A = X @ W1.t()
    NN = A @ W2.t()
    G = NN                      # stands in for the cotangent's shape
    dH = G @ W2
    return dH.t() @ X, G.t() @ A



# ------------------------------------------------ assemblies (K7) and K8

def assembly_controls(asm, T, amps=ASM_AMPS):
    """(T, M, 4) sine tensions, amplitude parameter amps[i] for rod i (the
    JAX bench's schedule, bench.py:517-525)."""
    from knode_cosserat_tpu_torch.controls import calc_controls

    dt = float(asm.rods[0].del_t)
    return torch.tensor(np.stack([calc_controls("sine", a, dt, T)
                                  for a in amps[:asm.M]], axis=1),
                        dtype=asm.dtype, device=asm.device)


def assembly_rollout(asm, ctl, solve_fn, tol):
    """The coupled rollout with a given root solver (K7 or its plain
    version): G (T-1, M, 6), plate poses (T-1, 7), y (T-1, M, N, 19),
    iterations (T-1,), final residual norms (T-1,)."""
    from knode_cosserat_tpu_torch.core.assembly import (AssemblyCarry,
                                                        assembly_step_carry)
    carry, out = AssemblyCarry.initial(asm), [[] for _ in range(5)]
    with torch.no_grad():
        for u in ctl[:-1]:
            carry, rec, plate7, G, stats = assembly_step_carry(
                asm, carry, u, tol=tol, solve_fn=solve_fn)
            for lst, v in zip(out, (G, plate7, rec[..., :19],
                                    stats.iterations, stats.residual_norm)):
                lst.append(v)
    return tuple(torch.stack(v) for v in out)


def straddles(roll_a, roll_b, tol):
    """How many steps of two rollouts (assembly_rollout) the solvers end
    one Newton iteration apart, both converged (r2 <= tol); -1 if any step
    ends further apart or unconverged."""
    n = 0
    for a, b, ra, rb in zip(roll_a[3].tolist(), roll_b[3].tolist(),
                            roll_a[4].tolist(), roll_b[4].tolist()):
        if a != b:
            if abs(a - b) > 1 or max(ra, rb) ** 2 > tol:
                return -1
            n += 1
    return n


def plain_k7(asm, tol, max_iter=50):
    """K7's plain version as a root solver (on the card)."""
    from knode_cosserat_tpu_torch.ops.assembly import assembly_step_reference
    return lambda *a: assembly_step_reference(asm, *a, tol=tol,
                                              max_iter=max_iter)


def step_args(asm, ctl, t, tol=1e-10):
    """K7's inputs at step t of the rollout under ``ctl``, captured from
    assembly_step_carry (these launches are not the main path's)."""
    from knode_cosserat_tpu_torch.ops.assembly import make_assembly_step_kernel
    k, grab = make_assembly_step_kernel(asm, tol=tol), []
    assembly_rollout(asm, ctl[:t + 2],
                     lambda *a: grab.append(a) or k(*a), tol)
    return grab[t]


def rel_close(a, b, rel):
    """(ok, max |a-b| / max |b|)."""
    e = float((a.double() - b.double()).abs().max()) / max(
        float(b.double().abs().max()), 1e-300)
    return e <= rel and bool(torch.isfinite(a).all()), e


def phase_k7(K, dev, errs):
    """K7 against its plain version on the card: f64 one step and 20-step
    rollouts at M=2 (N=6) and M=3 (N=10), one step at M=6 and M=9 (N=10);
    f32 at the bench configuration inside the f64-truth envelope of the
    plain coupled Newton."""
    from knode_cosserat_tpu_torch.core.assembly import (make_ring_assembly,
                                                        simulate_assembly)
    from knode_cosserat_tpu_torch.ops.assembly import (
        assembly_step_reference, make_assembly_step_kernel)

    f64 = torch.float64
    for M, N in ((2, 6), (3, 10), (6, 10), (9, 10)):
        asm = make_ring_assembly(n_rods=M, base_radius=0.05, N=N, dtype=f64,
                                 device=dev)
        ctl = assembly_controls(asm, 21, ASM_AMPS if M <= 3
                                else np.linspace(0.7, 1.3, M))
        k = make_assembly_step_kernel(asm, tol=K7_TOL64, max_iter=30)
        ins = step_args(asm, ctl, 3, K7_TOL64)
        got = k(*ins)
        want = assembly_step_reference(asm, *ins, tol=K7_TOL64, max_iter=30)
        torch.cuda.synchronize()
        bar = K7_F64 if M <= 3 else K7_F64_WIDE
        ok_x, e_x = close(got[0], want[0], 0.0, bar)
        ok_y, e_y = rel_close(got[1], want[1], bar)
        ok_z, e_z = rel_close(got[2], want[2], bar)
        same_it = int(got[4]) == int(want[4])
        errs.setdefault("K7", []).append(e_x)
        if M > 3:
            log(f"[K7] f64 M={M} N={N:2d} one step: X {e_x:.3e} y {e_y:.3e} "
                f"(rel) z {e_z:.3e} (rel), iterations {int(got[4])} (plain "
                f"{int(want[4])})")
            if not (ok_x and ok_y and ok_z and same_it):
                raise AssertionError(f"K7 f64 M={M} N={N} beyond {bar} or "
                                     f"iterations differ")
            continue
        roll_k = assembly_rollout(asm, ctl, k, K7_TOL64)
        roll_p = assembly_rollout(asm, ctl, plain_k7(asm, K7_TOL64, 30),
                                  K7_TOL64)
        ok_g, e_g = close(roll_k[0], roll_p[0], 0.0, K7_F64)
        ok_p, e_p = close(roll_k[1], roll_p[1], 0.0, K7_F64)
        ok_ry, e_ry = rel_close(roll_k[2], roll_p[2], K7_F64)
        torch.cuda.synchronize()
        apart = straddles(roll_k, roll_p, K7_TOL64)
        errs["K7"].extend([e_g, e_p])
        log(f"[K7] f64 M={M} N={N:2d} one step: X {e_x:.3e} y {e_y:.3e} (rel) "
            f"z {e_z:.3e} (rel), iterations {int(got[4])} (plain "
            f"{int(want[4])}); 20 steps: G {e_g:.3e} plate {e_p:.3e} y "
            f"{e_ry:.3e} (rel), iterations {roll_k[3].tolist()} (plain "
            f"{roll_p[3].tolist()}), {apart} steps one apart")
        if not (ok_x and ok_y and ok_z and same_it and ok_g and ok_p
                and ok_ry and 0 <= apart <= K7_STRADDLES):
            raise AssertionError(f"K7 f64 M={M} N={N} beyond {K7_F64} or "
                                 f"iterations differ")

    # f32 at the bench configuration: both K7 and its plain version inside
    # the f64 truth's envelope of the plain coupled Newton in f32 (the JAX
    # package's test, tests/test_assembly_fused.py)
    asm32 = make_ring_assembly(**ASM_CFG, dtype=torch.float32, device=dev)
    ctl = assembly_controls(asm32, 21)
    asm64 = make_ring_assembly(**ASM_CFG, dtype=f64, device="cpu")
    truth = simulate_assembly(asm64, ctl.cpu().double(), tol=1e-24)
    plain = simulate_assembly(asm32, ctl)
    k = make_assembly_step_kernel(asm32, tol=1e-10)
    runs = {"K7": assembly_rollout(asm32, ctl, k, 1e-10),
            "plain version": assembly_rollout(asm32, ctl,
                                              plain_k7(asm32, 1e-10), 1e-10)}
    torch.cuda.synchronize()
    err = lambda a, b: float((a.cpu().double() - b).abs().max())
    eG_n = err(plain.Gs[1:], truth.Gs[1:])
    ep_n = err(plain.plate_pose[1:], truth.plate_pose[1:])
    parts = []
    for name, (Gs, plates, _, its, _) in runs.items():
        eG, ep = err(Gs, truth.Gs[1:]), err(plates, truth.plate_pose[1:])
        parts.append(f"{name} G {eG:.3e} plate {ep:.3e} iters max "
                     f"{int(its.max())}")
        if not (eG < 3.0 * eG_n + 1e-6 and ep < 3.0 * ep_n + 1e-7):
            raise AssertionError(f"K7 f32 ({name}) outside the envelope: G "
                                 f"{eG:.3e} vs {eG_n:.3e}, plate {ep:.3e} vs "
                                 f"{ep_n:.3e}")
    res_k = float(plain.residual_norm.max())
    log(f"[K7] f32 M=3 N=10, 20 steps, errors against the f64 truth: plain "
        f"coupled Newton G {eG_n:.3e} plate {ep_n:.3e} (residual max "
        f"{res_k:.3e}); " + "; ".join(parts))


def phase_assembly(K, dev):
    """Path A, counted: simulate_assembly(fused=True) at the bench's
    configuration (T=101 and T=1001), the plain coupled Newton (T=21) and
    the CLI's simulate-assembly."""
    from knode_cosserat_tpu_torch import cli
    from knode_cosserat_tpu_torch.core.assembly import (make_ring_assembly,
                                                        simulate_assembly)
    from knode_cosserat_tpu_torch.ops import assembly as kasm

    asm = make_ring_assembly(**ASM_CFG, dtype=torch.float32, device=dev)
    simulate_assembly(asm, assembly_controls(asm, 3), fused=True)  # warm
    launches, secs, out = 0, {}, None
    for T in (101, 1001):
        ctl = assembly_controls(asm, T)
        torch.cuda.synchronize()
        kasm.LAUNCHES = 0
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = simulate_assembly(asm, ctl, fused=True)
        end.record()
        torch.cuda.synchronize()
        secs[T] = start.elapsed_time(end) / 1e3
        if kasm.LAUNCHES != T - 1:
            raise AssertionError(f"path A, T={T}: {kasm.LAUNCHES} K7 "
                                 f"launches, want {T - 1}")
        if not bool(torch.isfinite(out.plate_pose).all()):
            raise AssertionError(f"path A, T={T}: non-finite plate pose")
        launches += kasm.LAUNCHES
        log(f"[assembly] simulate_assembly(fused=True) M=3 N=10 f32 T={T}: "
            f"{secs[T]:.3f} s = {(T - 1) / secs[T]:.1f} steps/s; K7 launches "
            f"{kasm.LAUNCHES}; Newton iterations mean "
            f"{float(out.newton_iters[1:].float().mean()):.2f} max "
            f"{int(out.newton_iters.max())}, residual max "
            f"{float(out.residual_norm.max()):.3e}")
    marginal = 900 / (secs[1001] - secs[101])
    ctl = assembly_controls(asm, 21)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = simulate_assembly(asm, ctl)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    gap = float((plain.plate_pose - out.plate_pose[:21]).abs().max())
    log(f"[assembly] marginal rate (T=1001 - T=101): {marginal:.1f} steps/s;"
        f" plain coupled Newton (fused=False, solver dense) T=21: "
        f"{t_plain:.3f} s = {20 / t_plain:.1f} steps/s, plate pose vs K7 "
        f"max {gap:.3e}")
    path = os.path.join(HERE, "build", "assembly", "assembly.npz")
    cli.main(["simulate-assembly", "--steps", "20", "--save", path])
    d = np.load(path)
    shapes = {k: d[k].shape for k in d.files}
    want = {"traj": (20, 3, 10, 50), "plate_pose": (20, 7),
            "controls": (20, 3, 4)}
    log(f"[assembly] CLI simulate-assembly --steps 20: {shapes}")
    if shapes != want or not np.isfinite(d["traj"]).all():
        raise AssertionError(f"CLI simulate-assembly wrote {shapes}")
    return dict(launches=launches, steps_per_sec={T: (T - 1) / s for T, s in
                                                  secs.items()},
                marginal=marginal, plain_steps_per_sec=20 / t_plain)


def phase_assembly_mpc(K, dev):
    """Path B, counted: one fused plate-pose plan at the bench's assembly
    (horizon 8, 40 Adam iterations, the JAX defaults but w_du = 0, see
    MPC_MOVE); then the f64 gradient of its tracking cost at the start
    through K7's roots against the gradient through the plain Newton's."""
    from knode_cosserat_tpu_torch.control import (make_assembly_planner,
                                                  rollout_plate)
    from knode_cosserat_tpu_torch.core.assembly import (AssemblyCarry,
                                                        make_ring_assembly)
    from knode_cosserat_tpu_torch.ops import assembly as kasm

    H = 8
    asm = make_ring_assembly(**ASM_CFG, dtype=torch.float32, device=dev)
    carry = AssemblyCarry.initial(asm)
    # the target: a sway of 1 cm in x and a lift of 0.1 mm, ramped over
    # the horizon from the plate's start
    ramp = torch.arange(1, H + 1, dtype=asm.dtype, device=dev)[:, None] / H
    target = carry.pp + ramp * torch.tensor(MPC_MOVE, dtype=asm.dtype,
                                            device=dev)
    plan = make_assembly_planner(asm, H, fused=True, w_du=0.0)
    torch.cuda.synchronize()
    kasm.LAUNCHES = 0
    t0 = time.perf_counter()
    r = plan(carry, target)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = kasm.LAUNCHES
    costs = r.cost_history.cpu().numpy()
    log(f"[mpc] make_assembly_planner(fused=True) M=3 N=10 f32, horizon {H},"
        f" 40 iterations, w_du 0, target plate move {MPC_MOVE} m: "
        f"{secs:.2f} s, "
        f"K7 launches {launches}; cost "
        f"{costs[0]:.4e} -> {costs[-1]:.4e} (final {float(r.cost):.4e}); "
        f"history {np.array2string(costs[::8], precision=3)}")
    if launches == 0 or not (np.isfinite(costs).all()
                             and costs[-1] < costs[0]):
        raise AssertionError(f"path B: launches {launches}, cost "
                             f"{costs[0]} -> {costs[-1]}")

    asm64 = make_ring_assembly(**ASM_CFG, dtype=torch.float64, device=dev)
    c64, tgt = AssemblyCarry.initial(asm64), target.double()
    solve = kasm.make_assembly_step_kernel(asm64, tol=1e-20)
    grads = []
    for solve_fn in (solve, None):
        logits = torch.zeros((H, 3, 4), dtype=torch.float64, device=dev,
                             requires_grad=True)
        u = 20.0 * torch.sigmoid(logits)
        plates, _ = rollout_plate(asm64, c64, u, tol=1e-20, solve_fn=solve_fn)
        cost = ((plates[:, :3] - tgt) ** 2).sum(-1).mean()
        grads.append(torch.autograd.grad(cost, logits)[0])
    e = float((grads[0] - grads[1]).abs().max() / grads[1].abs().max())
    log(f"[mpc] f64 gradient of the plan's first cost: through K7's roots vs "
        f"through the plain Newton's, max relative error {e:.3e} (rtol "
        f"{MPC_GRAD_RTOL})")
    if not e <= MPC_GRAD_RTOL:
        raise AssertionError(f"path B gradient: {e:.3e} > {MPC_GRAD_RTOL}")
    return dict(launches=launches, seconds=secs, cost=(costs[0], costs[-1]))


def k8_cells(K, p, spec, net, trajs, ctls, keypoints):
    """The flat cells path C hands K8 (captured from grow_predictions)."""
    from knode_cosserat_tpu_torch.training.loss import grow_predictions

    grab = []
    grow_predictions(p, spec, net, trajs, ctls, keypoints,
                     fused_fn=lambda n, *xs: grab.append(xs) or xs[::2])
    return grab[0]


def k8_cases(K, dev, small):
    """(label, rod, spec, net, trajs, ctls, keypoints) at path C's two
    shapes: bench_data.npz at for_knode(512) (232 cells) and the
    train-real shape (53 inputs, 1,904 cells, train_real_data)."""
    from knode_cosserat_tpu_torch.training.loss import DEFAULT_KEYPOINTS_REAL

    p, cfg, net = train_setup(K, dev)
    out = [("232 cells, 28 inputs", p, cfg, net, small[0].float(),
            small[1].float())]
    p, cfg, net = train_setup(K, dev, history=True, weight_decay=0.1,
                              keypoints=DEFAULT_KEYPOINTS_REAL)
    out.append(("1904 cells, 53 inputs", p, cfg, net,
                *train_real_data(dev)))
    return out


def phase_k8(K, dev, errs, small):
    """K8 against its plain version on path C's cells, f64 and f32."""
    from knode_cosserat_tpu_torch.ops.next_segment import (
        make_fused_next_segment, next_segment_reference)

    for label, p, cfg, net, trajs, ctls in k8_cases(K, dev, small):
        for dtype in (torch.float64, torch.float32):
            pd = K.apply_mod("nsw", dtype=dtype, device=dev)
            nd = K.init_mlp(cfg.spec(), torch.Generator().manual_seed(SEED),
                            dtype, dev)
            cells = [c.to(dtype) for c in k8_cells(
                K, pd, cfg.spec(), nd, trajs.to(dtype), ctls.to(dtype),
                cfg.keypoints)]
            W = [t for wb in nd.weights() for t in wb]
            with torch.no_grad():
                got = make_fused_next_segment(pd, cfg.spec())(nd, *cells)
                want = next_segment_reference(pd, cfg.spec(), *cells, *W)
            torch.cuda.synchronize()
            parts, ok = [], True
            for name, a, b in zip(("y_grown", "z"), got, want):
                o, e = close(a, b, *K8_TOL[dtype])
                ok = ok and o
                parts.append(f"{name} {e:.3e}")
                errs.setdefault(("K8", dtype), []).append(e)
            log(f"[K8] {label} {str(dtype)[6:]}: max err vs plain "
                + "  ".join(parts) + f" (rtol, atol {K8_TOL[dtype]})")
            if not ok:
                raise AssertionError(f"K8 {label} {dtype} beyond "
                                     f"{K8_TOL[dtype]}")


def phase_fused_train(K, dev, small):
    """Path C, counted: make_train_step(use_pallas=True) against the plain
    step from the same net, FUSED_STEPS steps on bench_data.npz and 20 at
    the train-real shape (f32; losses within FUSED_LOSS_RTOL)."""
    import copy

    from knode_cosserat_tpu_torch.ops import next_segment as kseg
    from knode_cosserat_tpu_torch.training.train import (make_optimizer,
                                                         make_train_step)

    launches = 0
    for (label, p, cfg, net, trajs, ctls), n in zip(k8_cases(K, dev, small),
                                                    (FUSED_STEPS, 20)):
        losses, secs = {}, {}
        for fused in (True, False):
            nt = copy.deepcopy(net)
            step, _ = make_train_step(p, cfg.spec(), make_optimizer(cfg, nt),
                                      cfg.keypoints, cfg.clamp_weights,
                                      use_pallas=fused)
            torch.cuda.synchronize()
            kseg.LAUNCHES = 0
            t0 = time.perf_counter()
            losses[fused] = torch.stack([step(nt, trajs, ctls)
                                         for _ in range(n)])
            torch.cuda.synchronize()
            secs[fused] = time.perf_counter() - t0
            if fused:
                launches += kseg.LAUNCHES
                n_k8 = kseg.LAUNCHES
        ok, e = close(losses[True], losses[False], FUSED_LOSS_RTOL, 0.0)
        lf = losses[True]
        log(f"[fused] {label}: {n} make_train_step(use_pallas=True) steps "
            f"{secs[True]:.2f} s ({n / secs[True]:.1f} steps/s), plain "
            f"{secs[False]:.2f} s ({n / secs[False]:.1f} steps/s); loss "
            f"{float(lf[0]):.4e} -> {float(lf[-1]):.4e}, max err vs plain "
            f"{e:.3e} (rtol {FUSED_LOSS_RTOL}); K8 launches {n_k8}")
        if not ok or n_k8 != n:
            raise AssertionError(f"path C {label}: losses beyond "
                                 f"{FUSED_LOSS_RTOL} ({e:.3e}) or K8 "
                                 f"launches {n_k8} != {n}")
    return dict(launches=launches)


def device_ms(fn, n, kernel, module):
    """(ms, seen): ms per launch of the kernel whose name contains
    ``kernel``, device time by torch.profiler over n calls of fn after one
    warm-up call (the wrappers of K7 and K8 cost the host as much as or
    more than their kernels take on the card, so CUDA events around a call
    time the host too). ``module.LAUNCHES`` counts the launches of the
    same window and must be n. The profiler is only a clock: it drops
    kernel records now and then (49 of 50 and 37 of 50 on the card), so
    the mean is over the ``seen`` records it kept; a window in which it
    kept none is run again, twice at most."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        module.LAUNCHES = 0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        launched = module.LAUNCHES
        if launched != n:
            raise AssertionError(f"{kernel}: {launched} launches of {n} "
                                 f"calls")
        total = count = 0
        for e in prof.key_averages():
            if kernel in e.key:
                total += (getattr(e, "device_time_total", None)
                          or e.cuda_time_total)
                count += e.count
        if count > launched:
            raise AssertionError(f"{kernel}: {launched} launches, the "
                                 f"profiler recorded {count}")
        if count:
            return total / count / 1e3, count
    raise AssertionError(f"{kernel}: the profiler recorded no launch in "
                         f"three windows of {n}")


def k7_bound(asm, iters):
    """(ms, by) for one K7 launch that took ``iters`` Newton iterations
    (f32): per iteration the 20M rod sweeps the step needs (each rod's
    base and its 12 probes, 7 line-search candidates), each N-1 nodes of
    physics, and the elimination's U^3 multiply-adds; plus the first
    residual's and the recording's M sweeps each."""
    M, N = asm.M, asm.N
    U = 6 * M + 7
    sweep = (N - 1) * PHYS_FLOPS
    flops = iters * (20 * M * sweep + 2 * U ** 3) + 2 * M * sweep
    nbytes = (4 * (2 * U + M * N * 25 + 3 * M + 13 + M * N * 19
                   + M * (N - 1) * 6 + 2) + 8 * (M * 76 + 14 + 7 * M))
    return bound(flops, nbytes)


def phase_k7_k8_timings(K, dev, name_power, small):
    """K7 per launch at M = 3, 6, 9 (N=10, f32, the inputs of step 5 of the
    sine rollout) and K8 at path C's two shapes: the wrapper's call by CUDA
    events (``ms``, the clock of every other kernel's row) beside the
    kernel's device time (``device_ms``), its plain version and its
    bound."""
    from knode_cosserat_tpu_torch.core.assembly import make_ring_assembly
    from knode_cosserat_tpu_torch.ops import assembly as kasm
    from knode_cosserat_tpu_torch.ops import next_segment as kseg
    from knode_cosserat_tpu_torch.ops.assembly import (
        assembly_step_reference, make_assembly_step_kernel)
    from knode_cosserat_tpu_torch.ops.next_segment import (
        make_fused_next_segment, next_segment_reference)

    tag = f"[{name_power}]"
    out = {}
    for M in (3, 6, 9):
        asm = make_ring_assembly(n_rods=M, base_radius=0.05, N=10,
                                 dtype=torch.float32, device=dev)
        ins = step_args(asm, assembly_controls(asm, 8, np.linspace(
            0.7, 1.3, M)), 5)
        k = make_assembly_step_kernel(asm)
        kern, seen = device_ms(lambda: k(*ins), 20, "assembly_kernel", kasm)
        call = timed(lambda: k(*ins), 20)
        plain = timed(lambda: assembly_step_reference(asm, *ins), 1)
        iters = int(k(*ins)[4])
        b_ms, b_by = k7_bound(asm, iters)
        out[f"K7 M={M}"] = dict(ms=call, device_ms=kern, plain_ms=plain,
                                bound_ms=b_ms, bound_by=b_by, iters=iters)
        log(f"[time] K7 one coupled step M={M} N=10 f32 ({iters} Newton "
            f"iterations): the wrapper's call {call:.4f} ms (device time "
            f"{kern:.4f} ms over {seen} of 20 launches), plain {plain:.3f} "
            f"ms, bound {b_ms:.6f} ms ({b_by}); plan {tuple(kasm.launch_plan(asm.dtype, M, 10))} "
            f"{tag}")
    for label, p, cfg, net, trajs, ctls in k8_cases(K, dev, small):
        spec = cfg.spec()
        cells = k8_cells(K, p, spec, net, trajs, ctls, cfg.keypoints)
        W = [t.detach() for wb in net.weights() for t in wb]
        fn = make_fused_next_segment(p, spec)
        with torch.no_grad():
            kern, seen = device_ms(lambda: fn(net, *cells), 50,
                                   "next_segment_kernel", kseg)
            call = timed(lambda: fn(net, *cells), 50)
            plain = timed(lambda: next_segment_reference(p, spec, *cells, *W),
                          50)
        B, din = cells[0].shape[0], spec.dims[0]
        n_w = HIDDEN * (din + 25) + HIDDEN + 25
        b_ms, b_by = bound(B * node_flops(HIDDEN, din),
                           4 * (B * (19 + 19 + 6 + 3 + 19 + 6) + n_w))
        out[f"K8 {B}"] = dict(ms=call, device_ms=kern, plain_ms=plain,
                              bound_ms=b_ms, bound_by=b_by)
        log(f"[time] K8 next segment, {label}, hidden {HIDDEN} f32: the "
            f"wrapper's call {call:.4f} ms (device time {kern:.4f} ms over "
            f"{seen} of 50 launches), plain "
            f"{plain:.4f} ms, bound {b_ms:.6f} ms "
            f"({b_by}); plan {tuple(kseg.launch_plan(p.dtype, din, HIDDEN, B))} "
            f"{tag}")
    return out


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
    serve = phase_serving(K, dev)
    data = phase_k4(K, dev, errs)
    train, _ = phase_train(K, dev)
    phase_k5(K, dev, errs, data[0])
    multi, grid = phase_multitrain(K, dev)
    clis = phase_cli(K, dev, name_power)
    nsw = [n for c, n in zip(grid.cells, grid.params) if c.mod == "nsw"]
    check_step_per_rod(K, dev, errs, K.apply_mod("nsw", dtype=torch.float32,
                                                 device=dev), nsw,
                       "the multitrain's trained nsw nets")
    phase_k6(K, dev, errs, data[0])
    wide = phase_wide_train(K, dev)
    phase_k7(K, dev, errs)
    asm = phase_assembly(K, dev)
    mpc = phase_assembly_mpc(K, dev)
    phase_k8(K, dev, errs, data[0])
    fused = phase_fused_train(K, dev, data[0])
    ms = phase_timings(K, dev, name_power)
    k4 = phase_k4_timings(K, dev, name_power, data)["232"]
    tt = phase_train_timings(K, dev, name_power, data[0])
    t78 = phase_k7_k8_timings(K, dev, name_power, data[0])
    k7_launches = asm["launches"] + mpc["launches"]

    # bounds at the timed shapes (float32, hidden 512, 28 inputs, N=10)
    R, f_node = 256, node_flops(HIDDEN, 28)
    w_bytes = 4 * (HIDDEN * (28 + 25) + HIDDEN + 25)
    k1_bound = bound(R * 7 * f_node, w_bytes + 4 * R * 7 * (6 + 38 + 12 + 3 + 6))
    k3_bound = bound(R * 7 * 9 * f_node,
                     w_bytes + 4 * R * 7 * (6 + 190 + 60 + 3 + 6))
    k2_bound = ms["K2_bound"]
    src = "knode_cosserat_tpu_torch/csrc/"
    k3_err = max(errs[("K3", torch.float32)] + errs[("K3", torch.float64)])
    k1_err = max(k3_err, ms["K1_err"])
    row = lambda b: {"bound_ms": b[0], "bound_by": b[1], "library_ms": None}
    kernels = [
        {"name": "K1 rhs_rows (hybrid per-node RHS, inlined in K2/K3/K7/K8; "
                 "rhs_node_coop redesigned)",
         "route": "cuda", "source": src + "rhs_rows.cuh",
         "replaces": "knode_cosserat_tpu/ops/pallas_sweep.py:93",
         "launches": (serve["K2"] + serve["K3"] + train["K2"] + train["K3"]
                      + multi["K2"] + multi["K3"] + clis["K2"] + clis["K3"]
                      + k7_launches
                      + fused["launches"]),
         "max_abs_err": k1_err, "ms": ms["K1"][0], "plain_ms": ms["K1"][1],
         **row(k1_bound)},
        {"name": "K3 sweep (hybrid: one warp per lane, redesigned)",
         "route": "cuda", "source": src + "sweep.cu",
         "replaces": "knode_cosserat_tpu/ops/pallas_sweep.py:201",
         "launches": serve["K3"] + train["K3"] + multi["K3"] + clis["K3"],
         "max_abs_err": k3_err,
         "ms": ms["K3"][0], "plain_ms": ms["K3"][1], **row(k3_bound)},
        {"name": "K2 step (256 rods; one block per rod, redesigned)",
         "route": "cuda", "source": src + "step.cu",
         "replaces": "knode_cosserat_tpu/ops/pallas_step.py:57",
         "launches": serve["K2"] + train["K2"] + multi["K2"] + clis["K2"],
         "max_abs_err": max(errs[("K2", torch.float32)]
                            + errs[("K2", torch.float64)]),
         "ms": ms["K2"][0], "plain_ms": ms["K2"][1], **row(k2_bound)},
        {"name": "K4 train (whole training run, 200-epoch chunk, 232 cells; "
                 "a cluster of 8 blocks per run, redesigned)",
         "route": "cuda", "source": src + "train.cu",
         "replaces": "knode_cosserat_tpu/ops/pallas_train.py:345",
         "launches": train["K4"] + multi["K4"] + wide["K4"] + clis["K4"],
         "max_abs_err": max(errs["K4"]),
         "ms": k4["ms"], "plain_ms": k4["plain_ms"],
         **row((k4["bound_ms"], k4["bound_by"]))},
        {"name": "K5 train grid (40 runs x 232 cells, 200 epochs; K4's "
                 "redesigned kernel, a cluster per run)",
         "route": "cuda", "source": src + "train.cu",
         "replaces": "knode_cosserat_tpu/ops/pallas_train.py:692",
         "launches": multi["K5"], "max_abs_err": max(errs["K5"]),
         "ms": tt["K5"]["ms"], "plain_ms": tt["K5"]["plain_ms"],
         **row((tt["K5"]["bound_ms"], tt["K5"]["bound_by"]))},
        {"name": f"K6 train wide (hidden {WIDE_HIDDEN}, 1904 cells, 200 "
                 f"epochs; register-tiled products, redesigned)",
         "route": "cuda", "source": src + "train_wide.cu",
         "replaces": "knode_cosserat_tpu/ops/pallas_train_wide.py:158",
         "launches": wide["K6"], "max_abs_err": max(errs["K6"]),
         "ms": tt["K6"]["ms"], "plain_ms": tt["K6"]["plain_ms"],
         **row((tt["K6"]["bound_ms"], tt["K6"]["bound_by"]))},
        {"name": "K7 assembly step (M=3, N=10, one coupled BDF-2 step; a "
                 "thread per rod sweep the step needs, redesigned)",
         "route": "cuda", "source": src + "assembly.cu",
         "replaces": "knode_cosserat_tpu/ops/pallas_assembly.py:84",
         "launches": k7_launches, "max_abs_err": max(errs["K7"]),
         "ms": t78["K7 M=3"]["ms"], "device_ms": t78["K7 M=3"]["device_ms"],
         "plain_ms": t78["K7 M=3"]["plain_ms"],
         **row((t78["K7 M=3"]["bound_ms"], t78["K7 M=3"]["bound_by"]))},
        {"name": "K8 next segment (232 cells, 28 inputs, hidden 512; a "
                 "warp per cell over rhs_node_coop, redesigned)",
         "route": "cuda", "source": src + "next_segment.cu",
         "replaces": "knode_cosserat_tpu/ops/pallas_rhs.py:65",
         "launches": fused["launches"],
         "max_abs_err": max(errs[("K8", torch.float32)]
                            + errs[("K8", torch.float64)]),
         "ms": t78["K8 232"]["ms"], "device_ms": t78["K8 232"]["device_ms"],
         "plain_ms": t78["K8 232"]["plain_ms"],
         **row((t78["K8 232"]["bound_ms"], t78["K8 232"]["bound_by"]))},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
