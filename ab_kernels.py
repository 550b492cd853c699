"""A B B A timing of the port's kernels in two checkouts on one card.

    python3 ab_kernels.py PARENT_DIR THIS_DIR

Four turns, A B B A (A is PARENT_DIR), each a process of its own that runs
this file's timing code against one checkout's package (that checkout
first on ``sys.path``, its kernels built into its own ``build/``), so a
change and its parent are timed on one card in one call with one
yardstick. A row for each row of PERF.md's kernel table, all float32 at
the benchmark's width (``for_knode(512)``: 28 inputs, hidden 512, 25
outputs) unless named:

  K1  one node of the hybrid RHS (a K3 sweep over N=2), 1,792 lanes;
  K3  the sweep at N=10, 1,792 lanes;
  K2  one BDF-2 step at N=10, the net's weights x1e-3: 1, 40, 256 rods;
  K4  200 epochs at 232 cells (2 x 30 steps) and at 1,904 (4 x 120);
  K5  200 epochs, 40 runs x 232 cells over the four mods;
  K6  200 epochs at hidden 8192 on the train-real shape (1,904 cells of
      53 inputs, AdamW 0.1, random data from seed 0);
  K7  one coupled step of the JAX bench's assembly (M=3, N=10, step 5 of
      its sine schedule); batched, B = 1, 16 and 256 systems in a launch
      (step 5 of path G's schedules, tol 1e-8);
  K8  the fused next segment on path C's cells: 232 of 28 inputs, 1,904
      of 53.

``ms`` is the wrapper's call by CUDA events after a warm-up call; K7 and
K8, whose wrappers cost the host about as much as their kernels take on
the card, add the kernel's device time by torch.profiler. ``bound`` is
the least time the card could take (``portbench.counts``, this file's own
copy: operations over the float32 peak or bytes over the memory rate, the
larger). K2's operations are the benchmark's count of a hybrid rod-step
(the sweeps and iterations that the plain reference's Newton needs on the
rollout-r256 cell, ``counts/rollout-r256.sim-nsw-h512.json``); K7's,
which the benchmark does not count, are counted here from this run's
iterations. Every line is tagged with its checkout and the card's name
and power limit; the last lines give each row's four turns. Needs one
card.
"""
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
TURN = "--turn"
SINES = [("sine", 0.5), ("sine", 1.0), ("sine", 1.25), ("sine", 1.5)]
MODS = ["nsw", "short", "youngs", "lengthstiff"]
EPOCHS = 200


def k7_work(asm, iters, node_ops):
    """(operations, bytes) of one system's K7 step of ``iters`` Newton
    iterations (float32): per iteration the 20 M rod sweeps the step needs
    (each rod's base and its 12 probes, 7 line-search candidates), each
    N-1 nodes of ``node_ops``, and the elimination's U^3 multiply-adds;
    the first residual's and the recording's M sweeps. Bytes: the
    system's inputs and outputs once, and the float64 constants."""
    M, N = asm.M, asm.N
    U = 6 * M + 7
    sweep = (N - 1) * node_ops
    flops = iters * (20 * M * sweep + 2 * U ** 3) + 2 * M * sweep
    const = 8 * (M * 76 + 14 + 7 * M)
    nbytes = 4 * (2 * U + M * N * 25 + 3 * M + 13 + M * N * 19
                  + M * (N - 1) * 6 + 2)
    return flops, nbytes, const


def turn(root):
    """Time every row against the package of the checkout at ``root``;
    print one JSON line per row."""
    import numpy as np

    from portbench.counts import k2, k4, peaks

    sys.path.insert(0, root)
    import torch

    import knode_cosserat_tpu_torch as K
    if not os.path.abspath(K.__file__).startswith(root + os.sep):
        raise RuntimeError(f"the port found at {K.__file__}, not in {root}")
    from knode_cosserat_tpu_torch.core.assembly import (AssemblyCarry,
                                                        assembly_step_carry,
                                                        make_ring_assembly)
    from knode_cosserat_tpu_torch.core.stepper import initial_state
    from knode_cosserat_tpu_torch.models.mlp import StackedMLP
    from knode_cosserat_tpu_torch.ops import assembly as kasm
    from knode_cosserat_tpu_torch.ops import next_segment as kseg
    from knode_cosserat_tpu_torch.ops import step as kstep
    from knode_cosserat_tpu_torch.ops import sweep as ksweep
    from knode_cosserat_tpu_torch.ops import train as ktrain
    from knode_cosserat_tpu_torch.ops import train_wide as kwide
    from knode_cosserat_tpu_torch.training.loss import (DEFAULT_KEYPOINTS_REAL,
                                                        grow_predictions)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, f32 = torch.device("cuda", 0), torch.float32
    counts = json.load(open(os.path.join(
        HERE, "portbench", "counts", "rollout-r256.sim-nsw-h512.json")))

    def emit(row, ms, flops, nbytes, device_ms=None):
        s = peaks.bound_s(flops, nbytes)
        by = "operations" if flops / peaks.PEAK_F32 >= nbytes / \
            peaks.PEAK_BYTES else "bytes"
        print(json.dumps(dict(row=row, ms=ms, device_ms=device_ms,
                              bound_ms=s * 1e3, bound_by=by)), flush=True)

    def timed(fn, n):
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    def device_ms(fn, n, kernel, module):
        """ms per launch of the kernel whose name holds ``kernel``, by the
        profiler over n calls after a warm-up; module.LAUNCHES must count
        n. The profiler drops a record now and then, so the mean is over
        those it kept; a window with none is run again, twice at most."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            before = module.LAUNCHES
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
            if module.LAUNCHES - before != n:
                raise RuntimeError(f"{kernel}: {module.LAUNCHES - before} "
                                   f"launches of {n} calls")
            total = seen = 0
            for e in prof.key_averages():
                if kernel in e.key:
                    total += (getattr(e, "device_time_total", None)
                              or e.cuda_time_total)
                    seen += e.count
            if seen:
                return total / seen / 1e3
        raise RuntimeError(f"{kernel}: the profiler recorded no launch")

    def history_inputs(p, B, seed=0):
        """A perturbed BDF-2 history around the straight rod, tendon forces
        of 5-7 N tensions and a base-reaction guess."""
        g = np.random.RandomState(seed)
        y0, z0 = (a.cpu().double().numpy() for a in initial_state(p))
        y = y0 + 1e-3 * g.randn(B, p.N, 19)
        z = z0 + 1e-3 * g.randn(B, p.N, 6)
        c1, c2 = float(p.c1), float(p.c2)
        tf = (5 + 2 * g.rand(B, 4)) @ p.tendon_dirs.cpu().double().numpy()
        return [torch.tensor(a, dtype=f32, device=dev) for a in (
            0.05 * g.randn(B, 6), c1 * y + c2 * y0, c1 * z + c2 * z0, tf)]

    def net_of(spec, scale=1.0, seed=0):
        net = K.init_mlp(spec, torch.Generator().manual_seed(seed), f32, dev)
        with torch.no_grad():
            for t in net.parameters():
                t.mul_(scale)
        return net

    def train_data(specs, train_len):
        trajs, ctls = K.make_training_data(K.apply_mod(None, device=dev),
                                           specs, train_len=train_len)
        return trajs.float(), ctls.float()

    def train_real_data(seed=0):
        """Random data of the train-real shape made as the JAX bench makes
        it (bench.py:612-623), plus the identity quaternion."""
        g = np.random.default_rng(seed)
        trajs = torch.tensor(g.normal(size=(4, 120, 10, 25)) * 0.01
                             + np.eye(1, 25, 3)[0], dtype=f32, device=dev)
        ctls = torch.tensor(g.uniform(1, 3, size=(4, 120, 4)), dtype=f32,
                            device=dev)
        return trajs, ctls

    real_cfg = dict(history=True, weight_decay=0.1,
                    keypoints=DEFAULT_KEYPOINTS_REAL)
    spec = K.MLPSpec.for_knode(512)
    dims = spec.dims
    net_bytes = k2.launch_bytes(dims, 0, 0)
    with torch.no_grad():
        # K1 and K3: lanes x (N - 1) nodes; per lane G, yh, zh, tf in and
        # the residual out
        net = net_of(spec)
        for row, N in (("K1 one node, 1,792 lanes", 2),
                       ("K3 N=10, 1,792 lanes", 10)):
            p = K.experimental_rod(N=N, device=dev).to(dtype=f32)
            G, yh, zh, tf = history_inputs(p, 1792)
            k = ksweep.make_sweep_kernel(p, spec, want_rod=False)
            emit(row, timed(lambda: k(G, yh, zh, tf, net), 20),
                 1792 * (N - 1) * k2.node_flops(dims),
                 net_bytes + 4 * 1792 * (6 + N * 25 + 3 + 6))
        p = K.experimental_rod(N=10, device=dev).to(dtype=f32)
        net = net_of(spec, 1e-3)
        k = kstep.make_step_kernel(p, spec, tol=1e-10, max_iter=20)
        for B in (1, 40, 256):
            G, yh, zh, tf = history_inputs(p, B)
            G = torch.zeros_like(G)
            emit(f"K2 N=10, {B} rods", timed(
                lambda: k(G, yh, zh, tf, net), 20),
                B * k2.rod_step_flops(dims, 10,
                                      counts["sweeps_per_rod_step"],
                                      counts["iters_per_rod_step"]),
                k2.launch_bytes(dims, 10, B))

    # K4, K5, K6: each epoch's count (counts/k4.py), each launch's bytes
    p = K.apply_mod("nsw", dtype=f32, device=dev)
    cfg = K.TrainConfig(hidden=512)
    hyper = ktrain._hyper(cfg)
    small = train_data(SINES[:2], 30)
    for label, (trajs, ctls) in (("232", small),
                                 ("1,904", train_data(SINES, 120))):
        cells = ktrain.precompute(p, spec, cfg.keypoints, trajs, ctls)
        W = [t.detach() for wb in net_of(spec).weights() for t in wb]
        state = ktrain.fresh_state(W)
        C = cells.x.shape[0]
        emit(f"K4 {label} cells, {EPOCHS} epochs", timed(
            lambda: ktrain.train_run(cells, W, state, EPOCHS, hyper), 3),
            EPOCHS * k4.epoch_flops(C, dims), k4.launch_bytes(C, dims, EPOCHS))
    G = 40
    cells = [ktrain.precompute(K.apply_mod(MODS[g % 4], dtype=f32, device=dev),
                               spec, cfg.keypoints, *small) for g in range(G)]
    W = [t.detach() for wb in StackedMLP([
        net_of(spec, seed=g) for g in range(G)]).weights() for t in wb]
    state = ktrain._stack_states([ktrain.fresh_state([w[g] for w in W])
                                  for g in range(G)])
    C = cells[0].x.shape[0]
    emit(f"K5 {G} runs x {C} cells, {EPOCHS} epochs", timed(
        lambda: ktrain.train_grid_run(cells, W, state, EPOCHS, hyper), 3),
        G * EPOCHS * k4.epoch_flops(C, dims),
        G * k4.launch_bytes(C, dims, EPOCHS))
    wcfg = K.TrainConfig(hidden=8192, **real_cfg)
    wspec = wcfg.spec()
    cells = ktrain.precompute(p, wspec, wcfg.keypoints, *train_real_data())
    W = [t.detach() for wb in net_of(wspec).weights() for t in wb]
    state, whyper = ktrain.fresh_state(W), ktrain._hyper(wcfg)
    C = cells.x.shape[0]
    emit(f"K6 hidden 8192, {C} cells, {EPOCHS} epochs", timed(
        lambda: kwide.train_run(cells, W, state, EPOCHS, whyper), 3),
        EPOCHS * k4.epoch_flops(C, wspec.dims),
        k4.launch_bytes(C, wspec.dims, EPOCHS))

    # K7: one system, and batches of path G's systems in one launch
    def k7_inputs(asm, ctl, batch, tol):
        k, grab = kasm.make_assembly_step_kernel(asm, tol=tol), []
        carry = AssemblyCarry.initial(asm, batch)
        with torch.no_grad():
            for t in range(6):
                carry = assembly_step_carry(
                    asm, carry, ctl[:, t] if batch else ctl[t], tol=tol,
                    solve_fn=lambda *a: grab.append(a) or k(*a))[0]
        return grab[5]

    asm = make_ring_assembly(n_rods=3, base_radius=0.05, N=10, dtype=f32,
                             device=dev)
    dt = float(asm.rods[0].del_t)
    ctl = torch.tensor(np.stack([K.calc_controls("sine", a, dt, 8)
                                 for a in (0.7, 1.0, 1.3)], axis=1),
                       dtype=f32, device=dev)
    ins = k7_inputs(asm, ctl, None, 1e-10)
    k = kasm.make_assembly_step_kernel(asm)
    flops, nbytes, const = k7_work(asm, int(k(*ins)[4]), k2.NODE_OPS)
    emit("K7 M=3, one system", timed(lambda: k(*ins), 20), flops,
         nbytes + const, device_ms(lambda: k(*ins), 20, "assembly_kernel",
                                   kasm))
    g = torch.Generator().manual_seed(0)
    ctl = (5.0 + torch.rand((256, 8, 3, 4), generator=g,
                            dtype=torch.float64)).to(dtype=f32, device=dev)
    ins = k7_inputs(asm, ctl, 256, 1e-8)
    k = kasm.make_assembly_step_kernel(asm, tol=1e-8, max_iter=30)
    iters = k(*ins)[4].tolist()
    for B in (1, 16, 256):
        sub = [t[:B] for t in ins]
        work = [k7_work(asm, i, k2.NODE_OPS) for i in iters[:B]]
        emit(f"K7 M=3, batched, {B} systems", timed(lambda: k(*sub), 20),
             sum(w[0] for w in work), sum(w[1] for w in work) + work[0][2],
             device_ms(lambda: k(*sub), 20, "assembly_kernel", kasm))

    # K8: one node a cell; the cells (y, yh, zh, tf in; y_grown, z out)
    for label, cfg_kw, (trajs, ctls) in (
            ("232 cells, 28 inputs", {}, small),
            ("1,904 cells, 53 inputs", real_cfg, train_real_data())):
        kcfg = K.TrainConfig(hidden=512, **cfg_kw)
        kspec = kcfg.spec()
        net = net_of(kspec)
        grab = []
        grow_predictions(p, kspec, net, trajs, ctls, kcfg.keypoints,
                         fused_fn=lambda n, *xs: grab.append(xs) or xs[::2])
        cells = grab[0]
        fn = kseg.make_fused_next_segment(p, kspec)
        B = cells[0].shape[0]
        with torch.no_grad():
            emit(f"K8 {label}", timed(lambda: fn(net, *cells), 50),
                 B * k2.node_flops(kspec.dims),
                 k2.launch_bytes(kspec.dims, 0, 0)
                 + 4 * B * (19 + 19 + 6 + 3 + 19 + 6),
                 device_ms(lambda: fn(net, *cells), 50,
                           "next_segment_kernel", kseg))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == TURN:
        turn(sys.argv[2])
        return 0
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    tag = card()
    a, b = sys.argv[1], sys.argv[2]
    rows = {}
    for root in (a, b, b, a):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              TURN, os.path.abspath(root)], cwd=root,
                             capture_output=True, text=True)
        for line in out.stdout.splitlines():
            if not line.startswith("{"):
                continue
            r = json.loads(line)
            rows.setdefault(r["row"], {}).setdefault(root, []).append(r)
            dev = ("" if r["device_ms"] is None
                   else f", device {r['device_ms']:.4f} ms")
            print(f"[{root}] {r['row']}: {r['ms']:.4f} ms{dev}; bound "
                  f"{r['bound_ms']:.6f} ms ({r['bound_by']}) [{tag}]",
                  flush=True)
        if out.returncode:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
    print(f"A = {a}, B = {b}; ms per call in the turns A B B A [{tag}]")
    for row, by_root in rows.items():
        ms = lambda root, key: " / ".join(
            f"{r[key]:.4f}" for r in by_root[root])
        line = f"{row}: A {ms(a, 'ms')}, B {ms(b, 'ms')}"
        first = by_root[a][0]
        if first["device_ms"] is not None:
            line += (f"; device A {ms(a, 'device_ms')}, B "
                     f"{ms(b, 'device_ms')}")
        print(line + f"; bound {first['bound_ms']:.6f} ms "
              f"({first['bound_by']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
