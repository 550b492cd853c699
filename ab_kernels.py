"""A B B A timing of the two-layer rod kernels in two checkouts on one card.

    python3 ab_kernels.py PARENT_DIR THIS_DIR

Four turns, A B B A (A is PARENT_DIR), each a process of its own run in
its checkout with that checkout's chip_smoke.py helpers and kernels, so
that a change is compared with its parent on the same card in one call:

  K1  one node of the hybrid RHS through K3, 1,792 lanes, for_knode(512);
  K2  one BDF-2 step, N=10, for_knode(512), 1, 40 and 256 rods;
  K8  the fused next segment, hidden 512, at path C's two shapes (232
      cells of 28 inputs, 1,904 cells of 53 inputs): the wrapper's call
      and the kernel's device time (torch.profiler, chip_smoke.device_ms);
  K7  one coupled step of one assembly (M=3, N=10, step 5 of the sine
      schedule, chip_smoke.step_args): the wrapper's call and the device
      time; and path A, simulate_assembly(fused=True) at T=101 (steps/s,
      CUDA events around the call, best of 3).

All float32; calls by CUDA events (chip_smoke.timed). Every line is tagged
with its checkout and the card's name and power limit. Needs one card.
"""
import subprocess
import sys

RUN = r'''
import torch
import chip_smoke as c
K = c.import_port()
from knode_cosserat_tpu_torch.ops import next_segment as kseg
from knode_cosserat_tpu_torch.ops.step import make_step_kernel
from knode_cosserat_tpu_torch.ops.sweep import make_sweep_kernel
dev, dt, tag = torch.device("cuda", 0), torch.float32, c.card()
p2 = K.experimental_rod(N=2, device=dev).to(dtype=dt)
spec, net = c.make_net(K, False, dt, dev)
G, yh, zh, tf = c.on(dev, dt, *c.history_inputs(p2, 256 * 7, c.SEED))
k1 = make_sweep_kernel(p2, spec, want_rod=False)
with torch.no_grad():
    ms = c.timed(lambda: k1(G, yh, zh, tf, net), 20)
print(f"[time] K1 one node, 1792 lanes, hybrid 512 f32: {ms:.4f} ms [{tag}]")
p = K.experimental_rod(N=10, device=dev).to(dtype=dt)
spec, net = c.make_net(K, False, dt, dev, scale=1e-3)
k2 = make_step_kernel(p, spec, tol=1e-10, max_iter=20)
for B in (1, 40, 256):
    G, yh, zh, tf = c.on(dev, dt, *c.history_inputs(p, B, c.SEED))
    G = torch.zeros_like(G)
    with torch.no_grad():
        ms = c.timed(lambda: k2(G, yh, zh, tf, net), 20)
    print(f"[time] K2 N=10, {B} rods, hybrid 512 f32: {ms:.4f} ms [{tag}]")
for label, p, cfg, net, trajs, ctls in c.k8_cases(K, dev, c.bench_data(dev)):
    spec = cfg.spec()
    cells = c.k8_cells(K, p, spec, net, trajs, ctls, cfg.keypoints)
    fn = kseg.make_fused_next_segment(p, spec)
    with torch.no_grad():
        kern, seen = c.device_ms(lambda: fn(net, *cells), 50,
                                 "next_segment_kernel", kseg)
        call = c.timed(lambda: fn(net, *cells), 50)
    print(f"[time] K8 {label}, hidden 512 f32: the wrapper's call "
          f"{call:.4f} ms, device {kern:.4f} ms ({seen} of 50 launches "
          f"recorded) [{tag}]")
from knode_cosserat_tpu_torch.core.assembly import (make_ring_assembly,
                                                    simulate_assembly)
from knode_cosserat_tpu_torch.ops import assembly as kasm
asm = make_ring_assembly(**c.ASM_CFG, dtype=dt, device=dev)
ins = c.step_args(asm, c.assembly_controls(asm, 8), 5)
k7 = kasm.make_assembly_step_kernel(asm)
kern, seen = c.device_ms(lambda: k7(*ins), 20, "assembly_kernel", kasm)
call = c.timed(lambda: k7(*ins), 20)
print(f"[time] K7 one coupled step M=3 N=10 f32: the wrapper's call "
      f"{call:.4f} ms, device {kern:.4f} ms ({seen} of 20 launches "
      f"recorded) [{tag}]")
ctl = c.assembly_controls(asm, 101)
simulate_assembly(asm, ctl[:3], fused=True)
rates = []
for _ in range(3):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    simulate_assembly(asm, ctl, fused=True)
    end.record()
    torch.cuda.synchronize()
    rates.append(100 / (start.elapsed_time(end) / 1e3))
print(f"[time] path A simulate_assembly(fused=True) M=3 N=10 f32 T=101: "
      f"best of 3 {max(rates):.1f} steps/s [{tag}]")
'''


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = sys.argv[1], sys.argv[2]
    for root in (a, b, b, a):
        out = subprocess.run([sys.executable, "-c", RUN], cwd=root,
                             capture_output=True, text=True)
        for line in out.stdout.splitlines():
            if line.startswith("[time]"):
                print(f"[{root}] {line}", flush=True)
        if out.returncode:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
