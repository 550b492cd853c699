"""The launch plans of K7 (ops/assembly.py) and K8 (ops/next_segment.py),
K7's job map, and the principle K7's layout rests on: pure Python, so they
are checked here on the CPU.

K7 sweeps only the (rod, lane) pairs a pass needs: a probe on G_i changes
rod i's sweep alone, a probe on the plate pose changes none, so each lane's
residual can be closed from the tips of 13M sweep jobs."""
import contextlib

import numpy as np
import pytest
import torch

import knode_cosserat_tpu_torch as K
from knode_cosserat_tpu_torch.core import assembly as ka
from knode_cosserat_tpu_torch.core.spatial import integrate_euler
from knode_cosserat_tpu_torch.ops import _build
from knode_cosserat_tpu_torch.ops import assembly as kasm
from knode_cosserat_tpu_torch.ops import next_segment as kseg
from knode_cosserat_tpu_torch.ops import sweep as ksweep

DTYPES = [torch.float32, torch.float64]
BUDGET = 232_448


@pytest.mark.parametrize("N", [6, 10, 40])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M", range(1, 10))
def test_assembly_plan_fits_one_block(M, dtype, N):
    plan = kasm.launch_plan(dtype, M, N)
    U = 6 * M + 7
    assert plan.threads % 32 == 0 and plan.threads <= 128
    assert plan.threads >= max(13 * M, 2 * U + 1, 7 * M)
    assert plan.threads - 32 < max(13 * M, 2 * U + 1, 7 * M)
    assert plan.smem_bytes <= BUDGET
    size = 8 if dtype == torch.float64 else 4
    # the histories, the U x U system and the 13M jobs' tips at least
    assert plan.smem_bytes >= size * (M * N * 25 + U * U + 13 * M * 13)
    assert plan.smem_bytes % size == 0


# the longest rod K7's block holds at M = 1, 3, 6, 9 (ops/assembly.py)
LONGEST = {torch.float64: [(1, 1127), (3, 362), (6, 162), (9, 99)],
           torch.float32: [(1, 2287), (3, 749), (6, 355), (9, 228)]}


@pytest.mark.parametrize("dtype,M,N", [(dt, M, N) for dt in DTYPES
                                       for M, N in LONGEST[dt]])
def test_assembly_plan_at_its_longest_rod(dtype, M, N):
    """The plan takes the longest rod with room for the kernel's own
    __shared__ variables (404 B in float64), and refuses one node more."""
    assert kasm.launch_plan(dtype, M, N).smem_bytes + 512 <= BUDGET
    with pytest.raises(ValueError):
        kasm.launch_plan(dtype, M, N + 1)


@pytest.mark.parametrize("M,N", [(10, 10), (0, 10), (3, 1)])
def test_assembly_plan_refuses(M, N):
    with pytest.raises(ValueError):
        kasm.launch_plan(torch.float64, M, N)


@pytest.mark.parametrize("M", range(1, 10))
def test_probe_jobs_give_each_lane_its_tip(M):
    """Every lane closes rod j from a sweep of rod j whose base reaction is
    the lane's own: the rod's probe where the lane moves one of G_j's
    unknowns, else its base sweep; the 13M jobs are all used."""
    U = 6 * M + 7
    jobs, src = kasm.probe_jobs(M)
    assert len(jobs) == 13 * M and len(src) == 2 * U + 1
    assert len(set(jobs)) == len(jobs)
    used = set()
    for lane, row in enumerate(src):
        assert len(row) == M
        pk = -1 if lane == 0 else (lane - 1) % U
        sign = 0 if lane == 0 else (1 if lane <= U else -1)
        for j, job in enumerate(row):
            used.add(job)
            moves_rod_j = 0 <= pk < 6 * M and pk // 6 == j
            want = (j, pk - 6 * j, sign) if moves_rod_j else (j, -1, 0)
            assert jobs[job] == want, (lane, j)
    assert used == set(range(13 * M))


def _tip(asm, i, G, yh, zh, tf):
    """Rod i alone swept from G (6): its tip [p, h, n, m]."""
    y, _ = integrate_euler(asm.rods[i], G[None], yh[i:i + 1], zh[i:i + 1],
                           tf[i:i + 1])
    return y[0, -1, :13]


@pytest.mark.parametrize("M", [1, 3, 9])
def test_lanes_close_from_the_jobs_tips(M):
    """Each probe lane's residual built from the jobs' tips (only the
    perturbed rod re-swept) and the plate algebra equals the coupled
    residual at the lane's X, f64, within 1e-13 relative."""
    asm = ka.make_ring_assembly(n_rods=M, base_radius=0.05, N=6,
                                device="cpu")
    g = np.random.RandomState(M)
    kw = dict(dtype=torch.float64)
    carry = ka.AssemblyCarry.initial(asm)
    c1, c2 = float(asm.rods[0].c1), float(asm.rods[0].c2)
    yh = c1 * (carry.y + 1e-3 * torch.tensor(g.randn(*carry.y.shape), **kw)) \
        + c2 * carry.y
    zh = c1 * (carry.z + 1e-3 * torch.tensor(g.randn(*carry.z.shape), **kw)) \
        + c2 * carry.z
    tf = torch.tensor((5 + 2 * g.rand(M, 4))
                      @ asm.rods[0].tendon_dirs.double().numpy(), **kw)
    ph = [(c1 + c2) * carry.pp, torch.tensor(1e-3 * g.randn(3), **kw),
          (c1 + c2) * carry.hp, torch.tensor(1e-3 * g.randn(3), **kw)]
    X = torch.cat([torch.tensor(0.05 * g.randn(6 * M), **kw), carry.pp,
                   carry.hp])
    U = 6 * M + 7
    h = 1e-4 * (1.0 + X.abs())
    jobs, src = kasm.probe_jobs(M)
    tips = []
    for i, k, s in jobs:
        G = X[6 * i:6 * i + 6].clone()
        if k >= 0:
            G[k] = G[k] + s * h[6 * i + k]
        tips.append(_tip(asm, i, G, yh, zh, tf))
    for lane in range(2 * U + 1):
        Xl = X.clone()
        if lane:
            pk = (lane - 1) % U
            Xl[pk] = Xl[pk] + (h[pk] if lane <= U else -h[pk])
        got = ka._residual_algebra(asm, torch.stack([tips[t] for t in
                                                     src[lane]]),
                                   Xl[6 * M:], *ph)
        want = ka._assembly_residual(asm, Xl, yh, zh, tf, *ph)
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-13 * scale, lane


@pytest.mark.parametrize("B", [1, 31, 232, 1904])
@pytest.mark.parametrize("hidden", [16, 100, 512, 2048])
@pytest.mark.parametrize("nn_in", [28, 53])
@pytest.mark.parametrize("dtype", DTYPES)
def test_segment_plan_covers_every_cell(dtype, nn_in, hidden, B):
    """The net is staged where it fits the budget, else read from global
    memory; the warps' cells b = block C + warp + k (blocks C) cover
    0..B-1 once each."""
    plan = kseg.launch_plan(dtype, nn_in, hidden, B)
    w = ksweep.net_smem_bytes(dtype, nn_in, hidden)
    assert plan.staged == (w <= BUDGET)
    assert plan.smem_bytes == (w if plan.staged else 0) <= BUDGET
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 256
    C = plan.threads // 32
    assert 1 <= plan.blocks <= 132
    cells = [b for blk in range(plan.blocks) for warp in range(C)
             for b in range(blk * C + warp, B, plan.blocks * C)]
    assert sorted(cells) == list(range(B))


def test_segment_plan_at_the_main_path_shapes():
    """232 cells (path C's bench shape) take 29 SMs, 8 cells a block; the
    train-real shape (1,904 cells) fills all 132; a small batch takes one
    block of as many warps as cells."""
    assert kseg.launch_plan(torch.float32, 28, 512, 232)[:2] == (256, 29)
    assert kseg.launch_plan(torch.float32, 53, 512, 1904)[:2] == (256, 132)
    assert kseg.launch_plan(torch.float32, 28, 512, 3)[:2] == (96, 1)
    assert not kseg.launch_plan(torch.float64, 53, 512, 232).staged
    assert kseg.launch_plan(torch.float64, 28, 512, 232).staged
    with pytest.raises(ValueError):
        kseg.launch_plan(torch.float32, 28, 512, 0)


class _Recorder:
    """Stands in for the kernel library: records each entry's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("knode_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(_build, "library", lambda: rec)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(kasm, "stream_of", lambda t: 0)
    monkeypatch.setattr(kseg, "stream_of", lambda t: 0)
    return rec


@pytest.mark.parametrize("M", [1, 9])
def test_assembly_wrapper_hands_the_plan(recorder, M):
    asm = ka.make_ring_assembly(n_rods=M, N=5, device="cpu")
    U, kw = 6 * M + 7, dict(dtype=torch.float64)
    kasm._launch(asm, {"consts": torch.zeros(1), "plate": torch.zeros(1)},
                 1e-10, 50, torch.zeros(U, **kw), torch.zeros(M, 5, 19, **kw),
                 torch.zeros(M, 5, 6, **kw), torch.zeros(M, 3, **kw),
                 torch.zeros(13, **kw))
    (name, args), = recorder.calls
    plan = kasm.launch_plan(torch.float64, M, 5)
    assert name == "knode_assembly"
    assert args[-3:-1] == (plan.threads, plan.smem_bytes)


@pytest.mark.parametrize("B", [1, 232])
def test_segment_wrapper_hands_the_plan(recorder, B):
    p = K.apply_mod("nsw", dtype=torch.float32, device="cpu")
    spec = K.MLPSpec.for_knode(100)
    net = K.init_mlp(spec, torch.Generator().manual_seed(0), torch.float32,
                     "cpu")
    cells = [torch.zeros(B, n) for n in (19, 19, 6, 3)]
    W = [t for wb in net.weights() for t in wb]
    kseg._launch(ksweep.rod_consts(p), spec, *cells, W)
    (name, args), = recorder.calls
    plan = kseg.launch_plan(torch.float32, 28, 100, B)
    assert name == "knode_next_segment"
    assert args[-5:-1] == (plan.threads, plan.blocks, plan.smem_bytes,
                           int(plan.staged))
