"""The port stands alone: it imports and steps a rod with jax blocked, and
importing it neither runs a compiler nor loads a kernel library."""
import os
import re
import subprocess
import sys
import textwrap

import torch

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import ctypes, subprocess, sys
    sys.modules["jax"] = None          # any `import jax` now fails
    sys.modules["optax"] = None
    import torch                       # (loads its own libraries first)
    calls = []
    real_run, real_popen, real_cdll = subprocess.run, subprocess.Popen, ctypes.CDLL
    subprocess.run = lambda *a, **k: calls.append(("run", a)) or real_run(*a, **k)
    subprocess.Popen = lambda *a, **k: calls.append(("popen", a)) or real_popen(*a, **k)
    ctypes.CDLL = lambda *a, **k: calls.append(("cdll", a)) or real_cdll(*a, **k)

    torch.set_num_threads(1)
    import knode_cosserat_tpu_torch as K
    loaded = sorted(m for m in sys.modules if m.startswith("knode_cosserat_tpu_torch"))
    assert "knode_cosserat_tpu_torch.ops._build" not in loaded, loaded
    assert "knode_cosserat_tpu_torch.ops.step" not in loaded, loaded
    assert "knode_cosserat_tpu_torch.ops.sweep" not in loaded, loaded
    assert "knode_cosserat_tpu_torch.ops.train" not in loaded, loaded
    assert not any(m.startswith("knode_cosserat_tpu.") or m == "knode_cosserat_tpu"
                   for m in sys.modules), "the JAX package was imported"
    assert calls == [], calls

    # a CPU step through the fast (K2) path: the plain version, no build
    p = K.experimental_rod(N=6, device="cpu")
    st = K.CompiledStepper(p, fast=True, fast_impl="mega", tol=1e-16)
    s, info = st.step(st.reset(), [6.0, 5.0, 4.0, 5.0])
    assert float(info["residual"]) < 1e-7 and bool(torch.isfinite(s.y).all())
    assert calls == [], calls
    from knode_cosserat_tpu_torch.ops import _build, step
    assert _build._LIB is None and step.LAUNCHES == 0

    # this slice's modules import, and run their plain versions, without jax
    from knode_cosserat_tpu_torch.control import make_assembly_planner
    from knode_cosserat_tpu_torch.core import assembly, multiple_shooting
    from knode_cosserat_tpu_torch.ops import assembly as kasm
    from knode_cosserat_tpu_torch.ops import next_segment as kseg
    asm = assembly.make_ring_assembly(n_rods=2, N=4, device="cpu")
    out = assembly.simulate_assembly(asm, torch.full((3, 2, 4), 5.0),
                                     fused=True)
    assert bool(torch.isfinite(out.plate_pose).all())
    net = K.init_mlp(K.MLPSpec.for_knode(8), torch.Generator().manual_seed(0),
                     torch.float64, "cpu")
    cells = [torch.zeros(5, n, dtype=torch.float64) for n in (19, 19, 6, 3)]
    cells[0][:, 3] = 1.0
    yg, z = kseg.make_fused_next_segment(p, K.MLPSpec.for_knode(8))(net, *cells)
    assert yg.shape == (5, 19) and z.shape == (5, 6)
    assert calls == [], calls
    assert _build._LIB is None and kasm.LAUNCHES == 0 and kseg.LAUNCHES == 0
    print("STANDALONE_OK")
""")


def test_port_imports_and_steps_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "STANDALONE_OK" in out.stdout


OPTIONAL = textwrap.dedent("""
    import os, sys, tempfile
    # (jax is not blocked here: scipy's array-API helpers look it up in
    # sys.modules; the test above keeps the port free of it)
    for name in ("pandas", "matplotlib"):
        sys.modules[name] = None       # any import of them now fails
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import knode_cosserat_tpu_torch.realworld as R
    from knode_cosserat_tpu_torch import cli

    d = tempfile.mkdtemp()
    T, N = 106, 10
    s = np.linspace(0.0, 0.5, N)
    bend = 0.05 * np.sin(0.3 * np.arange(T))[:, None] * s ** 2
    poses = np.zeros((T, 7, N))
    poses[:, 0], poses[:, 2], poses[:, 3] = bend, s, 1.0
    ctl = 6.0 + np.sin(0.3 * np.arange(T)[:, None] + np.arange(4))
    for name in cli.REAL_PRESETS["sinesine"]:
        np.savez(os.path.join(d, name + ".npz"), interpolated=poses,
                 controls=ctl, positions=np.moveaxis(
                     poses[:, :3, cli.MARKER_NODES], 1, 2))
        cli.main(["estimate", name, "--data_dir", d, "--device", "cpu"])
    res = cli.main(["train-real", "--data_dir", d, "--epochs", "3",
                    "--layers", "8", "--train_len", "4", "--device", "cpu",
                    "--save_path", os.path.join(d, "m")])
    assert np.isfinite(res.loss_history).all()
    for argv, what in ((["prepare", d, "--device", "cpu"], "pandas"),
                       (["playback", os.path.join(d, "sin_1_0_amp_300.npz"),
                         "--device", "cpu"], "matplotlib")):
        try:
            cli.main(argv)
        except ImportError as e:
            assert what in str(e), e
        else:
            raise AssertionError(f"{argv[0]} ran without {what}")
    print("OPTIONAL_OK")
""")


def test_realworld_runs_without_pandas_and_matplotlib():
    """A host may lack them (the card's has no matplotlib): the real-world
    package, estimate and train-real import and run without them; prepare
    and playback raise an ImportError that names the missing package."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", OPTIONAL], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "OPTIONAL_OK" in out.stdout


def test_port_sources_never_import_jax():
    pkg = os.path.join(ROOT, "knode_cosserat_tpu_torch")
    bad = re.compile(r"^\s*(import|from)\s+(jax|optax|knode_cosserat_tpu)\b",
                     re.M)
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                assert not bad.search(text), f"{f}: {bad.search(text)}"
    assert {"rhs_rows.cuh", "sweep.cu", "step.cu", "train.cu",
            "train_wide.cu", "assembly.cu", "next_segment.cu"} <= set(
        os.listdir(os.path.join(pkg, "csrc")))
