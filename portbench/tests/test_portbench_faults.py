"""The check catches what it is there to catch: each fixture cell driven
through a whole run on the CPU with the chip check stubbed out and the
program broken underneath reads ``correct`` false, once for each fault the
cell can have (a step that returns its state unchanged, half of the batch
left out with the mean taken over the rest, an answer altered where it is
produced, and in training the weights or the optimizer's state dropped
between K4's chunks; no cell spans chips, so no exchange can be left out), and the
control (the reference in the program's place with TF32 products) reads
``correct`` false in each cell."""
from __future__ import annotations

import json

import pytest

from portbench.tests import fixture as F

# train_knode on the CPU runs the plain epoch loop (training/train.py)
TRAIN = "import knode_cosserat_tpu_torch.training.train as T\n"
TRAIN_FAULTS = {
    "state_unchanged": TRAIN + "T.AdamPlateau.step = lambda self, loss: loss",
    "half_batch": TRAIN + (
        "orig = T.teacher_forced_loss\n"
        "def half(p, spec, net, trajs, controls, kp, **kw):\n"
        "    n = trajs.shape[0] // 2\n"
        "    l = orig(p, spec, net, trajs[:n], controls[:n], kp, **kw)\n"
        "    return torch.cat([l, l])\n"
        "T.teacher_forced_loss = half"),
    "answer_altered": TRAIN + (
        "orig = T.clamp_nonnegative\n"
        "def bent(net, *a, **k):\n"
        "    out = orig(net, *a, **k)\n"
        "    with torch.no_grad():\n"
        "        net.layers[0].weight[0, 3] += 1e-3\n"
        "    return out\n"
        "T.clamp_nonnegative = bent"),
}

# K4's chunks on the CPU: train_knode's fused path with K4's plain
# version, its weights and optimizer state carried from chunk to chunk
FUSED = TRAIN + "T._resolve_fused = lambda *a, **k: 'plain'\n"
CARRY_FAULTS = {
    name: FUSED + f"from portbench.faults import planted\n"
                  f"fault = planted({name!r})\nfault.__enter__()"
    for name in ("copy_back_dropped", "carry_dropped")}

# the rod's step on the CPU: core/fast_rollout._inner's step function, for
# the rollout (impl mega -> K2's plain version) and the stepper (plain)
STEP = """
import knode_cosserat_tpu_torch.core.fast_rollout as FR
orig = FR._inner
def broken(*a, **k):
    inner = orig(*a, **k)
    def f(y, z, y_prev, z_prev, G, tensions, nn=None):
        out = list(inner(y, z, y_prev, z_prev, G, tensions, nn))
{body}
        return tuple(out)
    return f
FR._inner = broken
"""
STEP_FAULTS = {
    "state_unchanged": "        out[0], out[1], out[2] = y, z, G",
    "half_batch": ("        n = out[0].shape[0] // 2\n"
                   "        for i in (0, 1, 2):\n"
                   "            out[i] = torch.cat([out[i][:n]] * 2)"),
    "answer_altered": "        out[0] = out[0].clone(); out[0][0, 3, 0] += 1e-3",
}
CASES = ([("tiny-train.tiny-real", k, v) for k, v in TRAIN_FAULTS.items()]
         + [("tiny-train.tiny-real", k, v) for k, v in CARRY_FAULTS.items()]
         + [("tiny-rollout.tiny-sim", k, STEP.format(body=v))
            for k, v in STEP_FAULTS.items()]
         + [("tiny-serve.tiny-sim", k, STEP.format(body=v))
            for k, v in STEP_FAULTS.items() if k != "half_batch"])


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return F.build(tmp_path_factory.mktemp("faults"))


@pytest.mark.parametrize("cell,fault,patch", CASES,
                         ids=[f"{c}-{f}" for c, f, _ in CASES])
def test_a_broken_program_reads_not_correct(tree, cell, fault, patch):
    rc, res, err = F.run_cell(tree, cell, patch=patch)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False, res["checked"]


def test_the_chunked_path_unbroken_reads_correct(tree):
    rc, res, err = F.run_cell(tree, "tiny-train.tiny-real", patch=FUSED)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, res["checked"]


@pytest.mark.parametrize("cell,kind", [
    ("tiny-train.tiny-real", "control"), ("tiny-train.tiny-real",
                                          "half_batch"),
    ("tiny-rollout.tiny-sim", "control"), ("tiny-serve.tiny-sim",
                                           "control")])
def test_the_reference_in_the_programs_place_reads_not_correct(tree, cell,
                                                               kind):
    rc, out, err = F.run_py(tree, (
        "from portbench.calibrate import readings\n"
        f"print(__import__('json').dumps(readings({cell!r}, 11, {kind!r}, "
        "0.2, require=cpu)))"))
    assert rc == 0, err[-3000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is False, res["numbers"]
