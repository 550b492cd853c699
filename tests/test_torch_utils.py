"""The port's utilities (utils/): the JAX package's tests/test_utils.py
cases on the port's modules, the normalization against the JAX functions
bit for bit, and a torch.profiler trace that writes its file."""
import json
import os

import numpy as np
import torch

from knode_cosserat_tpu import utils as jutils
from knode_cosserat_tpu_torch.utils import (MetricsLogger, annotate,
                                            denormalize_data, normalize_data,
                                            trace)

torch.set_num_threads(1)


def test_metrics_logger_jsonl_and_stdout(tmp_path, capsys):
    path = str(tmp_path / "metrics.jsonl")
    log = MetricsLogger(path, stdout=True, run_name="t")
    log.log(0, loss=1.5)
    log.log(10, loss=0.5, dtw=2.0)
    log.close()
    lines = [json.loads(line) for line in open(path)]
    assert lines[0]["step"] == 0 and lines[0]["loss"] == 1.5
    assert lines[1]["dtw"] == 2.0 and lines[1]["run"] == "t"
    out = capsys.readouterr().out
    # reference-compatible stdout format (physics_multitrain regex target)
    assert "Epoch 0" in out and "Total loss:" in out


def test_normalize_roundtrip_matches_jax():
    rng = np.random.RandomState(0)
    for shape in ((20, 5), (20, 5, 7)):
        x = rng.randn(*shape) * 3 + 1
        n, mn, rg = normalize_data(x)
        jn, jmn, jrg = jutils.normalize_data(x)
        for a, b in ((n, jn), (mn, jmn), (rg, jrg)):
            np.testing.assert_array_equal(a, b)
        assert n.min() >= 0 and n.max() <= 1 + 1e-12
        if x.ndim == 3:   # squeezed mins/ranges broadcast per channel
            mn, rg = mn[:, None], rg[:, None]
        np.testing.assert_allclose(denormalize_data(n, mn, rg), x,
                                   rtol=1e-12)


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with trace(str(logdir)):
        with annotate("knode_region"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    text = (logdir / files[0]).read_text()
    assert "knode_region" in text and json.loads(text)["traceEvents"]
