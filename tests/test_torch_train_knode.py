"""train_knode against the JAX package's (float64 on the CPU, the plain
epoch loop on both sides): loss history, validation DTW history and best
weights; and a run resumed from a checkpoint that the JAX trainer wrote."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import knode_cosserat_tpu as J
import knode_cosserat_tpu_torch as K
from knode_cosserat_tpu.models import mlp as jmlp
from knode_cosserat_tpu.training import checkpoint as jckpt
from knode_cosserat_tpu.training import data as jdata
from knode_cosserat_tpu.training import train as jtrain
from knode_cosserat_tpu_torch.training import checkpoint as kckpt
from knode_cosserat_tpu_torch.training import train as ktrain

from fused_chain import chained, flat

torch.set_num_threads(1)
KW = dict(hidden=16, dtype="float64", fused="off", plateau_patience=3)


def _data():
    ref = J.apply_mod(None)
    trajs, ctls = jdata.make_training_data(ref, [("sine", 0.5), ("sine", 1.0)],
                                           train_len=6)
    return np.asarray(trajs), np.asarray(ctls)


def test_train_knode_matches_jax(tmp_path):
    trajs, ctls = _data()
    vc, vt = jdata.make_validation_reference(J.apply_mod(None),
                                             ("sine", 1.25), 6)
    # the same initial weights on both sides, from a JAX checkpoint
    spec = jtrain.TrainConfig(**KW).spec()
    init = jmlp.init_mlp(spec, jax.random.PRNGKey(0), jnp.float64)
    start = jckpt.save_checkpoint(str(tmp_path / "init"),
                                  {"params": jax.tree.map(np.asarray, init)})
    kw = dict(KW, epochs=8, eval_every=4, eval_len=6)
    rj = jtrain.train_knode(J.apply_mod("nsw"), trajs, ctls,
                            jtrain.TrainConfig(**kw), vc, vt, log=None,
                            resume_from=start)
    rk = ktrain.train_knode(K.apply_mod("nsw", device="cpu"), trajs, ctls,
                            ktrain.TrainConfig(checkpoint_async=True,
                                               checkpoint_every=3, **kw),
                            vc, np.moveaxis(vt, 1, 2), log=None,
                            resume_from=start,
                            checkpoint_path=str(tmp_path / "port"))
    assert rk.loss_history.shape == (9,) and rk.device == "cpu"
    np.testing.assert_allclose(rk.loss_history, rj.loss_history, rtol=1e-9)
    assert [e for e, _ in rk.dtw_history] == [0, 4, 8]
    np.testing.assert_allclose([d for _, d in rk.dtw_history],
                               [d for _, d in rj.dtw_history], rtol=1e-7)
    np.testing.assert_allclose(rk.best_dtw, rj.best_dtw, rtol=1e-7)
    for (w, b), layer in zip(rk.best_params.weights(), rj.best_params):
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(layer["w"]),
                                   rtol=1e-9, atol=1e-14)
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(layer["b"]),
                                   rtol=1e-9, atol=1e-14)
    assert rk.epochs_per_sec > 0
    # the port's checkpoint (written on the async writer) holds the run
    ck, meta = kckpt.load_checkpoint(str(tmp_path / "port"))
    assert meta == {"epoch": 9}
    np.testing.assert_array_equal(ck["loss"], rk.loss_history)


def test_train_knode_resumes_a_jax_checkpoint(tmp_path):
    """The JAX trainer writes weights, optax state and loss history; both
    packages resume from that file and go on alike."""
    trajs, ctls = _data()
    path = str(tmp_path / "jax")
    jtrain.train_knode(J.apply_mod("nsw"), trajs, ctls,
                       jtrain.TrainConfig(epochs=3, checkpoint_every=2, **KW),
                       log=None,
                       checkpoint_path=path)
    cfg = dict(KW, epochs=3)
    rj = jtrain.train_knode(J.apply_mod("nsw"), trajs, ctls,
                            jtrain.TrainConfig(**cfg), log=None,
                            resume_from=path)
    rk = ktrain.train_knode(K.apply_mod("nsw", device="cpu"), trajs, ctls,
                            ktrain.TrainConfig(**cfg), log=None,
                            resume_from=path)
    assert rk.loss_history.shape == (8,)
    np.testing.assert_allclose(rk.loss_history, rj.loss_history, rtol=1e-9)
    assert np.isnan(rk.best_dtw)
    for (w, b), layer in zip(rk.params.weights(), rj.params):
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(layer["w"]),
                                   rtol=1e-9, atol=1e-14)


# ---------------------------------------------- the fused run on the device

def _fused_case():
    """A float64 rod of 6 nodes, two sine recordings of 6 frames from the
    unmodified rod and a validation reference of 5 (the port's own data)."""
    from knode_cosserat_tpu_torch.training import data as kdata
    ref = K.apply_mod(None, N=6, device="cpu")
    trajs, ctls = kdata.make_training_data(ref, [("sine", 0.5), ("sine", 1.0)],
                                           train_len=6)
    vc, vr = kdata.make_validation_reference(ref, ("sine", 1.25), 5)
    return K.apply_mod("nsw", N=6, device="cpu"), trajs, ctls, vc, vr


FUSED_CASES = {
    # 7 epochs in chunks of 2, 2, 2 and 1
    "ragged": dict(epochs=6, log_every=2),
    "checkpoint": dict(epochs=6, log_every=2, checkpoint_every=3),
    "eval": dict(epochs=6, eval_every=3, eval_len=5),
    "log": dict(epochs=6, log_every=2),
    "resume": dict(epochs=4, log_every=2),
    "plain": dict(epochs=6, log_every=2, fused="plain"),
    "wide_interpret": dict(epochs=6, log_every=2, checkpoint_every=4,
                           fused="wide_interpret"),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_the_fused_run_on_the_device_equals_the_chunk_by_chunk_chain(
        case, tmp_path, monkeypatch):
    """train_knode keeps the fused run on the device across its chunks and
    writes back only where it needs a host value: its loss history, net,
    DTW history, log lines and checkpoints equal the chunk-by-chunk
    composition bit for bit."""
    p, trajs, ctls, vc, vr = _fused_case()
    kw = dict(dict(hidden=16, keypoints=(1, 3, 5), plateau_patience=2,
                   weight_decay=0.1, fused="on"), **FUSED_CASES[case])
    cfg = ktrain.TrainConfig(**kw)
    resume = None
    if case == "resume":
        resume = str(tmp_path / "start")
        ktrain.train_knode(p, trajs, ctls, ktrain.TrainConfig(
            **dict(kw, epochs=2, checkpoint_every=3)), log=None,
            checkpoint_path=resume)
    saved = []
    monkeypatch.setattr(kckpt, "save_checkpoint",
                        lambda path, tree, meta: saved.append(
                            (meta["epoch"], tree)))
    evals = (vc, vr) if case == "eval" else (None, None)
    lines = []
    res = ktrain.train_knode(
        p, trajs, ctls, cfg, *evals, log=lines.append if case == "log"
        else None, resume_from=resume,
        checkpoint_path=str(tmp_path / "ck") if "checkpoint_every" in
        FUSED_CASES[case] else None)
    hist, net, dtws, want_lines, want_saved = chained(
        p, trajs, ctls, cfg, *evals, resume_from=resume,
        checkpoint="checkpoint_every" in FUSED_CASES[case])
    assert len(hist) == cfg.epochs + 1 + (3 if resume else 0)
    np.testing.assert_array_equal(res.loss_history, np.asarray(hist))
    for a, b in zip(res.params.parameters(), net.parameters()):
        assert torch.equal(a, b)
    assert res.dtw_history == dtws
    assert len(dtws) == (3 if case == "eval" else 0)
    if case == "log":
        assert lines == want_lines and len(lines) == 8
    assert [e for e, _ in saved] == [e for e, _ in want_saved]
    assert len(saved) == {"checkpoint": 2, "wide_interpret": 1}.get(case, 0)
    for (_, got), (_, want) in zip(saved, want_saved):
        (s1, l1), (s2, l2) = flat(got), flat(want)
        assert s1 == s2 and len(l1) == len(l2)
        for a, b in zip(l1, l2):
            np.testing.assert_array_equal(a, b)
