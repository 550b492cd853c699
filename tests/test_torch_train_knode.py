"""train_knode against the JAX package's (float64 on the CPU, the plain
epoch loop on both sides): loss history, validation DTW history and best
weights; and a run resumed from a checkpoint that the JAX trainer wrote."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import knode_cosserat_tpu as J
import knode_cosserat_tpu_torch as K
from knode_cosserat_tpu.models import mlp as jmlp
from knode_cosserat_tpu.training import checkpoint as jckpt
from knode_cosserat_tpu.training import data as jdata
from knode_cosserat_tpu.training import train as jtrain
from knode_cosserat_tpu_torch.training import checkpoint as kckpt
from knode_cosserat_tpu_torch.training import train as ktrain

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
