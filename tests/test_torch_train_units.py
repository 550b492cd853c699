"""The training slice's small parts against the JAX package (float64 on the
CPU): the Euler map, the teacher-forced segment growth, the loss and its
gradient, the device DTW, checkpoints, and the device default."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import knode_cosserat_tpu as J
import knode_cosserat_tpu_torch as K
from knode_cosserat_tpu.core import spatial as jspatial
from knode_cosserat_tpu.evaluation import metrics as jmetrics
from knode_cosserat_tpu.models import mlp as jmlp
from knode_cosserat_tpu.ops import dtw as jdtw
from knode_cosserat_tpu.ops import quaternion as jq
from knode_cosserat_tpu.training import checkpoint as jckpt
from knode_cosserat_tpu.training import loss as jloss
from knode_cosserat_tpu_torch.core import spatial as kspatial
from knode_cosserat_tpu_torch.models import mlp as kmlp
from knode_cosserat_tpu_torch.ops import dtw as kdtw
from knode_cosserat_tpu_torch.ops import quaternion as kq
from knode_cosserat_tpu_torch.training import checkpoint as kckpt
from knode_cosserat_tpu_torch.training import loss as kloss

torch.set_num_threads(1)
RTOL = 1e-12


def _traj(p, T, seed):
    """A trajectory near the straight rod (T, N, 25) and tensions (T, 4),
    float64 numpy from a seed."""
    g = np.random.RandomState(seed)
    y0, z0 = (np.asarray(a) for a in J.initial_state(p))
    base = np.concatenate([y0, z0], axis=-1)
    traj = base + 1e-3 * g.randn(T, p.N, 25)
    return traj, 5.0 + 2.0 * g.rand(T, 4)


def _nets(history, hidden=16, seed=0):
    spec = jmlp.MLPSpec.for_knode(hidden, history=history)
    params = jax.tree.map(lambda a: a * 0.3,
                          jmlp.init_mlp(spec, jax.random.PRNGKey(seed),
                                        jnp.float64))
    kspec = kmlp.MLPSpec.for_knode(hidden, history=history)
    return spec, params, kspec, kmlp.params_from_jax(params, kspec,
                                                     device="cpu")


def test_quaternion_to_euler_matches_jax():
    h = np.random.RandomState(0).randn(6, 5, 4)
    np.testing.assert_allclose(
        kq.quaternion_to_euler(torch.tensor(h)).numpy(),
        np.asarray(jq.quaternion_to_euler(jnp.asarray(h))), rtol=RTOL,
        atol=1e-15)


@pytest.mark.parametrize("tf_shape", ["per_step", "constant"])
def test_next_segment_euler_matches_jax(tf_shape):
    pj, pk = J.apply_mod("nsw"), K.apply_mod("nsw", device="cpu")
    g = np.random.RandomState(1)
    traj, _ = _traj(pj, 5, 2)
    y, yh, zh = traj[:, :4, :19], traj[:, 1:5, :19] * 3.0, traj[:, 1:5, 19:]
    tf = g.randn(5, 3) if tf_shape == "per_step" else g.randn(3)
    spec, params, _, net = _nets(False)
    want = jspatial.next_segment_euler(
        pj, *(jnp.asarray(a) for a in (y, yh, zh, tf)),
        nn_fn=jmlp.bind(spec, params))
    got = kspatial.next_segment_euler(
        pk, *(torch.tensor(a) for a in (y, yh, zh, tf)), nn_fn=net)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=RTOL, atol=1e-15)


@pytest.mark.parametrize("history", [False, True])
@pytest.mark.parametrize("skip_first", [False, True])
def test_teacher_forced_loss_and_grad_match_jax(history, skip_first):
    pj, pk = J.apply_mod("nsw"), K.apply_mod("nsw", device="cpu")
    traj, ctl = _traj(pj, 6, 3)
    spec, params, kspec, net = _nets(history, seed=4)
    kp = (3, 5, 7, 9)
    lj, gj = jax.value_and_grad(
        lambda prm: jloss.teacher_forced_loss(pj, spec, prm, jnp.asarray(traj),
                                              jnp.asarray(ctl), kp,
                                              skip_first=skip_first))(params)
    lk = kloss.teacher_forced_loss(pk, kspec, net, torch.tensor(traj),
                                   torch.tensor(ctl), kp,
                                   skip_first=skip_first)
    lk.backward()
    np.testing.assert_allclose(float(lk.detach()), float(lj), rtol=1e-10)
    for (w, b), layer in zip(net.weights(), gj):
        np.testing.assert_allclose(w.grad.numpy(), np.asarray(layer["w"]),
                                   rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(layer["b"]),
                                   rtol=1e-10, atol=1e-14)


def test_teacher_forced_loss_batches_and_checks():
    pk = K.apply_mod(None, device="cpu")
    trajs = np.stack([_traj(J.apply_mod(None), 5, s)[0] for s in (5, 6)])
    ctls = np.stack([_traj(J.apply_mod(None), 5, s)[1] for s in (5, 6)])
    _, _, kspec, net = _nets(False)
    both = kloss.teacher_forced_loss(pk, kspec, net, torch.tensor(trajs),
                                     torch.tensor(ctls))
    assert both.shape == (2,)
    one = kloss.teacher_forced_loss(pk, kspec, net, torch.tensor(trajs[1]),
                                    torch.tensor(ctls[1]))
    np.testing.assert_allclose(float(one), float(both[1]), rtol=1e-13)
    with pytest.raises(ValueError, match=">= 3 frames"):
        kloss.teacher_forced_loss(pk, kspec, net, torch.tensor(trajs[0, :2]),
                                  torch.tensor(ctls[0, :2]), skip_first=True)
    # a fused op (K8's, ops/next_segment.py) gets every trajectory's
    # (T-1) x K cells flattened in one call, and its result is reshaped
    # back: the same predictions as the plain path, to rounding (f64)
    from knode_cosserat_tpu_torch.ops.next_segment import \
        make_fused_next_segment
    calls = []
    op = make_fused_next_segment(pk, kspec)
    fused_fn = lambda *a: calls.append(a[1].shape) or op(*a)
    args = (pk, kspec, net, torch.tensor(trajs), torch.tensor(ctls), (3, 5))
    got = kloss.grow_predictions(*args, fused_fn=fused_fn)
    want = kloss.grow_predictions(*args)
    assert calls == [(2 * 4 * 2, 19)]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("dist_ord", [1, 2])
def test_dtw_device_matches_jax_and_host(dist_ord):
    g = np.random.RandomState(7)
    x, y = g.randn(7, 3), g.randn(9, 3)
    got = float(kdtw.dtw_device(torch.tensor(x), torch.tensor(y), dist_ord))
    want = float(jdtw.dtw_device(jnp.asarray(x), jnp.asarray(y),
                                 dist_ord=dist_ord))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(got, jmetrics.dtw(x, y, dist_ord)[0],
                               rtol=RTOL)
    # tip DTW of a batch of rollouts against one reference
    preds, ref = g.randn(3, 8, 4, 25), g.randn(6, 4, 25)
    got = kdtw.tip_dtw_device(torch.tensor(preds), torch.tensor(ref),
                              dist_ord=dist_ord).numpy()
    want = np.asarray(jdtw.tip_dtw_device(jnp.asarray(preds),
                                          jnp.asarray(ref),
                                          dist_ord=dist_ord))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_checkpoint_format_is_shared(tmp_path):
    """A JAX checkpoint (params + optax state + history) loads in the port;
    the port writes the same bytes for the same tree, which JAX loads."""
    import optax
    spec = jmlp.MLPSpec.for_knode(8)
    params = jmlp.init_mlp(spec, jax.random.PRNGKey(1), jnp.float64)
    opt_state = optax.adam(1e-2).init(params)
    tree = {"params": params, "opt_state": opt_state,
            "loss": np.arange(3.0), "dtw": [(0, 1.5), (4, 0.5)]}
    path = jckpt.save_checkpoint(str(tmp_path / "jax"), tree,
                                 meta={"epoch": 4})
    got, meta = kckpt.load_checkpoint(path)
    assert meta == {"epoch": 4}
    assert got["dtw"] == [(0, 1.5), (4, 0.5)]
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the port's writer: tensors as leaves, the same structure and arrays
    plain = {"params": tuple({k: np.asarray(v) for k, v in layer.items()}
                             for layer in params),
             "loss": np.arange(3.0), "dtw": [(0, 1.5), (4, 0.5)]}
    ttree = dict(plain, params=tuple({k: torch.tensor(v) for k, v in
                                      layer.items()}
                                     for layer in plain["params"]),
                 loss=torch.arange(3.0, dtype=torch.float64))
    path = jckpt.save_checkpoint(str(tmp_path / "jax2"), plain,
                                 meta={"epoch": 4})
    kpath = kckpt.save_checkpoint(str(tmp_path / "port"), ttree,
                                  meta={"epoch": 4})
    a, b = np.load(path), np.load(kpath)
    assert str(a["__structure__"]) == str(b["__structure__"])
    assert a.files == b.files
    for f in a.files:
        np.testing.assert_array_equal(a[f], b[f])
    back, _ = jckpt.load_checkpoint(kpath, like=plain)
    np.testing.assert_array_equal(np.asarray(back["params"][0]["w"]),
                                  np.asarray(params[0]["w"]))


def test_async_checkpoint_writer_snapshots(tmp_path):
    hist = [(0, 1.0)]
    with kckpt.AsyncCheckpointWriter() as w:
        w.save(str(tmp_path / "a"), {"dtw": hist, "w": torch.ones(3)})
        hist.append((1, 2.0))          # after the save: not in the file
    got, _ = kckpt.load_checkpoint(str(tmp_path / "a"))
    assert got["dtw"] == [(0, 1.0)]
    np.testing.assert_array_equal(got["w"], np.ones(3))


def test_constructors_default_to_the_card(monkeypatch):
    """Without a card the default device raises; device="cpu" builds."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        K.experimental_rod()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        K.init_mlp(K.MLPSpec.for_knode(8), torch.Generator().manual_seed(0))
    p = K.experimental_rod(device="cpu")
    assert p.device.type == "cpu" and p.L.device.type == "cpu"
    net = K.init_mlp(K.MLPSpec.for_knode(8), torch.Generator().manual_seed(0),
                     device="cpu")
    assert next(net.parameters()).device.type == "cpu"
