"""train_knode's fused loop composed chunk by chunk, as it ran before the
run stayed on the device between chunks: the comparison the fused-run tests
hold train_knode to, on the CPU (tests/test_torch_train_knode.py) and on
the card (tests/test_torch_cuda.py). Imports only the port."""
import numpy as np
import torch

from knode_cosserat_tpu_torch.models.mlp import init_mlp
from knode_cosserat_tpu_torch.ops import train as kt
from knode_cosserat_tpu_torch.ops import train_wide as kw
from knode_cosserat_tpu_torch.ops.dtw import tip_dtw_device
from knode_cosserat_tpu_torch.training import checkpoint as kckpt
from knode_cosserat_tpu_torch.training import train as ktrain


def chained(p, trajs, ctls, cfg, vc=None, vr=None, resume_from=None,
             checkpoint=False):
    """train_knode's fused loop composed chunk by chunk: a runner a chunk
    on the net, the net copied back, the optimizer's state converted in
    and out and the losses read back after every chunk. Returns the loss
    history, the net, the DTW history, the log lines and the checkpoints
    ((epoch, tree), ...)."""
    spec = cfg.spec()
    net = init_mlp(spec, torch.Generator().manual_seed(cfg.seed),
                   torch.float32, p.device)
    opt = ktrain.make_optimizer(cfg, net)
    hist = []
    if resume_from:
        ck, _ = kckpt.load_checkpoint(resume_from)
        ktrain._load_net(net, ck["params"])
        ktrain.optim_state_from_jax(ck["opt_state"], opt)
        hist = [float(x) for x in np.asarray(ck["loss"])]
    make = (kw.make_wide_training_run if cfg.fused.startswith("wide")
            else kt.make_fused_training_run)
    plain = cfg.fused in ("plain", "interpret", "wide_interpret")
    t = torch.as_tensor(trajs, dtype=torch.float32, device=p.device)
    c = torch.as_tensor(ctls, dtype=torch.float32, device=p.device)
    impl = "mega" if p.device.type == "cuda" else "scan"
    do_eval = vc is not None
    chunk = cfg.eval_every if do_eval else max(cfg.log_every, 1)
    chunk = max(1, min(chunk, cfg.epochs + 1))
    dtws, lines, saved, epoch = [], [], [], 0
    while epoch <= cfg.epochs:
        if do_eval and epoch % cfg.eval_every == 0:
            vc_t = torch.as_tensor(vc, dtype=p.dtype, device=p.device)
            traj = (ktrain.simulate(p, vc_t, tol=ktrain._default_tol(p.dtype))
                    if epoch == 0 else
                    ktrain.rollout_with_nn(p, vc_t, spec,
                                           ktrain._on_rod(net, p), impl=impl))
            d = float(tip_dtw_device(traj[None, :, :, :25],
                                     torch.as_tensor(vr).to(p.device))[0])
            dtws.append((epoch, d))
            lines.append(f"Validation DTW Distance XYZ {d}")
        n = min(chunk, cfg.epochs + 1 - epoch)
        new, losses, state = make(p, spec, cfg, n, plain=plain)(
            net, t, c, kt.fused_state_from_optimizer(opt))
        with torch.no_grad():
            for P, Q in zip(net.parameters(), new.parameters()):
                P.copy_(Q)
        kt.load_fused_state(opt, state)
        losses = losses.cpu().numpy()
        hist.extend(float(x) for x in losses)
        epoch += n
        if checkpoint and epoch % cfg.checkpoint_every < n:
            saved.append((epoch, {
                "params": ktrain._net_tree(net),
                "opt_state": ktrain.optim_state_to_jax(opt),
                "loss": np.asarray(hist), "dtw": list(dtws)}))
        if (epoch // chunk) % max(1, cfg.log_every // chunk) == 0:
            lines += [f"Epoch {epoch - 1} of {cfg.epochs}",
                      f"Total loss: {losses[-1]:.6e}"]
    return hist, net, dtws, lines, saved


def flat(tree):
    """A checkpoint's tree as (its structure, its array leaves)."""
    leaves = []
    return kckpt._serialize(tree, leaves), leaves
