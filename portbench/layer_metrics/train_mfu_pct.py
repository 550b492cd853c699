"""The whole training step's share of the chip's float32 peak over the
measured window: the net's matrix work (2 C H (2 din + 75) an epoch,
counts/k4.py) of every epoch done, over the window's seconds and 67
TFLOP/s."""
from portbench.counts import k4, peaks


def read(ctx):
    w, cfg = ctx.window, ctx.run.cfg
    C = k4.cells(cfg["data"]["recordings"], cfg["data"]["train_len"],
                 len(cfg["train"]["keypoints"]))
    flops = w["epochs"] * k4.epoch_mlp_flops(C, cfg["net"]["dims"])
    return 100.0 * flops / (w["wall_s"] * peaks.PEAK_F32)
