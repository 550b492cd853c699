"""Work of K4 (the whole training run of epochs per launch, csrc/train.cu)
and of a training epoch, counted from the plain reference's epoch.

Per cell and epoch: the forward layers 2 H din and 2 H 25, their backward
(2 H 25 for the output layer's weights, 2 H 25 for the hidden gradient,
2 H din for the input layer's weights; no input gradient), the ELU and
its derivative 3 H, and the loss on the 25 outputs with its gradient
(the Euler map of the grown quaternion included) LOSS_OPS. Per parameter
and epoch: Adam(W) with the plateau's scale and the clamp, ADAM_OPS.
"""

LOSS_OPS = 400
ADAM_OPS = 16


def cells(recordings: int, train_len: int, keypoints: int) -> int:
    return recordings * (train_len - 1) * keypoints


def n_params(dims) -> int:
    din, hidden, dout = dims
    return hidden * (din + 1) + dout * (hidden + 1)


def epoch_mlp_flops(C: int, dims) -> int:
    """The net's matrix work of one epoch over C cells: 2 C H (2 din + 75)
    for (din, H, 25); the numerator of the training MFU."""
    din, hidden, dout = dims
    return 2 * C * hidden * (2 * din + 3 * dout)


def epoch_flops(C: int, dims) -> int:
    """All the operations of one epoch."""
    hidden = dims[1]
    return (epoch_mlp_flops(C, dims) + C * (3 * hidden + LOSS_OPS)
            + ADAM_OPS * n_params(dims))


def launch_bytes(C: int, dims, epochs: int) -> int:
    """One launch: the cells (inputs, grown base, strains, targets, target
    Euler angles) read once, the weights and both moments in and out, the
    4 optimizer scalars in and out, one loss an epoch out."""
    din = dims[0]
    return 4 * (C * (din + 19 + 6 + 19 + 6 + 3) + 6 * n_params(dims) + 8
                + epochs)
