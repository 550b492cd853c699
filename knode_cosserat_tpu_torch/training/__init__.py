"""The KNODE training slice: data, loss, optimizer, epoch loops,
``train_knode`` and checkpoints. The training kernel's module (ops/train.py)
and the build load at first use, not here."""
from .checkpoint import AsyncCheckpointWriter, load_checkpoint, save_checkpoint
from .data import (make_training_data, make_validation_reference,
                   parse_traj_specs)
from .loss import (DEFAULT_KEYPOINTS_FAST, DEFAULT_KEYPOINTS_REAL,
                   DEFAULT_KEYPOINTS_SLOW, grow_predictions,
                   teacher_forced_loss, teacher_forced_residuals)
from .train import (AdamPlateau, TrainConfig, TrainResult, make_epoch_scan,
                    make_optimizer, make_train_step, optim_state_from_jax,
                    optim_state_to_jax, rollout_with_nn, train_knode)
