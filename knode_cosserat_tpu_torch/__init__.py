"""knode_cosserat_tpu_torch — the PyTorch + CUDA port of knode_cosserat_tpu.

Dynamic Cosserat-rod simulation and KNODE hybrid (physics + residual MLP)
models of tendon-driven continuum robots, in PyTorch. Module paths and
public names mirror the JAX package ``knode_cosserat_tpu``, which stays the
reference this port is tested against. The port imports neither jax nor
optax.

Constructors that make tensors from nothing (rods, nets) build on the CUDA
card unless the caller passes ``device="cpu"`` (device.py); without a card
they raise. Everything downstream follows the device of the rod.

On the CPU every kernel runs as its plain PyTorch version. On a CUDA device
the hot path runs hand-written Hopper kernels (``csrc/``), built with nvcc
at their first launch: K1 (the per-node hybrid RHS), K3 (the spatial
sweep, ops/sweep.py), K2 (one whole Newton shooting step, ops/step.py),
K4 and K5 (the whole training run, and a grid of them, ops/train.py), K6
(the whole training run at any hidden width, ops/train_wide.py), K7 (one
coupled multi-rod Newton step, ops/assembly.py, under
core/assembly.simulate_assembly(fused=True) and the plate-pose planners of
control/) and K8 (the teacher-forced next segment, ops/next_segment.py,
under make_train_step(use_pallas=True)). The multitrain study
(parallel/grid.py, evaluation/tables.py) runs as
``python -m knode_cosserat_tpu_torch multitrain``; the study's ``train``
and ``simulate`` and the real-world pipeline (``prepare``, ``estimate``,
``train-real``, ``playback``; realworld/) are commands of the same CLI.
The model-based side differentiates through the implicit rod
(core/shooting.implicit_root, simulate_scan(differentiable=True)): the
single-rod planner control/mpc.py, whose forward roots are K2 launches on
the card, system identification training/sysid.py (the CLI's ``sysid`` and
``design``), and online adaptation training/online.py with
utils/health.py. The parallel stack (parallel/: a ("data", "seq",
"model") mesh over torch.distributed, sharded train_knode and grids,
segment sharding and the halo-exchange multiple-shooting solver) runs one
rank per device, started with torchrun; the rod kernels take KNODE nets of
any depth up to eight layers.

Importing the package builds and loads nothing: the kernel modules
(ops/sweep.py, ops/step.py, ops/train.py, ops/train_wide.py,
ops/assembly.py, ops/next_segment.py, ops/_build.py) are imported at first
use.
"""
import torch

from . import controls
from .controls import calc_controls
from .core.fast_rollout import (make_fast_rollout, make_fast_step,
                                mega_rollout_cached)
from .core.params import (MODS, MODS_ORIGINAL, RodParams, apply_mod, derive,
                          experimental_rod, make_rod, original_rod,
                          rod_from_numpy)
from .core.rhs import rhs
from .core.stepper import SimOutput, initial_state, simulate, simulate_scan
from .models.mlp import (KnodeMLP, MLPSpec, StackedMLP, bind, init_mlp,
                         mlp_apply, params_from_jax, stacked_params_from_jax)
from .serving import CompiledStepper, StepState
from .training import (TrainConfig, TrainResult, make_training_data,
                       make_validation_reference, teacher_forced_loss,
                       train_knode)

__version__ = "0.1.0"

# float32 matmuls in full precision on the card (the JAX package pins its
# physics to Precision.HIGHEST; TF32 keeps ~3 decimal digits)
torch.backends.cuda.matmul.allow_tf32 = False
