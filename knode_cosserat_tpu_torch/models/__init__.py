from .mlp import (ACTIVATIONS, KnodeMLP, MLPSpec, StackedMLP, bind,
                  clamp_nonnegative, count_params, init_mlp, mlp_apply,
                  params_from_jax, stacked_params_from_jax)
