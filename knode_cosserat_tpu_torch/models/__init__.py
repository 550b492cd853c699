from .mlp import (ACTIVATIONS, KnodeMLP, MLPSpec, bind, clamp_nonnegative,
                  count_params, init_mlp, mlp_apply, params_from_jax)
