"""The parallel stack: the ("data", "seq", "model") device mesh
(mesh.py) over the process group that distributed.py starts, the
experiment grids trained together by kernel K5 and split over "data"
(grid.py), sharded training (sharded_train.py: train_knode(mesh=)'s
machinery and the deprecated ShardedTrainer) and the halo-exchange
multiple-shooting rollout (spatial.py)."""
from .mesh import make_mesh, data_sharding, replicated, shard_params_tp
from .sharded_train import ShardedTrainer
from .grid import GridCell, GridResult, grid_train, build_grid
from .distributed import init_distributed, is_multihost, process_summary
from .spatial import simulate_scan_ms_halo

__all__ = ["make_mesh", "data_sharding", "replicated", "shard_params_tp",
           "ShardedTrainer", "GridCell", "GridResult", "grid_train",
           "build_grid", "init_distributed", "is_multihost",
           "process_summary", "simulate_scan_ms_halo"]
