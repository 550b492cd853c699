"""Experiment grids (the multitrain study): ``build_grid`` and
``grid_train``, the (data x mod x seed) cells trained together on one card
by kernel K5. The multi-card layouts (the JAX package's parallel/mesh.py,
distributed.py, spatial.py) are not ported (ROADMAP.md, Queue 1, item 4)."""
from .grid import GridCell, GridResult, build_grid, grid_train

__all__ = ["GridCell", "GridResult", "build_grid", "grid_train"]
