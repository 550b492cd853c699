"""Unified experiment configuration.

PyTorch-port copy of ``knode_cosserat_tpu/config.py``: one JSON-able
dataclass tree that names a full experiment (rod setup, data specs,
training hyperparameters, eval protocol), over the port's ``TrainConfig``
(whose fields and defaults are the JAX package's). The CLI builds these
from flags; checkpoints embed them as metadata, in the same form as the
JAX package's, and ``short_name`` names the same file.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Tuple

from .training.train import TrainConfig

__all__ = ["RodConfig", "DataConfig", "EvalConfig", "ExperimentConfig"]


@dataclasses.dataclass
class RodConfig:
    mod: Optional[str] = None
    original: bool = False        # original-paper params vs measured hardware
    N: int = 10

    def build(self, dtype=None, device=None):
        """The rod, in ``dtype`` (default float64, the port's) on ``device``
        (default the CUDA card, device.py)."""
        import torch

        from .core.params import apply_mod
        return apply_mod(self.mod, original=self.original, N=self.N,
                         dtype=dtype or torch.float64, device=device)


@dataclasses.dataclass
class DataConfig:
    specs: List[Tuple[str, float]] = dataclasses.field(
        default_factory=lambda: [("sine", 0.5)])
    train_len: int = 30
    noise_traj: float = 0.0
    noise_controls: float = 0.0


@dataclasses.dataclass
class EvalConfig:
    validation: Tuple[str, float] = ("sine", 1.25)   # physics_train.py:61
    eval_len: int = 100


@dataclasses.dataclass
class ExperimentConfig:
    rod: RodConfig = dataclasses.field(default_factory=RodConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    name: str = ""

    # --- identity: the reference encodes experiments in filenames
    #     (physics_train.py:68-70); we keep a compatible short name ---
    def short_name(self) -> str:
        if self.name:
            return self.name
        types = "-".join(t for t, _ in self.data.specs)
        args = "-".join(str(a) for _, a in self.data.specs).replace(".", "_")
        prefix = "physics_original" if self.rod.original else "physics"
        return (f"{prefix}_{types}_{args}_{self.rod.mod}_trainlen_"
                f"{self.data.train_len}_{self.train.epochs}_epoch_"
                f"{self.train.seed}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentConfig":
        d = dict(d)
        d["rod"] = RodConfig(**d.get("rod", {}))
        data = dict(d.get("data", {}))
        data["specs"] = [tuple(s) for s in data.get("specs", [("sine", 0.5)])]
        d["data"] = DataConfig(**data)
        tr = dict(d.get("train", {}))
        if "keypoints" in tr:
            tr["keypoints"] = tuple(tr["keypoints"])
        d["train"] = TrainConfig(**tr)
        ev = dict(d.get("eval", {}))
        if "validation" in ev:
            ev["validation"] = tuple(ev["validation"])
        d["eval"] = EvalConfig(**ev)
        return cls(**d)

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "ExperimentConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))
