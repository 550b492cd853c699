"""Structured tree checkpoints, in the JAX package's file format.

PyTorch counterpart of ``knode_cosserat_tpu/training/checkpoint.py``. A
checkpoint is one ``<path>.npz`` holding the array leaves (``leaf_00000``,
...) beside two JSON strings: ``__structure__`` (the nested dict / list /
tuple / namedtuple tree, leaves by index) and ``__meta__``. The format is
the JAX package's, byte for byte, so a checkpoint written there loads here
and the other way round. Leaves may be tensors (saved from the host) or
numpy arrays; they load as numpy arrays, and a namedtuple loads as a tuple.
The JAX package's orbax directory format is not ported.
"""
from __future__ import annotations

import json
import os
import queue
import threading
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "AsyncCheckpointWriter"]


def _serialize(tree, leaves: list):
    if isinstance(tree, dict):
        return {"__kind__": "dict",
                "items": {k: _serialize(v, leaves) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        if hasattr(tree, "_fields"):  # namedtuple
            kind = "namedtuple:" + type(tree).__name__
        return {"__kind__": kind,
                "items": [_serialize(v, leaves) for v in tree]}
    if tree is None:
        return {"__kind__": "none"}
    if isinstance(tree, (int, float, str, bool)):
        return {"__kind__": "scalar", "value": tree}
    idx = len(leaves)
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    leaves.append(np.asarray(tree))
    return {"__kind__": "leaf", "index": idx}


def _deserialize(node, leaves):
    kind = node["__kind__"]
    if kind == "dict":
        return {k: _deserialize(v, leaves) for k, v in node["items"].items()}
    if kind in ("list", "tuple") or kind.startswith("namedtuple:"):
        items = [_deserialize(v, leaves) for v in node["items"]]
        return items if kind == "list" else tuple(items)
    if kind == "none":
        return None
    if kind == "scalar":
        return node["value"]
    return leaves[node["index"]]


def save_checkpoint(path: str, tree: Any, meta: Optional[dict] = None) -> str:
    """Save a tree + JSON-able metadata. Returns the written path."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    leaves: list = []
    structure = _serialize(tree, leaves)
    arrays = {f"leaf_{i:05d}": leaf for i, leaf in enumerate(leaves)}
    np.savez_compressed(path, __structure__=json.dumps(structure),
                        __meta__=json.dumps(meta or {}), **arrays)
    return path


def _snapshot(tree):
    """The tree's containers rebuilt (leaves shared), so that later appends
    to a list the caller keeps do not reach a queued save."""
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_snapshot(v) for v in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return items if isinstance(tree, list) else tuple(items)
    return tree


class AsyncCheckpointWriter:
    """Checkpoint writes on a worker thread, so a training loop does not
    stall on host IO.

    ``save`` snapshots the tree's containers at enqueue time (leaves are
    held by reference: the training loop replaces its tensors rather than
    writing into saved ones) and queues the device-to-host copy and the
    write. Writes are ordered; ``wait()`` blocks until every queued save is
    on disk and re-raises the first worker error. Usable as a context
    manager.
    """

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            path, tree, meta = item
            try:
                save_checkpoint(path, tree, meta)
            except BaseException as e:  # surfaced by wait()
                if self._err is None:
                    self._err = e
            finally:
                self._q.task_done()

    def save(self, path: str, tree: Any, meta: Optional[dict] = None):
        if self._err is not None:
            err, self._err = self._err, None
            raise err
        self._q.put((path, _snapshot(tree), dict(meta) if meta else meta))

    def wait(self):
        self._q.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def close(self):
        self.wait()
        self._q.put(None)
        self._q.join()
        self._thread.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def load_checkpoint(path: str):
    """Load (tree, meta): nested dicts / lists / tuples of numpy arrays."""
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory (the JAX package's orbax "
                         "format), which the port does not read")
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as data:
        structure = json.loads(str(data["__structure__"]))
        meta = json.loads(str(data["__meta__"]))
        n = len([k for k in data.files if k.startswith("leaf_")])
        leaves = [data[f"leaf_{i:05d}"] for i in range(n)]
    return _deserialize(structure, leaves), meta
