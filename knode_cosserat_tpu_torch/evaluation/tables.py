"""Experiment-grid evaluation: DTW / pose-MSE tables against the no-NN
baseline.

PyTorch counterpart of ``knode_cosserat_tpu/evaluation/tables.py``
(physics_multitrain.py:169-233: per-cell rollout -> DTW + pose MSE -> %
change against the baseline of the same mod, records saved to evals/; and
the cross-seed aggregation of physics_multigraphs.py:99-148). The rollouts
run on the reference rod's device; the metrics on the host, or the DTW on
the device (``dtw_impl="device"``, ops/dtw.py).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..controls import calc_controls
from ..core.params import RodParams, apply_mod
from ..core.stepper import simulate, simulate_scan
from ..models.mlp import MLPSpec, StackedMLP
from ..training.train import _default_tol
from ..utils.profiling import annotate
from .metrics import pct_error, pose_mse, tip_dtw

__all__ = ["EvalRecord", "make_eval_data", "evaluate_cells",
           "format_table", "aggregate_seeds"]


@dataclasses.dataclass
class EvalRecord:
    label: str            # e.g. "sine sine 0.5 1.0 nsw 0" or "baseline nsw"
    eval_name: str        # e.g. "sine 1.5"
    dtw: float
    mse: float
    dtw_pct: Optional[float] = None   # vs the matching baseline
    mse_pct: Optional[float] = None
    tensions: Optional[np.ndarray] = None
    reference: Optional[np.ndarray] = None
    predicted: Optional[np.ndarray] = None
    # the largest Newton residual norm of the rollout's steps (not in the
    # JAX package's record; the port's evidence that every step solved)
    residual: Optional[float] = None


def make_eval_data(reference_rod: RodParams, eval_set: Sequence[str],
                   eval_len: int = 100) -> Dict[str, dict]:
    """Reference rollouts for each eval schedule (calc_evaldata,
    physics_multitrain.py:132-138) through the scan, as the JAX package
    builds them whatever the eval's impl, with the Newton tolerance of the
    rod's dtype. Values: {"controls" (T, 4), "interpolated" (T, N, 25)},
    numpy."""
    out = {}
    tol = _default_tol(reference_rod.dtype)
    for name in eval_set:
        kind, arg = name.split(" ")
        controls = calc_controls(kind, float(arg),
                                 float(reference_rod.del_t), eval_len)
        traj = simulate(reference_rod, controls, tol=tol)
        out[name] = {"controls": controls,
                     "interpolated": traj[:, :, :25].cpu().numpy()}
    return out


def _mod_rod(mod, like: RodParams, original: bool) -> RodParams:
    return apply_mod(mod, original=original, N=like.N, dtype=like.dtype,
                     device=like.device)


def _mega_rollouts(rod: RodParams, spec, nets, controls):
    """The rollouts of ``rod`` on K2 (core/fast_rollout.py): one rod with no
    net, or one rod per net with the nets stacked, one launch per step for
    all of them. Returns (trajs (R, T, N, 50), max residual norm per rod)."""
    from ..core.fast_rollout import mega_rollout_cached
    roll = mega_rollout_cached(rod, spec, tol=_default_tol(rod.dtype))
    if nets is None:
        trajs, res, _ = roll(controls[None])
    else:
        with annotate("eval.stack"):
            stacked = StackedMLP(nets).to(dtype=rod.dtype, device=rod.device)
        trajs, res, _ = roll(controls[None].expand(len(nets), -1, -1), stacked)
    return trajs, res.amax(0)


def _scan_rollout(rod: RodParams, spec, net, controls):
    """One rollout through the autodiff-Newton scan (core/stepper.py, the
    JAX package's "xla"). Returns (traj (T, N, 50), max residual norm)."""
    with torch.no_grad():
        out = simulate_scan(rod, controls, nn_fn=net,
                            nn_history=spec.history if net is not None
                            else False, tol=_default_tol(rod.dtype))
    return out.traj, out.residuals.max()


def evaluate_cells(
    cells,                       # Sequence[GridCell]
    params_list,                 # per-cell nets (KnodeMLP)
    spec: MLPSpec,
    eval_set: Sequence[str],
    reference_rod: Optional[RodParams] = None,
    eval_len: int = 100,
    original: bool = False,
    save_dir: Optional[str] = None,
    keep_arrays: bool = False,
    impl: str = "auto",
    dtw_impl: str = "device",
) -> List[EvalRecord]:
    """Roll out every trained cell and every no-NN baseline on every eval
    schedule; score DTW and pose MSE with the % change against the
    baseline of the same mod (physics_multitrain.py:178-233).

    impl: "auto", "mega" or "scan" (the JAX package's "xla", accepted as
    the same). "auto" is "mega" on a CUDA rod and "scan" on a CPU rod.
    "mega" groups the cells by mod and rolls each group out on kernel K2
    with one net per rod (a StackedMLP): one launch per step carries every
    cell of the mod; the baselines take the physics-only K2 rollout. The
    reference rollouts, the ground truth every record is scored against,
    take the scan whatever the impl (make_eval_data).
    The card takes "mega" because the scan solves each step through
    autograd with many small launches and host syncs per Newton iteration
    (a 99-step scan of one rod takes tens of seconds there), while a K2
    step of a group costs what one rod's does: its rods run in parallel
    threads. (The JAX docstring's "mega measured slower at 40 cells" is a
    TPU measurement.) On the CPU "mega" runs K2's plain version and "scan"
    is the JAX package's default. dtw_impl: "device" scores each batch with
    the exact DTW of ops/dtw.py on the rollouts' device; "host" uses the
    reference's fastdtw per rollout."""
    if reference_rod is None:
        reference_rod = apply_mod(None, original=original)
    if impl == "auto":
        impl = "mega" if reference_rod.device.type == "cuda" else "scan"
    if impl == "xla":
        impl = "scan"
    if impl not in ("mega", "scan"):
        raise ValueError(f"impl {impl!r}: use 'auto', 'mega' or 'scan'")
    dtype, dev = reference_rod.dtype, reference_rod.device
    eval_data = make_eval_data(reference_rod, eval_set, eval_len)

    def score_dtw(trajs_b, ref_traj):
        """(B, T, N, >=25) predicted batch -> list of B DTW distances."""
        if dtw_impl == "device":
            from ..ops.dtw import tip_dtw_device
            return [float(d) for d in tip_dtw_device(
                trajs_b[:, :, :, :25], torch.as_tensor(ref_traj))]
        return [tip_dtw(t[:, :, :25].cpu().numpy(), ref_traj) for t in trajs_b]

    mods = sorted({c.mod for c in cells}, key=str)
    records: List[EvalRecord] = []
    baselines: Dict[Tuple[str, Optional[str]], Dict[str, float]] = {}

    for eval_name in eval_set:
        controls = torch.as_tensor(eval_data[eval_name]["controls"],
                                   dtype=dtype, device=dev)
        ref_traj = eval_data[eval_name]["interpolated"]

        # --- baselines: the modified rods, no NN ---
        outs = []
        for mod in mods:
            rod = _mod_rod(mod, reference_rod, original)
            if impl == "mega":
                t, r = _mega_rollouts(rod, None, None, controls)
                outs.append((t[0], r[0]))
            else:
                outs.append(_scan_rollout(rod, None, None, controls))
        base_trajs = torch.stack([t for t, _ in outs])
        base_dtws = score_dtw(base_trajs, ref_traj)
        for mod, (traj, res), dtw in zip(mods, outs, base_dtws):
            traj = traj.cpu().numpy()
            mse = pose_mse(traj[:, :, :25], ref_traj)
            baselines[(eval_name, mod)] = {"dtw": dtw, "mse": mse}
            records.append(_record(f"baseline {mod}", eval_name, dtw, mse,
                                   None, None, eval_data[eval_name], traj,
                                   save_dir, keep_arrays, original,
                                   float(res)))

        # --- trained cells ---
        if not cells:
            continue
        trajs = [None] * len(cells)
        resid = [None] * len(cells)
        if impl == "mega":
            by_mod: Dict[Optional[str], list] = {}
            for i, c in enumerate(cells):
                by_mod.setdefault(c.mod, []).append(i)
            for mod, idxs in by_mod.items():
                t, r = _mega_rollouts(_mod_rod(mod, reference_rod, original),
                                      spec, [params_list[i] for i in idxs],
                                      controls)
                for j, i in enumerate(idxs):
                    trajs[i], resid[i] = t[j], r[j]
        else:
            for i, c in enumerate(cells):
                trajs[i], resid[i] = _scan_rollout(
                    _mod_rod(c.mod, reference_rod, original), spec,
                    params_list[i], controls)
        cell_trajs = torch.stack(trajs)
        cell_dtws = score_dtw(cell_trajs, ref_traj)
        for cell, traj, dtw, res in zip(cells, cell_trajs.cpu().numpy(),
                                        cell_dtws, resid):
            mse = pose_mse(traj[:, :, :25], ref_traj)
            base = baselines[(eval_name, cell.mod)]
            records.append(_record(
                f"{cell.data} {cell.mod} {cell.seed}", eval_name, dtw,
                mse, pct_error(dtw, base["dtw"]),
                pct_error(mse, base["mse"]), eval_data[eval_name], traj,
                save_dir, keep_arrays, original, float(res)))
    return records


def _record(label, eval_name, dtw, mse, dtw_pct, mse_pct, eval_data, traj,
            save_dir, keep_arrays, original, residual=None):
    rec = EvalRecord(label=label, eval_name=eval_name, dtw=dtw, mse=mse,
                     dtw_pct=dtw_pct, mse_pct=mse_pct, residual=residual)
    if keep_arrays:
        rec.tensions = eval_data["controls"]
        rec.reference = eval_data["interpolated"]
        rec.predicted = traj[:, :, :25]
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        prefix = "physics_original" if original else "physics"
        fname = (eval_name.replace(" ", "_") + "+"
                 + label.replace(" ", "_"))
        np.savez_compressed(
            os.path.join(save_dir, f"{prefix}_{fname}.npz"),
            tensions=eval_data["controls"],
            reference=eval_data["interpolated"],
            predicted=traj[:, :, :25])
    return rec


def format_table(records: List[EvalRecord], space: int = 40) -> str:
    """The semicolon-padded text table (physics_multitrain.py:172-233)."""
    eval_names = sorted({r.eval_name for r in records})
    labels = list(dict.fromkeys(r.label for r in records))
    by = {(r.label, r.eval_name): r for r in records}

    lines = [" " * space + "".join(
        (";" + e + " DTW").ljust(20) + (";" + e + " PQ MSE").ljust(20)
        for e in eval_names)]
    for label in labels:
        row = label.ljust(space)
        for e in eval_names:
            r = by.get((label, e))
            if r is None:
                row += ";-".ljust(40)
            elif r.dtw_pct is None:
                row += f";{r.dtw:.2f}".ljust(20) + f";{r.mse:.2f}".ljust(20)
            else:
                row += (f";{r.dtw:.2f} ({r.dtw_pct:+.1f}%)".ljust(20)
                        + f";{r.mse:.2f} ({r.mse_pct:+.1f}%)".ljust(20))
        lines.append(row)
    return "\n".join(lines)


def aggregate_seeds(records: List[EvalRecord]) -> List[EvalRecord]:
    """Average DTW / MSE across seeds per (data, mod, eval) and recompute
    the % change against the baseline (physics_multigraphs.py:108-148)."""
    def strip_seed(label: str) -> str:
        parts = label.split(" ")
        return " ".join(parts[:-1]) if parts[-1].isdigit() else label

    groups: Dict[Tuple[str, str], List[EvalRecord]] = {}
    baselines = {}
    for r in records:
        if r.label.startswith("baseline"):
            baselines[(r.label, r.eval_name)] = r
        else:
            groups.setdefault((strip_seed(r.label), r.eval_name),
                              []).append(r)

    out = list(baselines.values())
    for (label, eval_name), rs in groups.items():
        dtw = float(np.mean([r.dtw for r in rs]))
        mse = float(np.mean([r.mse for r in rs]))
        mod = label.split(" ")[-1]
        base = baselines.get((f"baseline {mod}", eval_name))
        out.append(EvalRecord(
            label=label, eval_name=eval_name, dtw=dtw, mse=mse,
            dtw_pct=pct_error(dtw, base.dtw) if base else None,
            mse_pct=pct_error(mse, base.mse) if base else None))
    return out
