"""Rosbag ingestion for physical-experiment data.

Parity rewrite of reference prepare.py:173-297 (read_bag): Vicon pose topics
for 5 markers, /tension (QuaternionStamped carrying the 4 measured tensions)
and /rosout-logged serial commands, merged by time with forward-fill,
trimmed, ZOH-resampled onto the solver's del_t grid and converted
grams -> newtons.

``read_bag`` ingests .bag files directly: via ``bagpy`` when installed,
else the built-in pure-Python rosbag v2.0 reader (rosbag_io.py) — no ROS
required. ``read_topic_csvs`` additionally consumes a directory of
per-topic CSVs (the format bagpy extracts) for pre-exported data.

Framework-free copy of ``knode_cosserat_tpu/realworld/bag.py``. pandas is
imported by the functions that build or merge tables, not with the module,
so that the package and the estimate / train-real commands run where
pandas is absent; ingestion there raises an ImportError naming pandas.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["interpolate_zoh", "merge_pose_topics", "extract_tensions",
           "read_topic_csvs", "read_bag", "grams_to_newtons", "TO_TRIM",
           "CMD_FUDGE_SECONDS"]

# per-file start trim in seconds (prepare.py:20-26)
TO_TRIM = {
    "dir_a_tension_800.bag": 2,
    "dir_a_tension_950.bag": 0,
    "dir_a_tension_1100.bag": 9,
    "dir_a_tension_1250.bag": 8,
    "dir_a_tension_1400.bag": 6,
}
# command-vs-measurement timing fudge (prepare.py:205)
CMD_FUDGE_SECONDS = 0.06

POSE_TOPICS = {
    "base": "/vicon/continuum_base/pose",
    "link0": "/vicon/continuum_0/pose",
    "link1": "/vicon/continuum_1/pose",
    "link2": "/vicon/continuum_2/pose",
    "link3": "/vicon/continuum_3/pose",
}


def _pandas():
    """pandas, imported at use; its absence raises an ImportError that
    names it and what needs it."""
    try:
        import pandas
    except ImportError as e:
        raise ImportError(
            "pandas is needed to ingest experiment recordings (prepare, "
            "realworld.bag); it is not installed") from e
    return pandas


def grams_to_newtons(x):
    """Firmware setpoints/readings are grams (firmware.ino:76-92);
    tensions enter the solver in newtons (prepare.py:253-261)."""
    return np.asarray(x, np.float64) / 1000.0 * 9.81


def interpolate_zoh(new_time, original_time, original_values) -> np.ndarray:
    """Zero-order-hold resampling (prepare.py:223-235), vectorized."""
    original_time = np.asarray(original_time, np.float64)
    original_values = np.asarray(original_values, np.float64)
    idx = np.searchsorted(original_time, np.asarray(new_time, np.float64),
                          side="right") - 1
    idx = np.clip(idx, 0, len(original_values) - 1)
    return original_values[idx]


def merge_pose_topics(frames: Dict[str, pd.DataFrame]) -> pd.DataFrame:
    """Time-ordered forward-fill merge of the 5 pose tables
    (prepare.py:188-202), dropping leading rows with missing links."""
    pd = _pandas()
    names = list(POSE_TOPICS)
    merged = frames[names[0]].add_prefix(f"{names[0]}.").reset_index()
    for name in names[1:]:
        nxt = frames[name].add_prefix(f"{name}.").reset_index()
        merged = pd.merge_ordered(merged, nxt, on="Time", fill_method="ffill")
    return merged[~merged.isnull().any(axis=1)]


def extract_tensions(tension_df: pd.DataFrame,
                     rosout_df: Optional[pd.DataFrame],
                     ts: np.ndarray) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Measured + commanded tensions on the ts grid, in newtons.

    Channel order quirks replicated from prepare.py:237-251: measured
    tensions come out of the QuaternionStamped as [y, z, w, x]; commands
    regex-parsed from /rosout reorder as [T2, T3, T4, T1]."""
    measured = np.vstack([
        interpolate_zoh(ts, tension_df.index, tension_df[c])
        for c in ["tension.quaternion.y", "tension.quaternion.z",
                  "tension.quaternion.w", "tension.quaternion.x"]]).T
    commanded = None
    if rosout_df is not None and "msg" in rosout_df:
        cmd = rosout_df["msg"].str.extract(
            r"Serial Command: (\d+) (\d+) (\d+) (\d+)").dropna().astype(float)
        if len(cmd):
            commanded = np.vstack([
                interpolate_zoh(ts, cmd.index, cmd[i])
                for i in [1, 2, 3, 0]]).T
            commanded = grams_to_newtons(commanded)
    return grams_to_newtons(measured), commanded


def _assemble(frames, tension, rosout, experiment, del_t, trim_offset=0.0,
              N: int = 10):
    from .preprocess import preprocessed

    merged = merge_pose_topics(frames)
    trim = merged.Time.min() + TO_TRIM.get(os.path.basename(experiment),
                                           trim_offset)
    tension.index = tension.index - trim
    if rosout is not None:
        rosout.index = rosout.index - (trim - CMD_FUDGE_SECONDS)
    merged = merged.assign(Time=merged.Time - trim)

    ts = np.arange(0, merged.Time.max(), del_t)
    controls, controls_cmd = extract_tensions(tension, rosout, ts)
    positions, orientations, interpolated = preprocessed(merged, ts, N=N)
    orientation_quat = [
        np.vstack([r.as_quat(canonical=True) for r in o])
        for o in orientations]
    return dict(t=ts, controls=controls, controls_cmd=controls_cmd,
                interpolated=interpolated, positions=positions,
                orientation=orientation_quat)


def read_topic_csvs(directory: str, del_t: float, experiment: str = "",
                    N: int = 10) -> dict:
    """Ingest a directory of bagpy-style per-topic CSVs (each with a 'Time'
    column): vicon-continuum_{base,0..3}-pose.csv, tension.csv, rosout.csv."""
    pd = _pandas()

    def load(topic):
        path = os.path.join(directory,
                            topic.strip("/").replace("/", "-") + ".csv")
        if not os.path.exists(path):
            return None
        return pd.read_csv(path).set_index("Time")

    frames = {}
    for name, topic in POSE_TOPICS.items():
        df = load(topic)
        if df is None:
            raise FileNotFoundError(f"missing pose topic CSV for {topic} in "
                                    f"{directory}")
        frames[name] = df
    tension = load("/tension")
    tension = tension.add_prefix("tension.") if tension is not None else None
    rosout = load("/rosout")
    return _assemble(frames, tension, rosout, experiment or directory, del_t,
                     N=N)


def read_bag(filename: str, del_t: float, N: int = 10) -> dict:
    """Ingest a .bag directly (prepare.py:173-297).

    Uses bagpy when installed; otherwise the built-in pure-Python rosbag
    v2.0 reader (realworld/rosbag_io.py) — same flattened columns, so the
    rest of the pipeline is loader-agnostic."""
    pd = _pandas()
    try:
        from bagpy import bagreader
    except ImportError:
        from .rosbag_io import read_bag_native
        tables = read_bag_native(filename)
        frames = {}
        for name, topic in POSE_TOPICS.items():
            if topic not in tables:
                raise KeyError(f"{filename}: missing pose topic {topic}")
            frames[name] = tables[topic].set_index("Time")
        tension = tables.get("/tension")
        if tension is not None:
            tension = tension.set_index("Time").add_prefix("tension.")
        rosout = tables.get("/rosout")
        if rosout is not None:
            rosout = rosout.set_index("Time")
        return _assemble(frames, tension, rosout, filename, del_t, N=N)

    b = bagreader(filename)
    frames = {name: pd.read_csv(b.message_by_topic(topic)).set_index("Time")
              for name, topic in POSE_TOPICS.items()}
    tension = pd.read_csv(b.message_by_topic("/tension")) \
        .set_index("Time").add_prefix("tension.")
    rosout = pd.read_csv(b.message_by_topic("/rosout")).set_index("Time")
    return _assemble(frames, tension, rosout, filename, del_t, N=N)
