"""Mocap preprocessing: orientation unflipping, time resampling, and
sparse-marker -> rod-grid interpolation.

Parity rewrite of reference preprocess.py:7-105 (the fit_curve copy that
also lived there is unified in realworld/curve.py). Host-side numpy/scipy.
Framework-free copy of ``knode_cosserat_tpu/realworld/preprocess.py``.

Data model: a mapping (pandas DataFrame or dict of columns) with Vicon pose
columns '<link>.pose.position.{x,y,z}' and '<link>.pose.orientation.
{x,y,z,w}' for links [base, link0..link3], plus a 'Time' column.
"""
from __future__ import annotations


import numpy as np
from scipy.interpolate import CubicSpline
from scipy.spatial.transform import Rotation, Slerp

__all__ = ["LINKS", "MARKER_ARC_FRACTIONS", "position", "adj_pos",
           "guess_fix", "fix_orientations", "interpolate_posquat",
           "preprocessed"]

LINKS = ("base", "link0", "link1", "link2", "link3")
# marker positions along the rod as fractions of length (preprocess.py:45)
MARKER_ARC_FRACTIONS = (0.0, 3 / 9, 5 / 9, 7 / 9, 1.0)
BASE_MARKER_HEIGHT = 0.0635  # m above the rod anchor (preprocess.py:12)


def position(data, link: str) -> np.ndarray:
    """(3, T) positions for one link (preprocess.py:7-8)."""
    return np.array([data[f"{link}.pose.position.x"],
                     data[f"{link}.pose.position.y"],
                     data[f"{link}.pose.position.z"]])


def adj_pos(positions: np.ndarray) -> np.ndarray:
    """Base-relative positions with the base-marker height offset applied to
    all links except the anchored base (preprocess.py:10-14).
    positions: (n_links, 3)."""
    adjusted = positions.copy() - positions[0]
    adjusted[1:, 2] += BASE_MARKER_HEIGHT
    return adjusted


# a mocap frame-relabel shows up as a jump of at least one quarter turn;
# anything under this is treated as genuine motion (preprocess.py:96)
_RELABEL_JUMP_RAD = np.deg2rad(30.0)


def _nearest_signed_permutation(rotation: Rotation):
    """The signed axes-permutation matrix closest to ``rotation`` — found by
    integer-rounding its matrix — or ``None`` when the rounding is not
    orthogonal (the rotation is too far from every permutation to call)."""
    candidate = np.rint(rotation.as_matrix())
    orthogonal = np.array_equal(candidate @ candidate.T, np.eye(3))
    return Rotation.from_matrix(candidate) if orthogonal else None


def guess_fix(rotation: Rotation) -> Rotation:
    """Project a relative rotation onto the nearest signed axes permutation;
    identity-like behavior (the input itself) when no permutation is close
    enough to round to (semantics of reference preprocess.py:58-80)."""
    snapped = _nearest_signed_permutation(rotation)
    return rotation if snapped is None else snapped


def fix_orientations(data, link: str) -> Rotation:
    """Undo mocap marker-relabel flips in one link's orientation stream.

    A Vicon relabel multiplies the reported rotation by a signed axes
    permutation for some run of frames. Recovery (same semantics as
    reference preprocess.py:82-105): anchor the first frame by snapping it
    toward identity, then walk the stream comparing each RAW frame to the
    last ACCEPTED one — a jump of >= 30 degrees is attributed to a relabel
    and cancelled by right-multiplying with the permutation nearest to the
    relative rotation (when none is near, the frame collapses onto its
    predecessor, dropping the outlier).

    Input quats are mocap [x, y, z, w]; returns a stacked Rotation (one
    entry per frame — indexable/iterable like the reference's list).
    """
    raw = Rotation.from_quat(np.column_stack(
        [np.asarray(data[f"{link}.pose.orientation.{axis}"])
         for axis in ("x", "y", "z", "w")]))

    anchor_fix = _nearest_signed_permutation(raw[0].inv())
    first = raw[0] if anchor_fix is None else raw[0] * anchor_fix

    # vectorized fast path: when the anchor needed no fix and no consecutive
    # RAW pair jumps by >= 30 degrees, every frame is accepted as-is
    if len(raw) > 1:
        jumps = (raw[:-1].inv() * raw[1:]).magnitude()
        clean_stream = bool((jumps < _RELABEL_JUMP_RAD).all())
    else:
        clean_stream = True
    if clean_stream and (first.inv() * raw[0]).magnitude() == 0.0:
        return raw

    accepted = [first]
    for frame in raw[1:]:
        jump = (accepted[-1].inv() * frame).magnitude()
        if jump >= _RELABEL_JUMP_RAD:
            frame = frame * guess_fix(frame.inv() * accepted[-1])
        accepted.append(frame)
    return Rotation.concatenate(accepted)


def interpolate_posquat(adjusted_positions: np.ndarray, quaternions,
                        N: int) -> np.ndarray:
    """One time step: 5 marker poses -> (7, N) rod grid via cubic spline +
    SLERP at the marker arc fractions (interpolate_posquat_ryan,
    preprocess.py:44-55). Output quats scalar-first."""
    s = list(MARKER_ARC_FRACTIONS)
    ts = np.linspace(0, 1, N)
    pos = CubicSpline(s, adjusted_positions)(ts).T       # (3, N)
    slerp = Slerp(s, Rotation.concatenate(quaternions))
    quat = np.vstack([r.as_quat(canonical=True, scalar_first=True)
                      for r in slerp(ts)]).T              # (4, N)
    return np.concatenate([pos, quat])


def preprocessed(merged, ts: np.ndarray | None = None, N: int = 10):
    """Full preprocessing of a merged mocap table (preprocess.py:16-42).

    With ``ts``: resample positions linearly and orientations by SLERP onto
    the grid, then interpolate each step onto N nodes. Returns
    (positions (T, n_links, 3), orientations, interpolated (T, 7, N)).
    """
    positions = np.stack([position(merged, link).T for link in LINKS])
    orientations = [fix_orientations(merged, link) for link in LINKS]

    if ts is None:
        interpolated = np.stack([
            interpolate_posquat(adj_pos(positions[:, t]),
                                [o[t] for o in orientations], N)
            for t in range(positions.shape[1])])
        return positions, orientations, interpolated

    time = np.asarray(merged["Time"])
    s_positions = np.stack([
        np.stack([np.interp(ts, time, q) for q in p.T]).T
        for p in positions])
    s_orientations = [Slerp(time, r)(ts) for r in orientations]
    interpolated = np.stack([
        interpolate_posquat(adj_pos(s_positions[:, t]),
                            [o[t] for o in s_orientations], N)
        for t in range(len(ts))])
    f_positions = np.array([adj_pos(s_positions[:, t])
                            for t in range(len(ts))])
    return f_positions, s_orientations, interpolated
