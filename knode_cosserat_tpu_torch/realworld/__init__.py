"""The real-world pipeline: experiment recordings (.bag or per-topic CSVs)
-> rod-grid poses -> full-state estimates -> KNODE training data.

PyTorch-port copy of ``knode_cosserat_tpu/realworld``, with the same names.
Host-side numpy / scipy; pandas is needed only to ingest recordings
(``read_bag``, ``read_topic_csvs``) and is imported there.
"""
from .curve import fit_curve, compute_tangents, interpolate_quaternions
from .estimate import (estimate_state, compute_v_u, angular_velocities,
                       internal_forces_moments)
from .preprocess import (preprocessed, fix_orientations, guess_fix,
                         interpolate_posquat, adj_pos, position, LINKS,
                         MARKER_ARC_FRACTIONS)
from .bag import (read_bag, read_topic_csvs, interpolate_zoh,
                  merge_pose_topics, extract_tensions, grams_to_newtons)
