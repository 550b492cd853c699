from .metrics import dtw, fastdtw, pct_error, pose_mse, tip_dtw, traj_mse
from ..ops.dtw import batch_dtw_device, dtw_device, tip_dtw_device
from .tables import (EvalRecord, aggregate_seeds, evaluate_cells,
                     format_table, make_eval_data)
