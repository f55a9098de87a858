"""ATE RMSE (mm) over every execution's first `ate_frames` poses, each
execution similarity-aligned to its rendered ground truth
(reference/trajectory.py, a copy of utils/metrics.py `ate_rmse`), the
squared errors of all executions pooled."""

import numpy as np


def read(run):
    sq = run.ate_sq
    if sq is None or not np.isfinite(sq).all():
        return None
    return float(np.sqrt(sq.mean())) * 1e3
