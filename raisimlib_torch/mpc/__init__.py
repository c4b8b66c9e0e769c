from raisimlib_torch.mpc.ilqr import ILQRConfig, ILQRSolution, ilqr  # noqa: F401
from raisimlib_torch.mpc.smooth import actuated_indices, make_smooth_dyn  # noqa: F401
