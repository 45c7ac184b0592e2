"""The engine layer (counterpart of geoformer_tpu/engine/): Lie maps, PnP,
the SL(3) homography graph and planar SLAM, bundle adjustment (dense,
CG and the two sharded solvers), SfM glue, the SE(3) pose graph and
trajectory alignment."""

from geoformer_tpu_torch.engine.ba import ba_solve  # noqa: F401
from geoformer_tpu_torch.engine.lie import se3_exp, se3_log  # noqa: F401
from geoformer_tpu_torch.engine.trajectory import (  # noqa: F401
    align_umeyama,
    ate_rmse,
)
