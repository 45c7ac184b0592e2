"""The engine layer: Lie maps, PnP, the SL(3) homography graph and planar
SLAM (counterpart of geoformer_tpu/engine/). Bundle adjustment, SfM, the
SE(3) pose graph and trajectory alignment are not ported yet (ROADMAP)."""

from geoformer_tpu_torch.engine.lie import se3_exp, se3_log  # noqa: F401
