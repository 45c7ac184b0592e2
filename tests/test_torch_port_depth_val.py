"""The port's depth validation step against the JAX make_depth_val_step,
on the trained depth checkpoint.

checkpoints/tpu_r5_depth2/params_final.npz (the JAX record's depth model)
loads into both packages; both run the val step of the train-depth recipe
(max_matches 512, force_one_match, 256 RANSAC hypotheses, 512 inliers,
kernels on) on the same padded posed-RGBD batch
(tests/torch_port_util.depth_batch): 128x128 images with 96 rows of
content (the masks zero the last four coarse rows), scale0/scale1 1.25,
depths of a rendered room padded to 200x200. The GAM's RANSAC draws are
JAX's, injected. The JAX step is compiled once.

The images are the two views' renders, resized to the content as the
reader resizes them. The GAM floors warped cells, so a fitted homography
that puts a cell centre on a cell border to the last bit can move a window
in one package and not the other; the fixture asserts that none lies
within 1e-4 cells of a border (of the batch seeds 0-3, only seed 1 keeps
them all clear, by 1.6e-4; on a pure shift of the image the trained model
fits an exact one-cell translation and every cell lies on a border).

The port's depth warp follows the published warp_kpts where the JAX
package departs from it (a keypoint off the map, a warp onto a zero depth:
both invalid), so the JAX step runs with those two rules too
(torch_port_util.published_warp).

Bars: the val scalars within 1e-4 relative; the match validity equal; the
valid matches' keypoints at original resolution within 1e-3 px and their
confidences within 1e-4; their squared symmetric epipolar errors within
1e-6 (absolute, normalized units).
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from geoformer_tpu import config as jcfg  # noqa: E402
from geoformer_tpu.train.checkpoint import load_variables  # noqa: E402
from geoformer_tpu.train.trainer import TrainState as JTrainState  # noqa: E402
from geoformer_tpu.train.trainer import (  # noqa: E402
    make_depth_val_step as j_make_depth_val_step,
)
from geoformer_tpu.models import GeoFormer as JGeoFormer  # noqa: E402
from geoformer_tpu_torch import config as tcfg  # noqa: E402
from geoformer_tpu_torch import weights  # noqa: E402
from geoformer_tpu_torch.models import GeoFormer  # noqa: E402
from geoformer_tpu_torch.train.optim import make_optimizer  # noqa: E402
from geoformer_tpu_torch.train.trainer import (  # noqa: E402
    TrainState,
    make_depth_val_step,
)
from geoformer_tpu.geometry import depth as jdepth  # noqa: E402
from geoformer_tpu.train import supervision as jsupervision  # noqa: E402
from torch_port_util import (  # noqa: E402
    depth_batch,
    jax_forward_and_draws,
    n,
    port_config,
    published_warp,
    t,
)
from torch_port_util import one_torch_thread  # noqa: E402,F401

CKPT = Path(__file__).resolve().parent.parent / "checkpoints" / \
    "tpu_r5_depth2" / "params_final.npz"
B, HW, ROWS = 2, (128, 128), 96
SEED = 1                  # the batch (see the module docstring)
BORDER_MARGIN = 1e-4      # cells

pytestmark = pytest.mark.skipif(not CKPT.is_file(),
                                reason=f"{CKPT} is not in the checkout")


def _config():
    """The train-depth recipe's model (geoformer_tpu/cli.py:113-119)."""
    return jcfg.GeoFormerConfig(
        match=jcfg.MatchConfig(max_matches=512, force_one_match=True),
        geo=jcfg.GeoModuleConfig(ransac_iters=256, max_inliers=512,
                                 use_pallas=True))


@pytest.fixture(scope="module")
def run():
    cfg = _config()
    variables = load_variables(str(CKPT))
    batch = depth_batch(SEED, B, HW, rows=ROWS, pad=200, rendered=True)
    tc = jcfg.TrainConfig(batch_size=B, image_hw=HW)
    key = jax.random.key(5)
    state = JTrainState(variables["params"], variables["batch_stats"], None,
                        jnp.zeros((), jnp.int32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsupervision, "warp_kpts_depth",
                   published_warp(jdepth.warp_kpts_depth))
        scalars, pd = jax.jit(j_make_depth_val_step(JGeoFormer(cfg), tc))(
            state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    out, sample_idx = jax_forward_and_draws(
        cfg, variables, batch["image0"], batch["image1"], key,
        batch["mask0"], batch["mask1"])

    model = weights.load_jax_params(GeoFormer(port_config(cfg)),
                                    weights.load_npz(str(CKPT)))
    pstate = TrainState(model, make_optimizer(tcfg.OptimConfig(),
                                              model.parameters()))
    got_s, got_pd = make_depth_val_step(tcfg.TrainConfig(
        batch_size=B, image_hw=HW))(
            pstate, {k: t(v) for k, v in batch.items()},
            sample_idx=t(sample_idx))
    return dict(fitted_H=np.asarray(out.geo.H),
                has_H=np.asarray(out.geo.has_H),
                ref_s={k: float(v) for k, v in scalars.items()},
                ref_pd={k: np.asarray(v) for k, v in pd.items()},
                got_s={k: float(v) for k, v in got_s.items()},
                got_pd={k: n(v) for k, v in got_pd.items()})


def test_the_gam_windows_are_clear_of_cell_borders(run):
    assert run["has_H"].all()
    grid = np.stack(np.meshgrid(np.arange(HW[1] // 8),
                                np.arange(HW[0] // 8)), -1).reshape(-1, 2)
    pts = np.concatenate([grid * 8.0, np.ones((len(grid), 1))], 1)
    for Hm in (run["fitted_H"], np.linalg.inv(run["fitted_H"])):
        w = pts @ Hm.transpose(0, 2, 1)
        cells = w[..., :2] / w[..., 2:] / 8
        assert np.abs(cells - np.round(cells)).min() > BORDER_MARGIN


def test_val_scalars_match_jax(run):
    ref, got = run["ref_s"], run["got_s"]
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)
    # the trained model matches the pair
    assert ref["val_num_matches"] > 20


def test_val_matches_and_epipolar_errors_match_jax(run):
    ref, got = run["ref_pd"], run["got_pd"]
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    v = ref["valid"]
    for k, atol in (("mkpts0", 1e-3), ("mkpts1", 1e-3), ("mconf", 1e-4),
                    ("epi_errs", 1e-6)):
        np.testing.assert_allclose(got[k][v], ref[k][v], atol=atol,
                                   err_msg=k)
    # keypoints at original resolution: inside the 120x160 content
    assert (ref["mkpts0"][v] <= np.array([160, 120])).all()
