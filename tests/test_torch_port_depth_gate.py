"""The depth gate's pass rule and its references
(geoformer_tpu_torch/eval/depth_gate.py).

gate() holds each pose AUC within GATE_TOL of the port's CPU sweep
(CPU_REF, or CPU_REF_HOST for the host pose backend) on both sides,
prec@5e-04 at least PREC_MIN, 512 matches a pair and, on the host
backend, at most CPU_HOST_FAILED pairs without a pose. JAX_RECORD is the
last line of the trained checkpoint's metrics.jsonl, and the recipe's
model is the JAX `train-depth` one. host_fields summarizes the host
estimator's ms, iterations and failures that a host-backend
run_depth_validation records.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from geoformer_tpu_torch.eval import depth_gate as dg  # noqa: E402
from torch_port_util import one_torch_thread  # noqa: E402,F401

REPO = Path(__file__).resolve().parent.parent
A5, A10, A20 = (dg.CPU_REF[k] for k in dg.AUCS)


def _record(**change):
    rec = {**dg.CPU_REF, "prec@5e-04": 1.0, "val_num_matches": 512.0}
    rec.update(change)
    return rec


@pytest.mark.parametrize("change, passes", [
    ({}, True),
    ({"auc@5": A5 + 0.049, "auc@10": A10 - 0.049}, True),
    ({"auc@5": A5 - 0.051}, False),
    ({"auc@10": A10 + 0.051}, False),
    ({"auc@20": A20 - 0.051}, False),
    ({"prec@5e-04": 0.98}, False),
    ({"val_num_matches": 511.75}, False),
    ({k: dg.JAX_RECORD[k] for k in dg.AUCS}, False),
], ids=["reference", "inside-both-sides", "auc5-below", "auc10-above",
        "auc20-below", "prec", "matches", "jax-record-aucs"])
def test_gate_rule(change, passes):
    assert dg.gate(_record(**change)) is passes


H5, H10, H20 = (dg.CPU_REF_HOST[k] for k in dg.AUCS)


@pytest.mark.parametrize("change, passes", [
    ({}, True),
    ({"auc@5": H5 - 0.049, "auc@20": H20 + 0.049}, True),
    ({"auc@10": H10 + 0.051}, False),
    ({"auc@20": H20 - 0.051}, False),
    ({"failed_pairs": dg.CPU_HOST_FAILED + 1}, False),
    ({"prec@5e-04": 0.98}, False),
], ids=["reference", "inside", "auc10-above", "auc20-below",
        "failed-pairs", "prec"])
def test_host_gate_rule(change, passes):
    rec = {**dg.CPU_REF_HOST, "prec@5e-04": 1.0, "val_num_matches": 512.0,
           "failed_pairs": dg.CPU_HOST_FAILED}
    rec.update(change)
    assert dg.gate(rec, "host") is passes


def test_host_pose_stats():
    from geoformer_tpu_torch.eval.synthetic import pose_sets
    from geoformer_tpu_torch.train.depth_loop import run_depth_validation

    (uv0, uv1, K, T), = pose_sets(0)[:1]
    mk0 = torch.zeros(2, 300, 2)
    mk1 = torch.zeros(2, 300, 2)
    valid = torch.zeros(2, 300, dtype=torch.bool)
    mk0[0], mk1[0], valid[0] = (torch.from_numpy(uv0), torch.from_numpy(uv1),
                                True)
    valid[1, :4] = True               # four matches: no RANSAC, no pose
    pd = {"mkpts0": mk0, "mkpts1": mk1, "valid": valid,
          "epi_errs": torch.zeros(2, 300)}
    batch = {"image0": torch.zeros(1),
             "K0": torch.from_numpy(np.stack([K, K])),
             "K1": torch.from_numpy(np.stack([K, K])),
             "T_0to1": torch.from_numpy(np.stack([T, T]))}
    stats = {}
    run_depth_validation(
        lambda state, batch, generator=None: ({"val_loss": torch.zeros(())},
                                              pd),
        None, [batch], pose_backend="host", pose_stats=stats)
    assert len(stats["ms"]) == 2 and stats["iters"] == [1]
    assert stats["failed"] == 1
    fields = dg.host_fields(stats)
    assert fields["failed_pairs"] == 1
    assert fields["ransac_iters_per_pair"] == 1.0
    assert fields["host_ms_per_pair"] > 0.0


def test_gate_references():
    last = json.loads((REPO / "checkpoints" / "tpu_r5_depth2"
                       / "metrics.jsonl").read_text().splitlines()[-1])
    assert last["step"] == 2500
    for k in (*dg.AUCS, "prec@5e-04"):
        assert dg.JAX_RECORD[k] == last[k]
    # the bar's lower edge on the CPU sweep sits above the record less
    # GATE_TOL, so no AUC passes more than GATE_TOL below the record
    for k in dg.AUCS:
        assert dg.CPU_REF[k] > dg.JAX_RECORD[k]
        assert 0.0 < dg.CPU_REF_HOST[k] <= 1.0
    assert 0 <= dg.CPU_HOST_FAILED < dg.BATCHES * dg.BATCH
    assert dg.CKPT.is_file()


def test_recipe_config():
    cfg = dg.recipe_config()
    assert (cfg.match.max_matches, cfg.match.force_one_match) == (512, True)
    assert (cfg.geo.ransac_iters, cfg.geo.max_inliers) == (256, 512)
    assert cfg.geo.use_pallas
    assert (dg.IMSIZE, dg.DEPTH_PAD, dg.BATCHES, dg.BATCH, dg.VAL_SEED) == (
        640, 640, 8, 4, 67)
