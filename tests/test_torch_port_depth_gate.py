"""The depth gate's pass rule and its references
(geoformer_tpu_torch/eval/depth_gate.py).

gate() holds each pose AUC within GATE_TOL of the port's CPU sweep
(CPU_REF) on both sides, prec@5e-04 at least PREC_MIN and 512 matches a
pair. JAX_RECORD is the last line of the trained checkpoint's
metrics.jsonl, and the recipe's model is the JAX `train-depth` one.
"""

import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from geoformer_tpu_torch.eval import depth_gate as dg  # noqa: E402

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
    assert dg.CKPT.is_file()


def test_recipe_config():
    cfg = dg.recipe_config()
    assert (cfg.match.max_matches, cfg.match.force_one_match) == (512, True)
    assert (cfg.geo.ransac_iters, cfg.geo.max_inliers) == (256, 512)
    assert cfg.geo.use_pallas
    assert (dg.IMSIZE, dg.DEPTH_PAD, dg.BATCHES, dg.BATCH, dg.VAL_SEED) == (
        640, 640, 8, 4, 67)
