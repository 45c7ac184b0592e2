"""The serving bundle (geoformer_tpu_torch/serving), the GAM kernels as
custom ops, and the fixed RANSAC noise that the bundle bakes in.

A small model (tests/torch_port_util.small_config with the GAM kernels on,
random weights from a seed) is exported on the CPU at 120x160, B=2,
saved, and run in a fresh process that imports torch, numpy and the op
registrations only. Tolerances: the served outputs equal the eager
forward's with the same noise exactly (the same ops in the same order on
the same CPU). The manifest has the JAX bundle's keys: JAX's own
save_bundle writes one here, with its export stubbed out (the JAX export
recompiles the model, which the JAX package's own serving test runs as a
slow test). The ops are checked by torch.library.opcheck (schema, fake
tensors, autograd registration) on small CPU inputs.
"""

import json
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from geoformer_tpu import config as jcfg  # noqa: E402
from geoformer_tpu_torch import cli, weights  # noqa: E402
from geoformer_tpu_torch.geometry import ransac  # noqa: E402
from geoformer_tpu_torch.models import GeoFormer  # noqa: E402
from geoformer_tpu_torch.ops import gam_kernels as gk  # noqa: E402
from geoformer_tpu_torch.serving import export as serving  # noqa: E402
from torch_port_util import port_config, small_config  # noqa: E402
from torch_port_util import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent
HW, B = (120, 160), 2

_LOAD = """
import json, sys
import numpy as np
from geoformer_tpu_torch.serving import load_bundle
m = load_bundle(sys.argv[1])
x = np.load(sys.argv[2])
out = m(x["image0"], x["image1"])
np.savez(sys.argv[3], **out)
print(json.dumps({"batch": m.batch, "hw": list(m.hw),
                  "modules": sorted(k for k in sys.modules
                                    if k.startswith("geoformer_tpu"))}))
"""


def _config():
    return port_config(small_config(geo=jcfg.GeoModuleConfig(
        nhead=2, ransac_iters=32, max_inliers=64, use_pallas=True)))


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    d = tmp_path_factory.mktemp("bundle")
    cfg = _config()
    model = weights.random_init(GeoFormer(cfg), seed=0).eval()
    path = d / "matcher.gfmz"
    serving.save_bundle(str(path), cfg, model, hw=HW, batch=B, device="cpu")
    rng = np.random.default_rng(0)
    i0 = rng.random((B, *HW, 1)).astype(np.float32)
    np.savez(d / "in.npz", image0=i0, image1=np.roll(i0, 8, axis=2))
    r = subprocess.run([sys.executable, "-c", _LOAD, str(path),
                        str(d / "in.npz"), str(d / "out.npz")], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return (cfg, model, path, dict(np.load(d / "in.npz")),
            dict(np.load(d / "out.npz")), json.loads(r.stdout.splitlines()[-1]))


def test_the_served_matches_equal_the_eager_forward(bundle):
    cfg, model, _, x, got, info = bundle
    m = torch.ones((B, HW[0] // 8, HW[1] // 8))
    with torch.no_grad():
        ref = model(torch.from_numpy(x["image0"]),
                    torch.from_numpy(x["image1"]), m, m.clone(),
                    ransac_noise=serving.ransac_noise(cfg, B)).fine
    assert got["valid"].sum() > 20
    for k in serving.OUTPUTS:
        np.testing.assert_array_equal(got[k], getattr(ref, k).numpy(),
                                      err_msg=k)
    assert info["batch"] == B and info["hw"] == list(HW)


def test_the_bundle_process_imports_no_model_code(bundle):
    modules = bundle[-1]["modules"]
    assert "geoformer_tpu_torch.serving.export" in modules
    assert "geoformer_tpu_torch.ops.gam_kernels" in modules
    assert not [m for m in modules if m.startswith(
        ("geoformer_tpu_torch.models", "geoformer_tpu."))], modules


def test_the_program_calls_the_kernels_as_ops(bundle):
    path = bundle[2]
    served = serving.load_bundle(str(path))
    code = served.program.graph_module.code
    assert code.count("geoformer.box_window_attention_fwd") == 4
    assert code.count("geoformer.masked_kv_attention_fwd") == 4
    assert served.device == torch.device("cpu")


def test_the_manifest_has_the_jax_bundle_keys(bundle, tmp_path,
                                              monkeypatch):
    from geoformer_tpu.serving import export as j_export

    class Exported:
        platforms = ("cpu",)

        @staticmethod
        def serialize():
            return b""

    monkeypatch.setattr(j_export, "export_matcher",
                        lambda *a, **kw: Exported())
    jpath = tmp_path / "jax.gfmz"
    j_export.save_bundle(str(jpath), small_config(), {"params": {}},
                         hw=HW, batch=B)
    with zipfile.ZipFile(jpath) as z:
        ref = json.loads(z.read("manifest.json"))
    with zipfile.ZipFile(bundle[2]) as z:
        got = json.loads(z.read("manifest.json"))
        assert sorted(z.namelist()) == ["manifest.json", "model.pt2"]
    assert list(got) == list(ref)
    assert got["platforms"] == ["cpu"] and got["batch"] == B
    assert got["hw"] == list(HW) and got["max_matches"] == 64
    assert got["config"].keys() == ref["config"].keys()
    for k, v in ref["config"].items():
        if isinstance(v, dict):
            assert got["config"][k].keys() == v.keys(), k


@pytest.mark.parametrize("hw", [(100, 160), (120, 150)])
def test_an_hw_off_the_coarse_stride_raises(hw):
    cfg = _config()
    with pytest.raises(ValueError, match="not divisible"):
        serving.export_matcher(cfg, GeoFormer(cfg), hw=hw, device="cpu")


@pytest.mark.parametrize("platforms", ["tpu", "cuda,cpu", "cpu,tpu"])
def test_cli_export_takes_one_port_device(platforms, tmp_path):
    with pytest.raises(ValueError, match="one of cuda or cpu"):
        cli.main(["export", "--out", str(tmp_path / "b.gfmz"),
                  "--platforms", platforms])


def test_cli_export_writes_a_bundle(tmp_path, capsys):
    out = tmp_path / "b.gfmz"
    cli.main(["export", "--out", str(out), "--height", "64", "--width",
              "80", "--platforms", "cpu", "--pallas", "--max-matches", "32",
              "--gam-ransac-iters", "16", "--gam-max-inliers", "32"])
    assert capsys.readouterr().out.strip() == \
        f"serving bundle (1x64x80, platforms=['cpu']) -> {out}"
    served = serving.load_bundle(str(out))
    got = served(np.zeros((1, 64, 80, 1), np.float32),
                 np.zeros((1, 64, 80, 1), np.float32))
    assert got["mkpts0"].shape == (1, 32, 2) and got["valid"].dtype == bool
    assert served.manifest["config"]["geo"]["use_pallas"] is True


# ------------------------------------------------------ the RANSAC noise --

def test_fixed_noise_draws_what_the_generator_draws():
    valid = torch.rand((3, 50), generator=torch.Generator().manual_seed(1)) \
        > 0.3
    a = ransac.gumbel_sample_idx(valid, 16,
                                 torch.Generator().manual_seed(5))
    u = torch.rand((3, 16, 50), generator=torch.Generator().manual_seed(5))
    b = ransac.gumbel_sample_idx(valid, 16, noise=u)
    assert torch.equal(a, b)
    assert valid.gather(1, b.reshape(3, -1)).all()
    with pytest.raises(ValueError, match="RANSAC noise"):
        ransac.gumbel_sample_idx(valid, 16, noise=u[:, :8])


def test_the_bundle_noise_is_seeded_and_shaped():
    cfg = _config()
    a, b = serving.ransac_noise(cfg, 2), serving.ransac_noise(cfg, 2)
    assert a.shape == (2, 32, 64) and torch.equal(a, b)
    assert 0 <= a.min() and a.max() < 1


# ------------------------------------------------------- the custom ops --

def _box_args(seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((2, 12, 2, 8), generator=g, dtype=dtype)
               for _ in range(3))
    centers = torch.randint(-1, 5, (2, 12, 2), generator=g,
                            dtype=torch.int32)
    return q, k, v, centers, [3, 4]


def _op_args(name):
    q, k, v, centers, grid = _box_args()
    lse = torch.randn(q.shape[:3])
    delta = torch.randn(q.shape[:3])
    mask = torch.rand((2, 12), generator=torch.Generator().manual_seed(1)) \
        > 0.4
    out, stats = gk.masked_kv_attention_fwd(q, k, v, mask,
                                            return_stats=True)
    return {
        "box_window_attention_fwd": (q, k, v, centers, grid, 2, -1e8),
        "box_window_attention_bwd_dq": (q, k, v, centers, lse, delta, q,
                                        grid, 2),
        "box_window_attention_bwd_dkv": (q, k, v, centers, lse, delta, q,
                                         grid, 2),
        "masked_kv_attention_fwd": (q, k, v, mask, -1e8, True),
        "masked_kv_attention_bwd": (q, k, v, mask, q, -1e8, out, stats),
    }[name]


@pytest.mark.parametrize("name", gk.OPS)
def test_each_op_passes_opcheck(name):
    args = list(_op_args(name))
    if name.endswith("_fwd"):
        for i in range(3):
            args[i] = args[i].clone().requires_grad_()
    torch.library.opcheck(getattr(torch.ops.geoformer, name), tuple(args),
                          test_utils=("test_schema",
                                      "test_autograd_registration",
                                      "test_faketensor"))


@pytest.mark.parametrize("name", gk.OPS)
def test_each_op_gives_its_shapes_on_meta(name):
    args = _op_args(name)
    meta = tuple(a.to("meta") if torch.is_tensor(a) else a for a in args)
    got = getattr(torch.ops.geoformer, name)(*meta)
    ref = getattr(torch.ops.geoformer, name)(*args)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert [(t.shape, t.dtype) for t in got] == \
        [(t.shape, t.dtype) for t in ref]
    assert all(t.device.type == "meta" for t in got)
