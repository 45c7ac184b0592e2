"""Serving bundles: the matcher as one exported program (torch.export).

Counterpart of geoformer_tpu/serving/export.py. ``export_matcher`` traces
the whole forward (backbone -> coarse transformer -> GAM -> fine matching)
once, at a fixed (batch, H, W), into a ``torch.export.ExportedProgram``
whose weights are part of it; ``save_bundle`` writes

    manifest.json   shapes, platform, config summary (the JAX manifest's
                    fields)
    model.pt2       the program, torch.export.save

into one zip, and ``load_bundle`` runs it in a process that imports torch,
numpy and the kernels' op registrations (ops/gam_kernels.py,
ops/streaming_match.py), and no model code.

The GAM kernels are ``torch.ops.geoformer`` custom ops, so the program
holds one call per kernel: exported and run on ``cuda`` they launch the
CUDA kernels (K1, K2), on ``cpu`` their plain versions. Exported on
``cuda``, the streamed coarse matchings are K6's two ops each; on ``cpu``
the matcher's chunked loop is traced as plain ops. The JAX bundle
draws RANSAC's samples from ``jax.random.key(0)`` on every call; the
port's bakes in one noise tensor for the Gumbel draw, made once at export
from ``torch.Generator().manual_seed(0)`` (``ransac_noise``), so the same
images give the same matches on every call and in every process. An int8
model (``--int8`` / ``--int8-full``) exports the same way: its
quantization is part of the program (``aten._int_mm`` nodes), and the
weights stay the float ones.
"""

from __future__ import annotations

import dataclasses
import io
import json
import zipfile
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn

import geoformer_tpu_torch.ops.gam_kernels  # noqa: F401  (registers the ops)
import geoformer_tpu_torch.ops.streaming_match  # noqa: F401  (K6's ops)

BUNDLE_VERSION = 1
OUTPUTS = ("mkpts0", "mkpts1", "mconf", "valid")


def ransac_noise(cfg, batch: int) -> torch.Tensor:
    """[batch, ransac_iters, max_matches] uniforms of the bundle's RANSAC
    draw, from torch.Generator().manual_seed(0) on the CPU."""
    gen = torch.Generator().manual_seed(0)
    return torch.rand((batch, cfg.geo.ransac_iters, cfg.match.max_matches),
                      generator=gen)


class _ServingForward(nn.Module):
    """The serving forward: a plain dict out (OUTPUTS), the fixed RANSAC
    noise. It is traced and run without autograd (the model's own no_grad
    blocks, models/layers.no_grad, then enter no grad mode at all)."""

    def __init__(self, model: nn.Module, noise: torch.Tensor):
        super().__init__()
        self.model = model
        self.register_buffer("ransac_noise", noise)

    def forward(self, image0, image1, mask0, mask1):
        out = self.model(image0, image1, mask0, mask1,
                         ransac_noise=self.ransac_noise)
        fine = out.fine
        return {"mkpts0": fine.mkpts0, "mkpts1": fine.mkpts1,
                "mconf": fine.mconf, "valid": fine.valid}


def export_matcher(cfg, model: nn.Module, *, hw: Tuple[int, int],
                   batch: int = 1, device="cuda"):
    """Trace ``model`` (a GeoFormer of ``cfg``, weights loaded) into a
    ``torch.export.ExportedProgram`` at fixed shapes on ``device``.

    Its inputs: image0, image1 [batch, H, W, 1] float32 in [0, 1]; mask0,
    mask1 [batch, H / s, W / s] float32 (s the coarse stride). Its output:
    {"mkpts0", "mkpts1" [batch, max_matches, 2], "mconf" [batch,
    max_matches], "valid" [batch, max_matches] bool}. Raises ValueError
    when the stride does not divide hw."""
    h, w = hw
    s = cfg.coarse_scale
    if h % s or w % s:
        raise ValueError(f"hw {hw} not divisible by coarse stride {s}")
    device = torch.device(device)
    model = model.to(device).eval()
    fwd = _ServingForward(model, ransac_noise(cfg, batch).to(device))
    # four distinct tensors: the tracer would bind one tensor passed twice
    # to one input of the program
    args = tuple(torch.full(shape, fill, dtype=torch.float32, device=device)
                 for shape, fill in (((batch, h, w, 1), 0.0),) * 2
                 + (((batch, h // s, w // s), 1.0),) * 2)
    with torch.no_grad():
        return torch.export.export(fwd, args, strict=False)


def save_bundle(path: str, cfg, model: nn.Module, *, hw: Tuple[int, int],
                batch: int = 1, device="cuda") -> None:
    """Export and write the self-contained serving zip at ``path``."""
    program = export_matcher(cfg, model, hw=hw, batch=batch, device=device)
    manifest = {
        "bundle_version": BUNDLE_VERSION,
        "batch": batch,
        "hw": list(hw),
        "coarse_scale": cfg.coarse_scale,
        "platforms": [torch.device(device).type],
        "max_matches": cfg.match.max_matches,
        "config": dataclasses.asdict(cfg),
    }
    buf = io.BytesIO()
    torch.export.save(program, buf)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("manifest.json", json.dumps(manifest, indent=1,
                                               default=str))
        z.writestr("model.pt2", buf.getvalue())


class ServingMatcher:
    """A loaded bundle: callable, model-code-free.

    __call__(image0, image1[, mask0, mask1]) with [B, H, W, 1] float32
    images in [0, 1] (B, H, W fixed by the bundle; numpy arrays or
    tensors) returns numpy {"mkpts0", "mkpts1", "mconf", "valid"}; filter
    keypoints by "valid"."""

    def __init__(self, program, manifest: dict):
        self.program = program
        self._fn = program.module()
        self.manifest = manifest
        self.batch = int(manifest["batch"])
        self.hw = tuple(manifest["hw"])
        self.device = torch.device(manifest["platforms"][0])
        self._scale = int(manifest["coarse_scale"])

    def _input(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32)
                               if not torch.is_tensor(x) else x,
                               dtype=torch.float32, device=self.device)

    def __call__(self, image0, image1, mask0=None, mask1=None):
        b, (h, w), s = self.batch, self.hw, self._scale
        ones = np.ones((b, h // s, w // s), np.float32)
        args = [self._input(x) for x in (
            image0, image1, ones if mask0 is None else mask0,
            ones if mask1 is None else mask1)]
        with torch.no_grad():
            out = self._fn(*args)
        return {k: out[k].detach().float().cpu().numpy() if k != "valid"
                else out[k].cpu().numpy() for k in OUTPUTS}


def load_bundle(path: str) -> ServingMatcher:
    """Load a bundle written by save_bundle, onto the device it was
    exported on."""
    with zipfile.ZipFile(path) as z:
        manifest = json.loads(z.read("manifest.json"))
        if manifest["bundle_version"] > BUNDLE_VERSION:
            raise ValueError(f"bundle version {manifest['bundle_version']} "
                             f"is newer than this loader ({BUNDLE_VERSION})")
        program = torch.export.load(io.BytesIO(z.read("model.pt2")))
    return ServingMatcher(program, manifest)
