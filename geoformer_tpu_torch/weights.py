"""Weights of the port: JAX parameters in, random initialization.

``load_jax_params`` takes the JAX model's variables as a flat
``{"params/a/b/kernel": np.ndarray, "batch_stats/a/b/mean": ...}`` dict --
the layout of the ``.npz`` files written by geoformer_tpu's save_params
(flattened pytree, '/'-joined keys) -- and loads them into a port module
whose submodules carry the JAX names:

    conv kernel [kh, kw, in, out] (HWIO) -> weight [out, in, kh, kw] (OIHW)
    dense kernel [in, out]               -> weight [out, in]
    bias                                 -> bias
    bin_score (the sinkhorn matcher's)   -> bin_score
    BatchNorm / LayerNorm scale          -> weight
    batch_stats mean / var               -> running_mean / running_var

Every JAX entry must land on a port tensor of the same size and every port
tensor must be given one, or it raises. Needs numpy only.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from geoformer_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    Dense,
    lecun_normal_,
)

_SKIP = ("step",)  # metadata stamped by save_params


def load_npz(path: str) -> Dict[str, np.ndarray]:
    """Flat dict of a JAX ``.npz`` checkpoint (data only, no pickle)."""
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def jax_to_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Map flat JAX variables to port state-dict names and layouts."""
    out = {}
    for key, value in flat.items():
        if key in _SKIP:
            continue
        collection, *path, leaf = key.split("/")
        name = ".".join(path)
        arr = np.asarray(value, dtype=np.float32)
        if collection == "params":
            if leaf == "kernel" and arr.ndim == 4:
                out[f"{name}.weight"] = arr.transpose(3, 2, 0, 1)
            elif leaf == "kernel" and arr.ndim == 2:
                out[f"{name}.weight"] = arr.T
            elif leaf == "scale":
                out[f"{name}.weight"] = arr
            elif leaf == "bias":
                out[f"{name}.bias"] = arr
            elif leaf == "bin_score" and not path:
                out["bin_score"] = arr
            else:
                raise KeyError(f"unknown parameter {key} {arr.shape}")
        elif collection == "batch_stats":
            stat = {"mean": "running_mean", "var": "running_var"}.get(leaf)
            if stat is None:
                raise KeyError(f"unknown batch statistic {key}")
            out[f"{name}.{stat}"] = arr
        else:
            raise KeyError(f"unknown collection in {key}")
    return {k: torch.from_numpy(np.array(v, order="C"))
            for k, v in out.items()}


def load_jax_params(model: nn.Module,
                    flat: Mapping[str, np.ndarray]) -> nn.Module:
    """Load flat JAX variables into ``model`` in place; strict both ways."""
    sd = jax_to_state_dict(flat)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    if missing or unexpected:
        raise KeyError(f"weights do not fit the model: missing {missing[:8]} "
                       f"unexpected {unexpected[:8]}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: JAX {tuple(v.shape)} vs port "
                             f"{tuple(own[k].shape)}")
    model.load_state_dict(sd, strict=True)
    return model


def random_init(model: nn.Module, seed: int = 0) -> nn.Module:
    """Initialize every parameter from one torch.Generator: dense and conv
    kernels lecun-normal (the flax default), biases 0, norms scale 1 and
    bias 0, BatchNorm statistics mean 0 and var 1."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Dense):
                lecun_normal_(mod.weight, mod.weight.shape[1], gen)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, Conv):
                w = mod.weight
                lecun_normal_(w, w.shape[1] * w.shape[2] * w.shape[3], gen)
            elif isinstance(mod, (BatchNorm, nn.LayerNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                if isinstance(mod, BatchNorm):
                    mod.running_mean.zero_()
                    mod.running_var.fill_(1.0)
    return model
