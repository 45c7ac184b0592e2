"""Released torch checkpoints in and out of the port.

Counterpart of geoformer_tpu/utils/torch_convert.py. The reference
GeoFormer's state dict (its module tree, model/full_model.py; keys
optionally ``matcher.``-prefixed by its Lightning wrapper) maps onto the
port's ``GeoFormer`` state dict and back. The port keeps torch's layouts
(conv [O, I, kh, kw], linear [O, I], BatchNorm weight/bias and running
statistics, LayerNorm weight/bias), so a tensor passes unchanged and only
its name moves; the JAX converter's transposes to flax layouts and the port
loader's transposes back cancel, and both routes give the same values.
Both ResNet-FPN ladders are covered: the released model's (8, 2) and the
(16, 4) one (a fourth stage, recognised by its ``backbone.layer4`` keys;
the FPN then runs from 1/16 down to 1/4).

    convert_state_dict(load_torch_checkpoint("geoformer.ckpt"))
        -> {"backbone.conv1.weight": ..., ...}   (model.load_state_dict)
    to_torch_state_dict(model)
        -> {"matcher.backbone.conv1.weight": ..., ...}
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

_PREFIX = "matcher."
# (leaf, required) of each kind of module: conv and linear biases are
# copied where present
_LEAVES = {
    "conv": (("weight", True), ("bias", False)),
    "linear": (("weight", True), ("bias", False)),
    "bn": tuple((n, True) for n in ("weight", "bias", "running_mean",
                                     "running_var")),
    "ln": (("weight", True), ("bias", True)),
}


def _modules(has_down, n_coarse: int, n_geo: int, n_fine: int,
             stages: int = 3) -> List[Tuple[str, str, str]]:
    """(reference module, port module, kind) of every converted module, in
    the JAX converter's order; ``has_down(li, bi)`` says whether residual
    block (li, bi) has a downsample branch; ``stages`` is 3 on the (8, 2)
    ladder, 4 on the (16, 4) one."""
    mods = [("backbone.conv1", "backbone.conv1", "conv"),
            ("backbone.bn1", "backbone.bn1", "bn")]
    for li in range(1, stages + 1):
        for bi in (0, 1):
            t, p = f"backbone.layer{li}.{bi}", f"backbone.layer{li}_{bi}"
            mods += [(f"{t}.conv1", f"{p}.conv1", "conv"),
                     (f"{t}.conv2", f"{p}.conv2", "conv"),
                     (f"{t}.bn1", f"{p}.bn1", "bn"),
                     (f"{t}.bn2", f"{p}.bn2", "bn")]
            if has_down(li, bi):
                mods += [(f"{t}.downsample.0", f"{p}.conv_down", "conv"),
                         (f"{t}.downsample.1", f"{p}.bn_down", "bn")]
    # FPN (reference backbone/resnet_fpn.py:66-82, 145-163): the top
    # stage's out conv, then two merging levels
    merge = ("m1", "bn", "m2")
    for lvl, outs in ((stages, ()), (stages - 1, merge), (stages - 2, merge)):
        mods.append((f"backbone.layer{lvl}_outconv", f"backbone.l{lvl}_out",
                     "conv"))
        for idx, name in zip((0, 1, 3), outs):
            mods.append((f"backbone.layer{lvl}_outconv2.{idx}",
                         f"backbone.l{lvl}_{name}",
                         "bn" if name == "bn" else "conv"))
    for ref, port, count in (("loftr_coarse.layers", "loftr_coarse", n_coarse),
                             ("geo_module.des_transformer.layers",
                              "geo_module", n_geo),
                             ("loftr_fine.layers", "loftr_fine", n_fine)):
        for i in range(count):
            t, p = f"{ref}.{i}", f"{port}.layer_{i}"
            mods += [(f"{t}.{n}", f"{p}.{n}", "linear")
                     for n in ("q_proj", "k_proj", "v_proj", "merge")]
            mods += [(f"{t}.mlp.0", f"{p}.mlp0", "linear"),
                     (f"{t}.mlp.2", f"{p}.mlp1", "linear"),
                     (f"{t}.norm1", f"{p}.norm1", "ln"),
                     (f"{t}.norm2", f"{p}.norm2", "ln")]
    mods += [("fine_preprocess.down_proj", "fine_preprocess.down_proj",
              "linear"),
             ("fine_preprocess.merge_feat", "fine_preprocess.merge_feat",
              "linear")]
    return mods


def _copy(src: Mapping, dst: Dict, mods, forward: bool) -> Dict:
    """Copy each module's leaves from src to dst under the other side's
    names (reference -> port when ``forward``); a missing required leaf
    raises KeyError."""
    for ref, port, kind in mods:
        a, b = (ref, port) if forward else (port, ref)
        for leaf, required in _LEAVES[kind]:
            if required or f"{a}.{leaf}" in src:
                dst[f"{b}.{leaf}"] = np.asarray(src[f"{a}.{leaf}"],
                                                np.float32)
    return dst


def convert_state_dict(sd: Mapping[str, np.ndarray],
                       n_coarse_layers: int = 8,
                       n_geo_layers: int = 4,
                       n_fine_layers: int = 2) -> Dict[str, np.ndarray]:
    """A reference-named (numpy-valued) state dict -> the port's GeoFormer
    state dict (float32 numpy; ``model.load_state_dict`` after
    ``torch.from_numpy``). The ``matcher.`` training prefix is stripped
    (reference full_model.py:125-129); keys the model does not use (e.g.
    BatchNorm's ``num_batches_tracked``) are left out."""
    sd = {(k[len(_PREFIX):] if k.startswith(_PREFIX) else k): v
          for k, v in sd.items()}
    stages = 4 if "backbone.layer4.0.conv1.weight" in sd else 3
    mods = _modules(lambda li, bi: f"backbone.layer{li}.{bi}.downsample.0"
                    ".weight" in sd, n_coarse_layers, n_geo_layers,
                    n_fine_layers, stages)
    return _copy(sd, {}, mods, forward=True)


def _layer_count(keys, stack: str) -> int:
    return len({k.split(".")[1] for k in keys
                if k.startswith(f"{stack}.layer_")})


def to_torch_state_dict(model: Union[nn.Module, Mapping[str, torch.Tensor]],
                        prefix: str = _PREFIX) -> Dict[str, np.ndarray]:
    """The inverse of convert_state_dict: a port GeoFormer (or its state
    dict) -> a reference-named numpy state dict with ``prefix`` on every
    key, as the reference's Lightning wrapper saved it; it lets the port's
    weights run under the reference's own torch code and makes drill
    checkpoints for ``cli parity``."""
    sd = model.state_dict() if isinstance(model, nn.Module) else model
    sd = {k: v.detach().float().cpu().numpy() if torch.is_tensor(v)
          else np.asarray(v) for k, v in sd.items()}
    mods = _modules(lambda li, bi: f"backbone.layer{li}_{bi}.conv_down"
                    ".weight" in sd, _layer_count(sd, "loftr_coarse"),
                    _layer_count(sd, "geo_module"),
                    _layer_count(sd, "loftr_fine"),
                    4 if "backbone.layer4_0.conv1.weight" in sd else 3)
    return {prefix + k: v for k, v in _copy(sd, {}, mods,
                                            forward=False).items()}


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """The numpy state dict of a torch ``.ckpt``/``.pth``/``.pt`` file (a
    Lightning checkpoint's ``state_dict``, or a bare state dict), read on
    the CPU. Like the JAX loader it unpickles the whole file, so read only
    checkpoints you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    out = {}
    for k, v in ckpt.items():
        if torch.is_tensor(v):
            v = v.detach()
            out[k] = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return out


def load_torch_weights(model: nn.Module, path: str) -> nn.Module:
    """Load a torch checkpoint into a port GeoFormer in place (strict)."""
    sd = convert_state_dict(load_torch_checkpoint(path))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    return model
