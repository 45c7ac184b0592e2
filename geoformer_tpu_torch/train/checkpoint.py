"""Parameter export in the JAX package's npz layout, and state checkpoints.

save_params is the counterpart of save_params in
geoformer_tpu/train/checkpoint.py for ``.npz`` paths: a data-only archive
of the flattened variables with '/'-joined keys
(``params/backbone/conv1/kernel``, ``batch_stats/.../mean``) and a ``step``
stamp, which geoformer_tpu.train.checkpoint.load_variables reads. It is the
inverse of weights.jax_to_state_dict, so a checkpoint crosses packages both
ways.

save_checkpoint, restore_checkpoint and save_checkpoint_monitored are the
counterparts of the JAX package's orbax state checkpoints, in orbax's
layout of one directory per step under ``ckpt_dir`` (``<ckpt_dir>/<step>/``),
but with the port's own content: ``state.npz``, a data-only archive
(loads with ``np.load(allow_pickle=False)``) of

    params/..., batch_stats/...    the model, as save_params writes it
    opt_state/mu/..., opt_state/nu/...
                                   AdamW's two moments under the
                                   parameters' JAX names and layouts
    opt_state/count                the optimizer's step count
    step                           the train state's step

and, for the monitored variant, ``metrics.json``. Moments are stored by
name, so a checkpoint does not depend on the order of
``model.parameters()``. The port does not read orbax directories and the
JAX package does not read these; ``params_final.npz`` crosses both ways.
A step is written into a temporary directory and renamed into place, so a
crash while writing leaves the earlier steps whole.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from geoformer_tpu_torch import weights
from geoformer_tpu_torch.models.layers import BatchNorm, Conv, Dense

STATE_FILE = "state.npz"
METRICS_FILE = "metrics.json"


def jax_names(model: nn.Module) -> Dict[str, str]:
    """State-dict name -> the JAX package's flat name of the same variable
    (``backbone.conv1.weight`` -> ``params/backbone/conv1/kernel``)."""
    out = {}
    for name, mod in model.named_modules():
        path = name.replace(".", "/")
        if isinstance(mod, (Conv, Dense)):
            out[f"{name}.weight"] = f"params/{path}/kernel"
            if getattr(mod, "bias", None) is not None:
                out[f"{name}.bias"] = f"params/{path}/bias"
        elif isinstance(mod, (nn.LayerNorm, BatchNorm)):
            out[f"{name}.weight"] = f"params/{path}/scale"
            out[f"{name}.bias"] = f"params/{path}/bias"
            if isinstance(mod, BatchNorm):
                out[f"{name}.running_mean"] = f"batch_stats/{path}/mean"
                out[f"{name}.running_var"] = f"batch_stats/{path}/var"
    n_tensors = len(model.state_dict())
    if len(out) != n_tensors:
        raise KeyError(f"{n_tensors - len(out)} model tensors have no JAX "
                       "name (a module type the exporter does not know)")
    return out


def to_jax_layout(x: torch.Tensor) -> np.ndarray:
    """A tensor in the JAX layout of its variable: conv kernels HWIO, dense
    kernels [in, out], everything else as it is; f32 numpy."""
    x = x.detach().cpu()
    if x.ndim == 4:
        x = x.permute(2, 3, 1, 0)
    elif x.ndim == 2:
        x = x.T
    return np.ascontiguousarray(x.numpy(), dtype=np.float32)


def state_dict_to_jax(model: nn.Module) -> Dict[str, np.ndarray]:
    """The model's variables as the flat JAX dict (JAX names and layouts:
    conv kernels HWIO, dense kernels [in, out], norms' weight as scale)."""
    names = jax_names(model)
    return {names[k]: to_jax_layout(v) for k, v in model.state_dict().items()}


def save_params(path: str, model: nn.Module, step: int) -> None:
    """Write the model's variables and ``step`` to ``path`` (.npz)."""
    if not path.endswith(".npz"):
        raise ValueError(f"save_params writes .npz archives, not {path}")
    np.savez(path, step=np.asarray(step), **state_dict_to_jax(model))


# ---------------------------------------------------------- state ---------

def state_arrays(state) -> Dict[str, np.ndarray]:
    """The flat arrays of a TrainState's checkpoint (module docstring)."""
    model, opt = state.model, state.optimizer
    out = state_dict_to_jax(model)
    names = jax_names(model)
    count = 0
    for name, p in model.named_parameters():
        slots = opt.state.get(p, {})
        rest = names[name][len("params/"):]
        for moment, slot in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            m = slots.get(slot)
            out[f"opt_state/{moment}/{rest}"] = to_jax_layout(
                torch.zeros_like(p) if m is None else m)
        if "step" in slots:
            count = int(slots["step"])
    out["opt_state/count"] = np.asarray(count, np.int64)
    out["step"] = np.asarray(state.step, np.int64)
    return out


def load_state_arrays(state, flat: Dict[str, np.ndarray]):
    """Set a TrainState from checkpoint arrays, in place: the model's
    variables, both moments and the step count of every parameter, and the
    state's step. Returns the state."""
    model, opt = state.model, state.optimizer
    weights.load_jax_params(model, {k: v for k, v in flat.items()
                                     if k.startswith(("params/",
                                                      "batch_stats/"))})
    moments = {}
    for moment in ("mu", "nu"):
        prefix = f"opt_state/{moment}/"
        moments[moment] = weights.jax_to_state_dict(
            {"params/" + k[len(prefix):]: v for k, v in flat.items()
             if k.startswith(prefix)})
    count = float(flat["opt_state/count"])
    for name, p in model.named_parameters():
        opt.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": moments["mu"][name].to(p.device),
            "exp_avg_sq": moments["nu"][name].to(p.device)}
    state.step = int(flat["step"])
    return state


def checkpoint_steps(ckpt_dir: str) -> Dict[int, str]:
    """Step -> directory of every checkpoint under ckpt_dir."""
    if not os.path.isdir(ckpt_dir):
        return {}
    return {int(d): os.path.join(ckpt_dir, d) for d in os.listdir(ckpt_dir)
            if d.isdigit() and os.path.isdir(os.path.join(ckpt_dir, d))}


def _write_step(ckpt_dir: str, step: int, arrays: Dict[str, np.ndarray],
                metrics: Optional[dict] = None) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".tmp-{step}-", dir=ckpt_dir)
    try:
        np.savez(os.path.join(tmp, STATE_FILE), **arrays)
        if metrics is not None:
            with open(os.path.join(tmp, METRICS_FILE), "w") as f:
                json.dump(metrics, f)
        final = os.path.join(ckpt_dir, str(step))
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def save_checkpoint(ckpt_dir: str, state, step: int,
                    keep: Optional[int] = 5) -> None:
    """Write ``state`` as step ``step`` and keep the ``keep`` newest steps
    (orbax's max_to_keep; None keeps all)."""
    _write_step(ckpt_dir, step, state_arrays(state))
    if keep is not None:
        steps = checkpoint_steps(ckpt_dir)
        for s in sorted(steps)[:-keep]:
            shutil.rmtree(steps[s])


def restore_checkpoint(ckpt_dir: str, state, step: Optional[int] = None,
                       require: bool = False):
    """Restore the latest (or the given) step into ``state``, in place, and
    return it, bit for bit as it was saved.

    With require=True (set by resume) a missing checkpoint raises
    FileNotFoundError instead of returning the fresh state: a resume whose
    checkpoint directory was lost would otherwise restart from step 0."""
    steps = checkpoint_steps(ckpt_dir)
    if step is None:
        if not steps:
            if require:
                raise FileNotFoundError(
                    f"resume requested but no checkpoint step exists under "
                    f"{os.path.abspath(ckpt_dir)}; refusing to silently "
                    "restart from step 0")
            return state
        step = max(steps)
    path = os.path.join(ckpt_dir, str(step), STATE_FILE)
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    return load_state_arrays(state, flat)


def save_checkpoint_monitored(ckpt_dir: str, state, step: int,
                              metrics: dict, monitor: str = "auc@10",
                              mode: str = "max", keep: int = 5) -> None:
    """Top-k retention by a monitored metric: write ``state`` as step
    ``step`` with ``metrics[monitor]``, then keep the best ``keep`` steps
    ranked by it (``mode`` "max" or "min"). Steps saved without the metric
    are kept, as orbax keeps checkpoints without metrics by default."""
    if mode not in ("max", "min"):
        raise ValueError(f"mode {mode!r}")
    _write_step(ckpt_dir, step, state_arrays(state),
                {monitor: float(metrics[monitor])})
    ranked = []
    for s, d in checkpoint_steps(ckpt_dir).items():
        path = os.path.join(d, METRICS_FILE)
        if os.path.isfile(path):
            with open(path) as f:
                value = json.load(f).get(monitor)
            if value is not None:
                ranked.append((value, s, d))
    ranked.sort(key=lambda r: r[0], reverse=mode == "max")
    for _, _, d in ranked[keep:]:
        shutil.rmtree(d)
