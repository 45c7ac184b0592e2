"""Parameter export in the JAX package's npz layout.

Counterpart of save_params in geoformer_tpu/train/checkpoint.py for ``.npz``
paths: a data-only archive of the flattened variables with '/'-joined keys
(``params/backbone/conv1/kernel``, ``batch_stats/.../mean``) and a ``step``
stamp, which geoformer_tpu.train.checkpoint.load_variables reads. It is the
inverse of weights.jax_to_state_dict, so a checkpoint crosses packages both
ways. Orbax state checkpoints (optimizer state, resume) are not ported yet.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch.nn as nn

from geoformer_tpu_torch.models.layers import BatchNorm, Conv, Dense


def state_dict_to_jax(model: nn.Module) -> Dict[str, np.ndarray]:
    """The model's variables as the flat JAX dict (JAX names and layouts:
    conv kernels HWIO, dense kernels [in, out], norms' weight as scale)."""
    out = {}
    for name, mod in model.named_modules():
        path = name.replace(".", "/")
        if isinstance(mod, Conv):
            out[f"params/{path}/kernel"] = mod.weight.detach().cpu() \
                .permute(2, 3, 1, 0).numpy()
        elif isinstance(mod, Dense):
            out[f"params/{path}/kernel"] = mod.weight.detach().cpu().T.numpy()
            if mod.bias is not None:
                out[f"params/{path}/bias"] = mod.bias.detach().cpu().numpy()
        elif isinstance(mod, (nn.LayerNorm, BatchNorm)):
            out[f"params/{path}/scale"] = mod.weight.detach().cpu().numpy()
            out[f"params/{path}/bias"] = mod.bias.detach().cpu().numpy()
            if isinstance(mod, BatchNorm):
                out[f"batch_stats/{path}/mean"] = \
                    mod.running_mean.detach().cpu().numpy()
                out[f"batch_stats/{path}/var"] = \
                    mod.running_var.detach().cpu().numpy()
    n_tensors = len(model.state_dict())
    if len(out) != n_tensors:
        raise KeyError(f"{n_tensors - len(out)} model tensors have no JAX "
                       "name (a module type the exporter does not know)")
    return {k: np.ascontiguousarray(v, dtype=np.float32)
            for k, v in out.items()}


def save_params(path: str, model: nn.Module, step: int) -> None:
    """Write the model's variables and ``step`` to ``path`` (.npz)."""
    if not path.endswith(".npz"):
        raise ValueError(f"save_params writes .npz archives, not {path}")
    np.savez(path, step=np.asarray(step), **state_dict_to_jax(model))
