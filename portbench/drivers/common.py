"""What the drivers share: the program's configuration from a cell's
configuration file, its weights, and the capture of a forward's outputs."""

from __future__ import annotations

from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]


def model_config(config: dict):
    """The port's GeoFormerConfig of a configuration file's model keys;
    ``int8_full`` (set by calibrate.py's ``control`` variant, the
    program's own int8 path) turns on its eval-only int8 flags."""
    from geoformer_tpu_torch import config as pc

    def part(cls, key):
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in config[key].items()})

    cfg = pc.GeoFormerConfig(
        backbone=part(pc.BackboneConfig, "backbone"),
        coarse=part(pc.CoarseTransformerConfig, "coarse"),
        fine=part(pc.FineTransformerConfig, "fine"),
        match=part(pc.MatchConfig, "match"),
        geo=part(pc.GeoModuleConfig, "geo"),
        fine_match=part(pc.FineMatchConfig, "fine_match"),
        coarse_scale=config["coarse_scale"], fine_scale=config["fine_scale"],
        use_bf16=config["use_bf16"])
    if config.get("int8_full"):
        cfg = pc.with_int8(cfg, int8_full=True)
    return cfg


def set_precision(config: dict) -> None:
    """TF32 as the configuration states it, for the program's float32
    products and convolutions (and so for the reference, which runs in the
    same process after the window, TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = bool(config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(config["tf32"])


def build_model(config: dict, device):
    """The port's GeoFormer with the configuration's checkpoint."""
    from geoformer_tpu_torch import weights
    from geoformer_tpu_torch.models import GeoFormer

    cfg = model_config(config)
    model = GeoFormer(cfg)
    weights.load_jax_params(model, weights.load_npz(str(ROOT / config[
        "weights"])))
    return cfg, model.to(device)


def ransac_uniforms(config: dict, batch: int, seed: int, device,
                    quant: int = 1):
    """The RANSAC draws of one forward as the program makes them: uniforms
    [batch, iters, capacity] from a generator on the device seeded
    ``seed``; the capacity is the coarse match cap (the whole grid without
    one), the grid that of the images padded to multiples of ``quant``
    pixels, as the program runs them."""
    hw = [-(-x // quant) * quant for x in config["image_hw"]]
    cells = (hw[0] // 8) * (hw[1] // 8)
    cap = config["match"]["max_matches"]
    n = cells if cap <= 0 or cap >= cells else cap
    return torch.rand((batch, config["geo"]["ransac_iters"], n),
                      device=device,
                      generator=torch.Generator(device).manual_seed(seed))


class Capture:
    """Forward hooks that keep what the forwards they are told to keep
    (``keep = key``) produced, under that key: ``pick`` of the model's
    output, on the device, in ``kept``; and, for each submodule named in
    ``to_host``, its pick of that submodule's output (a tuple of tensors),
    copied without a wait into pinned host buffers in ``host``, so that
    the card holds no more memory for them. A forward kept before
    ``reserve`` only records the shapes that the buffers take; a kept
    forward whose shapes differ from them leaves its entry empty."""

    def __init__(self, model, pick, to_host=None):
        self.keep = None
        self.kept = {}
        self.host = {}
        self.shapes = {}
        self.pick = pick
        self.handles = [model.register_forward_hook(self._hook)]
        for name, hpick in (to_host or {}).items():
            self.handles.append(model.get_submodule(name)
                                .register_forward_hook(
                                    self._host_hook(name, hpick)))

    def _hook(self, module, inputs, output):
        if self.keep is not None:
            self.kept[self.keep] = self.pick(output)

    def _host_hook(self, name, hpick):
        def hook(module, inputs, output):
            if self.keep is None:
                return
            got = hpick(output)
            bufs = self.host.get(self.keep)
            if bufs is None:
                self.shapes[name] = [(t.shape, t.dtype) for t in got]
            elif name in bufs and all(
                    b.shape == t.shape for b, t in zip(bufs[name], got)):
                for b, t in zip(bufs[name], got):
                    b.copy_(t, non_blocking=True)
            else:
                bufs.pop(name, None)
        return hook

    def reserve(self, keys) -> None:
        pin = torch.cuda.is_available()
        for k in keys:
            self.host[k] = {n: [torch.empty(s, dtype=d, pin_memory=pin)
                                for s, d in shapes]
                            for n, shapes in self.shapes.items()}

    def close(self) -> None:
        for h in self.handles:
            h.remove()
