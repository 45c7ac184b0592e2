"""Homography training steps back to back.

The trainer's loop, without its data pipeline: the port's
``train/trainer.make_train_step`` runs step after step at the mix's batch,
each on the next of ``batches`` batches made in set-up from the seed
(portbench/gen.training_batches, held on the device), each with the
RANSAC uniforms of a generator on the device seeded from the seed and the
step. Scalars are read back every ``log_every`` steps and at the end, as
the port's run_training reads them. The window's figure: pairs trained on
per second over the whole window.

Set-up builds one training state (the model from the configuration's
checkpoint, AdamW), and drives it through its first ``judge_steps`` steps
with the window's own call and feed, keeping what the check compares:
each step's loss, the norm by leaf of the first gradient as AdamW got it
(its first moment after one step over 1 - beta1), and the norm by leaf of
the parameters' change after those steps; then through the rest of
``warmup_steps``. The same state then runs the window. The check follows
the judged steps with the plain reference (portbench/reference/train.py).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import counts, gen, trace
from portbench.drivers.common import (
    ROOT,
    Capture,
    build_model,
    ransac_uniforms,
    set_precision,
)


def _pick(out):
    m1, m2, g = out.matches1, out.matches, out.geo
    return {"m1_i": m1.i_ids, "m1_j": m1.j_ids, "m1_valid": m1.valid,
            "m2_i": m2.i_ids, "m2_j": m2.j_ids, "m2_valid": m2.valid,
            "H": g.H, "has_H": g.has_H, "map0": g.map0, "map1": g.map1}


def ref_name(name: str, ref_params) -> str:
    """The checkpoint's name of a port parameter (kernel or scale for a
    weight)."""
    base, leaf = name.rsplit(".", 1)
    base = base.replace(".", "/")
    if leaf == "weight":
        return f"{base}/kernel" if f"{base}/kernel" in ref_params \
            else f"{base}/scale"
    return f"{base}/{leaf}"


def leaf_gap(prog, ref, keep=None):
    """Worst leaf's |prog - ref| / max(ref, the median leaf's ref), over the
    leaves in ``keep`` (all by default). Returns (gap, leaf)."""
    names = [k for k in ref if keep is None or k in keep]
    med = float(np.median([ref[k] for k in names]))
    worst, leaf = 0.0, ""
    for k in names:
        g = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if g > worst:
            worst, leaf = g, k
    return worst, leaf


class Run:
    def __init__(self, config, mix, seed, device, trace_on, log):
        self.config, self.mix, self.seed = config, mix, int(seed)
        self.device = torch.device(device)
        self.log = log
        self.spans = trace.Spans(trace_on)
        self.batch = int(mix["batch"])
        self.hw = tuple(config["image_hw"])
        self.attempted = 0
        self.failed = 0
        self.k = 0

    def _step_seed(self, k: int) -> int:
        return (self.seed % 2**40) * 65536 + k

    # ------------------------------------------------------------ set-up --
    def setup(self) -> None:
        from geoformer_tpu_torch.config import (
            LossConfig,
            OptimConfig,
            TrainConfig,
        )
        from geoformer_tpu_torch.train.optim import make_optimizer
        from geoformer_tpu_torch.train.trainer import (
            TrainState,
            make_train_step,
        )

        set_precision(self.config)
        t = self.config["train"]
        self.cfg, model = build_model(self.config, self.device)
        tcfg = TrainConfig(
            loss=LossConfig(**t["loss"]),
            optim=OptimConfig(adamw_decay=t["optim"]["adamw_decay"],
                              gradient_clipping=t["optim"][
                                  "gradient_clipping"]),
            batch_size=self.batch, image_hw=self.hw)
        self.lr = t["optim"]["canonical_lr"] * self.batch \
            / t["optim"]["canonical_bs"]
        self.state = TrainState(model, make_optimizer(tcfg.optim,
                                                      model.parameters()))
        self.step_fn = make_train_step(tcfg)
        self.capture = Capture(model, _pick)
        self.batches = gen.training_batches(
            self.seed, int(self.mix["batches"]), self.batch, self.hw,
            self.device)
        named = dict(model.named_parameters())
        start = {k: p.detach().clone() for k, p in named.items()}
        beta1 = self.state.optimizer.param_groups[0]["betas"][0]
        self.prog_losses = []
        n_judged = int(self.mix["judge_steps"])
        for k in range(int(self.mix["warmup_steps"])):
            judged = k < n_judged
            sc = self._step(k if judged else None)
            if judged:
                self.prog_losses.append(float(sc["loss"]))
            if k == 0:
                st = self.state.optimizer.state
                self.prog_grad = {
                    k_: (float(st[p]["exp_avg"].norm()) / (1 - beta1)
                         if "exp_avg" in st.get(p, {}) else 0.0)
                    for k_, p in named.items()}
            if k == n_judged - 1:
                self.prog_delta = {k_: float((p.detach() - start[k_]).norm())
                                   for k_, p in named.items()}
                del start
        self.judged_progs = [self.capture.kept.pop(k)
                             for k in range(n_judged)]
        self.k = int(self.mix["warmup_steps"])
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _step(self, keep):
        batch = self.batches[self.k % len(self.batches)]
        gen_k = torch.Generator(self.device).manual_seed(
            self._step_seed(self.k))
        self.capture.keep = keep
        with self.spans("train_step"):
            sc = self.step_fn(self.state, batch, self.lr, generator=gen_k)
        self.capture.keep = None
        self.k += 1
        return sc

    # ------------------------------------------------------------ window --
    def window(self, seconds: float) -> dict:
        log_every = int(self.mix["log_every"])
        losses = []
        start = time.perf_counter()
        end = start + seconds
        n = 0
        while True:
            sc = self._step(None)
            losses.append(sc["loss"])
            n += 1
            if n % log_every == 0 or time.perf_counter() >= end:
                with self.spans("scalar_read"):
                    read = {k: float(v) for k, v in sc.items()}
                del read
                if time.perf_counter() >= end:
                    break
        t1 = time.perf_counter()
        bad = int((~torch.isfinite(torch.stack(losses))).sum())
        self.attempted = n * self.batch
        self.failed = bad * self.batch
        return {"train_pairs_per_s": n * self.batch / (t1 - start),
                "steps": n}

    def traced(self) -> dict:
        n = int(self.mix["trace_steps"])

        def plain():
            for _ in range(n):
                sc = self._step(None)
            float(sc["loss"])

        first = []

        def body():
            first.append(self.k)
            for i in range(n):
                self._step(first[0] + i)
            with self.spans("scalar_read"):
                torch.cuda.synchronize()

        summary = trace.measure(plain, body)
        self.attempted = n * self.batch
        outs = [self.capture.kept.pop(first[0] + i) for i in range(n)]
        summary.update(counts.work(outs, self.hw, self.cfg.geo,
                                   self.cfg.use_bf16, backward=True))
        summary["batches"] = n
        summary["gam_kernel_ms"] = trace.kernel_ms(
            summary, counts.GAM_KERNEL_NAMES)
        return summary

    # ------------------------------------------------------------- check --
    def free_program(self) -> None:
        self.capture.close()
        del self.state, self.step_fn
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        from portbench.reference import model as ref
        from portbench.reference import train as reftrain

        if any(p["m1_i"].shape[0] != self.batch for p in self.judged_progs):
            self.log("the judged steps' forwards saw another batch size")
            return dict.fromkeys(("loss_gap", "loss_gap_step1", "grad_gap",
                                  "update_gap", "update_gap_median"), 1e30)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        W = ref.load_params(str(ROOT / self.config["weights"]), self.device)
        n = len(self.judged_progs)
        uniforms = [ransac_uniforms(self.config, self.batch,
                                    self._step_seed(k), self.device)
                    for k in range(n)]
        batches = [self.batches[k % len(self.batches)] for k in range(n)]
        losses, first, start = reftrain.steps(
            W, batches, self.judged_progs, uniforms, self.config, self.lr)
        P = W["params"]
        names = {k: ref_name(k, P) for k in self.prog_grad}
        ref_grad = {k: float(first[r].norm()) for k, r in names.items()}
        ref_delta = {k: float((P[r] - start[r]).norm())
                     for k, r in names.items()}
        med = float(np.median(list(ref_grad.values())))
        moving = {k for k, v in ref_grad.items() if v >= 1e-3 * med}
        loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                       for a, b in zip(self.prog_losses, losses))
        grad_gap, grad_leaf = leaf_gap(self.prog_grad, ref_grad)
        upd_gap, upd_leaf = leaf_gap(self.prog_delta, ref_delta, moving)
        med_delta = float(np.median([ref_delta[k] for k in moving]))
        upd_median = float(np.median([
            abs(self.prog_delta[k] - ref_delta[k])
            / max(ref_delta[k], med_delta, 1e-30) for k in moving]))
        if not all(map(math.isfinite, self.prog_losses)):
            loss_gap = 1e30
        self.log(f"worst leaves: gradient {grad_leaf}, update {upd_leaf}; "
                 f"losses program {self.prog_losses} reference {losses}")
        return {"loss_gap": loss_gap, "grad_gap": grad_gap,
                "update_gap": upd_gap, "update_gap_median": upd_median,
                "leaves_left_out": float(len(ref_grad) - len(moving)),
                "loss_gap_step1": abs(self.prog_losses[0] - losses[0])
                / max(abs(losses[0]), 1e-30)}
