"""Depth-supervised training steps back to back.

The depth trainer's loop (the port's ``run_depth_training`` and ``cli
train-depth``), without its data pipeline: the port's
``train/trainer.make_depth_train_step`` runs step after step at the mix's
batch, each on the next of ``batches`` batches of posed-RGBD pairs made in
set-up from the seed (portbench/gen_depth.py, held on the device: images
at the configuration's ``image_hw``, depth at the original resolution
padded to its ``depth_pad``), each with the RANSAC uniforms of a generator
on the device seeded from the seed and the step. Scalars are read back
every ``log_every`` steps and at the end. The window's figure: pairs
trained on per second over the whole window (the loop, the judged steps'
capture and the window are drivers/train.py's).

The check is drivers/train.py's, with the plain reference of the depth
step (portbench/reference/depth.py) following the judged steps. The
traced stretch is read with the program's spans
(portbench/program_spans.measure), so that the depth GT's own spans and
the host syncs can be read.

Set-up starts by asking the program's depth warp
(``geometry/depth.warp_kpts_depth``) for the two rules of the published
``warp_kpts`` that the reference follows (``warps_as_published``): a port
without them takes another depth GT than the reference, so it cannot run
this cell, and the run exits at once with a message, before any weight is
loaded or the card is touched.
"""

from __future__ import annotations

import torch

from portbench import counts, gen_depth, program_spans, trace
from portbench.drivers import train
from portbench.drivers.common import Capture, build_model, set_precision


def warps_as_published() -> bool:
    """Whether the port's depth warp makes a keypoint off depth0's map,
    and one that lands where depth1 is 0, invalid, as the published
    warp_kpts and portbench/reference/depth.py do (four keypoints on the
    CPU, identity pose: off the map, sound, onto zero depth twice)."""
    from geoformer_tpu_torch.geometry import depth as program_depth

    d0 = torch.full((1, 20, 30), 5.0)
    d1 = d0.clone()
    d1[0, :, 20:] = 0.0
    K = torch.tensor([[[20.0, 0, 15], [0, 20.0, 10], [0, 0, 1]]])
    kpts = torch.tensor([[[-1.0, 5.0], [5.0, 5.0], [25.0, 5.0],
                          [29.4, 5.0]]])
    valid, _ = program_depth.warp_kpts_depth(kpts, d0, d1,
                                             torch.eye(4)[None], K, K)
    return valid.tolist() == [[False, True, False, False]]


class Run(train.Run):
    # ------------------------------------------------------------ set-up --
    def setup(self) -> None:
        if not warps_as_published():
            raise SystemExit(
                "portbench: this program's depth warp "
                "(geometry/depth.warp_kpts_depth) lacks the published "
                "warp_kpts rules that the reference follows (a keypoint "
                "off depth0's map, or landing on zero depth in view 1, is "
                "invalid); depth.train-b4 cannot be run on it")
        from geoformer_tpu_torch.config import (
            LossConfig,
            OptimConfig,
            TrainConfig,
        )
        from geoformer_tpu_torch.train.optim import make_optimizer
        from geoformer_tpu_torch.train.trainer import (
            TrainState,
            make_depth_train_step,
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
        self.step_fn = make_depth_train_step(tcfg)
        self.capture = Capture(model, train._pick)
        self.batches = gen_depth.depth_batches(
            self.seed, int(self.mix["batches"]), self.batch,
            int(self.mix["orig_long_edge"]), self.hw[0],
            int(self.config["depth_pad"]), self.device,
            float(self.mix["min_overlap"]))
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

    # ------------------------------------------------------------ traced --
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

        summary = program_spans.measure(plain, body)
        self.attempted = n * self.batch
        outs = [self.capture.kept.pop(first[0] + i) for i in range(n)]
        summary.update(counts.work(outs, self.hw, self.cfg.geo,
                                   self.cfg.use_bf16, backward=True))
        summary["batches"] = n
        summary["gam_kernel_ms"] = trace.kernel_ms(
            summary, counts.GAM_KERNEL_NAMES)
        return summary

    # ------------------------------------------------------------- check --
    def check(self) -> dict:
        """drivers/train.py's check, with the reference's depth step in
        place of its homography step."""
        from portbench.reference import depth as refdepth
        from portbench.reference import train as reftrain

        homography_steps = reftrain.steps
        reftrain.steps = refdepth.steps
        try:
            out = super().check()
        finally:
            reftrain.steps = homography_steps
        out["overlap_min"] = float(torch.cat(
            [b["overlap"] for b in self.batches]).min())
        return out
