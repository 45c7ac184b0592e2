"""Batched pair matching: one caller in a closed loop.

The caller calls the port's ``BatchedMatcher.match_batch(..., return_geo=
True)`` back to back, each call on ``batch`` distinct pairs of the pool
(made in set-up from the seed, portbench/gen.py) in an order drawn from
the seed, with the matches and the homography back on the host. The
window's figures: pairs matched per second over the whole window, and the
95th percentile of every call's time (host clock, results on the host).

Set-up builds the model with the configuration's checkpoint, makes the
pool on the device and copies it to the host (the matcher takes host
arrays), and warms the one shape the traffic uses. The check judges
``judge_calls`` calls drawn from the seed among the first ones of the
window (portbench/judge_match.py): their outputs, and the features of
FEATURES, which those calls copy to the host as they run.
"""

from __future__ import annotations

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
    """What the judge and the counts read of a forward's output."""
    m1, m2, g, f = out.matches1, out.matches, out.geo, out.fine
    return {"m1_i": m1.i_ids, "m1_j": m1.j_ids, "m1_valid": m1.valid,
            "m2_i": m2.i_ids, "m2_j": m2.j_ids, "m2_valid": m2.valid,
            "fine_valid": f.valid, "fine_conf": f.mconf, "H": g.H,
            "has_H": g.has_H, "map0": g.map0, "map1": g.map1,
            "num_inliers": g.num_inliers}


BUCKET = 64       # the matcher pads each batch to multiples of this


# the features the judge holds against the reference's, by submodule: the
# coarse transformer's output and the GAM's ((image 0, image 1), [B, L, C])
FEATURES = {"loftr_coarse": lambda o: tuple(o[:2]),
            "geo_module": lambda o: tuple(o[:2])}


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
        self.calls = 0
        self.answers = {}

    # ------------------------------------------------------------ set-up --
    def setup(self) -> None:
        from geoformer_tpu_torch.eval.matcher import BatchedMatcher

        set_precision(self.config)
        self.cfg, model = build_model(self.config, self.device)
        self.matcher = BatchedMatcher(self.cfg, model, self.batch,
                                      self.device)
        self.capture = Capture(model, _pick, FEATURES)
        n = int(self.mix["pool"])
        img0, img1, _ = gen.pair_pool(self.seed, n, self.hw, self.device)
        self.pool0 = list(img0.cpu().numpy())
        self.pool1 = list(img1.cpu().numpy())
        del img0, img1
        cpu_gen = torch.Generator().manual_seed(self.seed)
        self.order = torch.randperm(n, generator=cpu_gen).tolist()
        first = int(self.mix["judge_from_first"])
        self.judged = set(torch.randperm(first, generator=cpu_gen)
                          [:int(self.mix["judge_calls"])].tolist())
        for k in range(int(self.mix["warmup_calls"])):
            self._call("shapes" if k == 0 else None)
        self.capture.kept.clear()
        self.answers.clear()
        self.capture.reserve(self.judged)
        self.calls = 0
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _pairs(self, k: int):
        n = len(self.order)
        start = (k * self.batch) % n
        return [self.order[(start + i) % n] for i in range(self.batch)]

    def _call(self, keep):
        """One match_batch call on the next batch of the order."""
        with self.spans("pool_copy"):
            idx = self._pairs(self.calls)
            a = [self.pool0[i] for i in idx]
            b = [self.pool1[i] for i in idx]
        self.capture.keep = keep
        with self.spans("match_batch"):
            res = self.matcher.match_batch(a, b, return_geo=True)
        self.capture.keep = None
        if keep is not None:
            self.answers[keep] = (idx, res)
        self.calls += 1
        return res

    # ------------------------------------------------------------ window --
    def window(self, seconds: float) -> dict:
        times = []
        start = time.perf_counter()
        end = start + seconds
        t1 = start
        while t1 < end:
            k = self.calls
            t0 = time.perf_counter()
            self._call(k if k in self.judged else None)
            t1 = time.perf_counter()
            times.append(t1 - t0)
        pairs = len(times) * self.batch
        self.attempted = pairs
        ms = np.asarray(times) * 1e3
        return {"match_pairs_per_s": pairs / (t1 - start),
                "match_batch_ms_p95": float(np.percentile(ms, 95)),
                "calls": len(times),
                "call_ms_p50": float(np.percentile(ms, 50))}

    def traced(self) -> dict:
        n = int(self.mix["trace_calls"])
        self.judged = {k for k in self.judged if k < n} or {0}
        self.capture.reserve(self.judged)

        def plain():
            for _ in range(n):
                self._call(None)

        def body():
            self.calls = 0
            for k in range(n):
                self._call(k)

        summary = trace.measure(plain, body)
        self.attempted = n * self.batch
        summary.update(counts.work(
            [self.capture.kept[k] for k in range(n)], self.hw,
            self.cfg.geo, self.cfg.use_bf16, backward=False))
        summary["batches"] = n
        summary["gam_kernel_ms"] = trace.kernel_ms(
            summary, counts.GAM_KERNEL_NAMES)
        for k in range(n):
            if k not in self.judged:
                self.capture.kept.pop(k)
                self.answers.pop(k)
        return summary

    # ------------------------------------------------------------- check --
    def free_program(self) -> None:
        self.capture.close()
        del self.matcher
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        from portbench import judge_match
        from portbench.reference import model as ref

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        W = ref.load_params(str(ROOT / self.config["weights"]), self.device)
        uniforms = ransac_uniforms(self.config, self.batch, 0, self.device,
                                   quant=BUCKET)
        figs = {}
        for k in sorted(self.judged):
            if k not in self.answers:
                continue
            idx, res = self.answers[k]
            img0 = torch.from_numpy(np.stack([self.pool0[i] for i in idx]))
            img1 = torch.from_numpy(np.stack([self.pool1[i] for i in idx]))
            got = judge_match.judge_call(
                W, img0.to(self.device), img1.to(self.device), uniforms,
                self.capture.kept[k], self.capture.host.get(k, {}), res,
                self.config, BUCKET, block=int(self.mix.get("judge_block", 2)))
            for key, vals in got.items():
                figs.setdefault(key, []).extend(vals)
        numbers = judge_match.reduce(figs) if figs else {}
        numbers["judged_calls"] = float(sum(
            1 for k in self.judged if k in self.answers))
        return numbers
