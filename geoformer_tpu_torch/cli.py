"""Command line of the port: infer, eval (HPatches) and parity.

Counterpart of the same subcommands of geoformer_tpu/cli.py, with its flags
and defaults, plus ``--device`` (default ``cuda``):

    python -m geoformer_tpu_torch.cli infer img0.png img1.png \\
        --ckpt checkpoints/tpu_r3_main/params_final.npz [--out m.npy]
    python -m geoformer_tpu_torch.cli eval hpatches --data <root> --ckpt ...
    python -m geoformer_tpu_torch.cli parity --hpatches <root> --ckpt ...

Checkpoints are the JAX package's ``.npz`` files; with no ``--ckpt`` the
weights are random (seed 0). Flags and benchmarks that are not ported yet
raise NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# The JAX CLI's per-benchmark protocols (imsize, RANSAC threshold in
# resized pixels); only HPatches is ported.
_EVAL_PROTOCOLS = {
    "hpatches": (480, 3.0),
    "fire": (768, 15.0),
    "isc": (480, 3.0),
    "isc-cls": (480, 3.0),
}


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet ({item})")


def _model(args):
    """(config, model) from the common flags, on no device yet."""
    from geoformer_tpu_torch import weights
    from geoformer_tpu_torch.config import (
        GeoFormerConfig,
        GeoModuleConfig,
        MatchConfig,
    )
    from geoformer_tpu_torch.models import GeoFormer

    if args.int8 or args.int8_full:
        _not_ported("--int8 / --int8-full", "ROADMAP queue 1, alternates")
    cfg = GeoFormerConfig(
        match=MatchConfig(thr=args.match_thr, max_matches=args.max_matches),
        geo=GeoModuleConfig(ransac_iters=args.gam_ransac_iters,
                            max_inliers=args.gam_max_inliers,
                            use_pallas=args.pallas),
        use_bf16=args.bf16)
    model = GeoFormer(cfg)
    if args.ckpt is None:
        return cfg, weights.random_init(model, seed=0)
    if args.ckpt.endswith((".ckpt", ".pth", ".pt")):
        _not_ported("loading torch checkpoints (utils/torch_convert.py)",
                    "ROADMAP queue 1")
    return cfg, weights.load_jax_params(model, weights.load_npz(args.ckpt))


def _hpatches(args, data, imsize, ransac_thr):
    from geoformer_tpu_torch.eval.hpatches import eval_hpatches

    cfg, model = _model(args)
    return eval_hpatches(model, cfg, data, imsize=imsize,
                         ransac_thr=ransac_thr, max_seqs=args.max_seqs,
                         device=args.device)


def cmd_eval(args):
    if args.benchmark != "hpatches":
        _not_ported(f"eval {args.benchmark}", "ROADMAP queue 1, eval drivers")
    imsize, ransac_thr = _EVAL_PROTOCOLS[args.benchmark]
    out = _hpatches(args, args.data,
                    imsize if args.imsize is None else args.imsize,
                    ransac_thr if args.ransac_thr is None else args.ransac_thr)
    print(json.dumps(out, indent=2, default=float))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, default=float)


def cmd_parity(args):
    """The HPatches protocol on a checkpoint, held to an expected AUC block
    (the reference README's by default) by a one-sided gate: exits 1 when
    any threshold trails it by more than --gate-pt points."""
    out = _hpatches(args, args.hpatches, args.imsize, args.ransac_thr)
    expect = [float(x) for x in args.expect.split(",")]
    rec = {"auc_a": out.get("auc_a"), "expected_auc_a": expect,
           "gate_pt": args.gate_pt, "est_failed": out.get("est_failed"),
           "n_pairs": out.get("n_pairs"),
           "mean_matches": out.get("mean_matches")}
    if out.get("auc_a"):
        delta = (np.asarray(out["auc_a"]) - np.asarray(expect)) * 100.0
        rec["delta_pt"] = [round(float(d), 2) for d in delta]
        rec["pass"] = bool((delta >= -args.gate_pt).all())
    else:
        rec["pass"] = False
    print(json.dumps(rec, default=float))
    if not rec["pass"]:
        sys.exit(1)


def cmd_infer(args):
    from geoformer_tpu_torch.eval.matcher import BatchedMatcher, load_gray

    if args.draw or args.draw_geo:
        _not_ported("--draw / --draw-geo (utils/plotting.py)",
                    "ROADMAP queue 1, match figures")
    if args.seq_shard > 1:
        _not_ported("--seq-shard", "ROADMAP queue 1, sequence parallelism")
    # read the files before building the model: a bad path fails at once
    im0, sc0 = load_gray(args.image0, args.imsize)
    im1, sc1 = load_gray(args.image1, args.imsize)
    cfg, model = _model(args)
    matcher = BatchedMatcher(cfg, model, batch_size=1, device=args.device)
    t0 = time.time()
    (mk0, mk1, conf, geo), = matcher.match_batch([im0], [im1],
                                                 return_geo=True)
    print(f"{len(mk0)} matches in {time.time() - t0:.2f}s "
          f"(GAM: has_H={geo['has_H']} inliers={geo['num_inliers']})")
    mk0 = mk0 * np.array(sc0)
    mk1 = mk1 * np.array(sc1)
    if args.out:
        np.save(args.out, np.concatenate([mk0, mk1, conf[:, None]], axis=1))
        print(f"saved -> {args.out}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("geoformer_tpu_torch.cli")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--ckpt", default=None,
                        help="a JAX .npz checkpoint (default: random)")
        sp.add_argument("--match-thr", type=float, default=0.2)
        sp.add_argument("--max-matches", type=int, default=1024)
        sp.add_argument("--gam-ransac-iters", type=int, default=256)
        sp.add_argument("--gam-max-inliers", type=int, default=1024)
        sp.add_argument("--imsize", type=int, default=480)
        sp.add_argument("--bf16", action="store_true",
                        help="bf16 compute path (params stay f32)")
        sp.add_argument("--pallas", action="store_true",
                        help="the hand-written GAM kernels (K1, K2)")
        sp.add_argument("--int8", action="store_true")
        sp.add_argument("--int8-full", action="store_true")
        sp.add_argument("--device", default="cuda")

    e = sub.add_parser("eval")
    e.add_argument("benchmark", choices=list(_EVAL_PROTOCOLS))
    e.add_argument("--data", required=True)
    e.add_argument("--ransac-thr", type=float, default=None,
                   help="RANSAC threshold in resized px "
                        "(default: the benchmark's reference protocol)")
    e.add_argument("--max-seqs", type=int, default=None)
    e.add_argument("--json-out", default=None)
    common(e)
    e.set_defaults(fn=cmd_eval, imsize=None)

    pa = sub.add_parser("parity")
    pa.add_argument("--hpatches", required=True,
                    help="hpatches-sequences-release root")
    pa.add_argument("--ransac-thr", type=float, default=3.0)
    pa.add_argument("--max-seqs", type=int, default=None)
    pa.add_argument("--expect", default="0.5154,0.7206,0.7997,0.8768",
                    help="expected AUC@1,3,5,10 (default: the reference "
                         "README block)")
    pa.add_argument("--gate-pt", type=float, default=1.0,
                    help="max allowed shortfall per threshold, in points")
    common(pa)
    pa.set_defaults(fn=cmd_parity)

    i = sub.add_parser("infer")
    i.add_argument("image0")
    i.add_argument("image1")
    i.add_argument("--out", default=None)
    i.add_argument("--draw", default=None)
    i.add_argument("--draw-geo", default=None)
    i.add_argument("--seq-shard", type=int, default=0)
    common(i)
    i.set_defaults(fn=cmd_infer)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
