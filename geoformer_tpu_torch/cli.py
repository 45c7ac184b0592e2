"""Command line of the port: train, train-depth, infer, eval, parity, export,
localize, slam.

Counterpart of the same subcommands of geoformer_tpu/cli.py, with its flags
and defaults, plus ``--device`` (default ``cuda``):

    python -m geoformer_tpu_torch.cli train --pallas --batch 4 --out ckpt \\
        [--steps 12000] [--val-every 500 --tensorboard] [--resume]
    python -m geoformer_tpu_torch.cli train-depth --npz-dir <c>/index \
        --root <c> --val-npz-dir <c>/index_val --depth-pad 640 --pallas \
        --batch 4 --out ckpt_depth    (<c>: python -m
        geoformer_tpu_torch.data.depth_corpus --cluttered --out <c>)
    python -m geoformer_tpu_torch.cli infer img0.png img1.png \\
        --ckpt checkpoints/tpu_r3_main/params_final.npz [--out m.npy] \\
        [--draw m.png] [--draw-geo g.png]
    python -m geoformer_tpu_torch.cli eval hpatches --data <root> --ckpt ...
    python -m geoformer_tpu_torch.cli eval fire|isc --data <root> --ckpt ...
    python -m geoformer_tpu_torch.cli eval isc-cls --data pairs.txt --ckpt ...
    python -m geoformer_tpu_torch.cli parity --hpatches <root> --ckpt ...
    python -m geoformer_tpu_torch.cli export --out matcher.gfmz --ckpt ... \\
        [--height 480 --width 640 --batch 1] [--bf16 --pallas]
    python -m geoformer_tpu_torch.cli localize --nvm model.nvm \\
        --database db.db --images <dir> --queries queries.txt \\
        --query-pairs pairs.txt --out <dir> --ckpt ...   (or --scan-dir)
    python -m geoformer_tpu_torch.cli slam --images <dir> \\
        [--glob 'frame_*.png'] [--loop-stride 5] [--gt gt.npz] --ckpt ...

``train`` and ``train-depth`` are data-parallel under torchrun
(``torchrun --nproc-per-node N -m geoformer_tpu_torch.cli train ...``):
each rank runs on ``cuda:$LOCAL_RANK`` with NCCL (gloo with ``--device
cpu``), ``--batch`` is the global batch (core/mesh.py, train/loop.py).

Checkpoints are the JAX package's ``.npz`` files or the reference's torch
``.ckpt``/``.pth``/``.pt`` files; with no ``--ckpt`` the weights are random
(seed 0). Flags and benchmarks that are not ported yet raise
NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# The JAX CLI's per-benchmark protocols (imsize, RANSAC threshold in
# resized pixels).
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
        with_int8,
    )
    from geoformer_tpu_torch.models import GeoFormer

    cfg = with_int8(GeoFormerConfig(
        match=MatchConfig(thr=args.match_thr, max_matches=args.max_matches),
        geo=GeoModuleConfig(ransac_iters=args.gam_ransac_iters,
                            max_inliers=args.gam_max_inliers,
                            use_pallas=args.pallas),
        use_bf16=args.bf16), args.int8, args.int8_full)
    model = GeoFormer(cfg)
    if args.ckpt is None:
        return cfg, weights.random_init(model, seed=0)
    if args.ckpt.endswith((".ckpt", ".pth", ".pt")):
        # released torch checkpoints (reference-named state dicts) load
        # directly
        from geoformer_tpu_torch.utils.torch_convert import load_torch_weights

        return cfg, load_torch_weights(model, args.ckpt)
    return cfg, weights.load_jax_params(model, weights.load_npz(args.ckpt))


def _hpatches(args, data, imsize, ransac_thr):
    from geoformer_tpu_torch.eval.hpatches import eval_hpatches

    cfg, model = _model(args)
    return eval_hpatches(model, cfg, data, imsize=imsize,
                         ransac_thr=ransac_thr, max_seqs=args.max_seqs,
                         device=args.device)


def cmd_train(args):
    from geoformer_tpu_torch.config import (
        GeoFormerConfig,
        GeoModuleConfig,
        MatchConfig,
    )
    from geoformer_tpu_torch.core.mesh import process_group_from_env
    from geoformer_tpu_torch.train.loop import run_training

    model_cfg = GeoFormerConfig(
        match=MatchConfig(max_matches=args.max_matches, force_one_match=True),
        geo=GeoModuleConfig(ransac_iters=args.gam_ransac_iters,
                            max_inliers=args.gam_max_inliers,
                            use_pallas=args.pallas),
        use_bf16=args.bf16,
    )
    with process_group_from_env(args.device) as device:
        run_training(
            image_dir=args.data,
            steps=args.steps,
            batch_size=args.batch,
            image_hw=(args.height, args.width),
            ckpt_dir=args.out,
            log_every=args.log_every,
            seed=args.seed,
            model_cfg=model_cfg,
            lr=args.lr,
            warmup_steps=args.warmup,
            resume=args.resume,
            val_every=args.val_every,
            tensorboard=args.tensorboard,
            texture_style=args.texture_style,
            image_fraction=args.data_mix,
            log_figures=args.log_figures,
            sensor_aug=args.sensor_aug,
            bank_size=args.bank_size,
            bank_refresh=args.bank_refresh,
            device=device,
        )


def cmd_train_depth(args):
    from geoformer_tpu_torch.config import (
        GeoFormerConfig,
        GeoModuleConfig,
        MatchConfig,
    )
    from geoformer_tpu_torch.core.mesh import process_group_from_env
    from geoformer_tpu_torch.train.depth_loop import run_depth_training

    model_cfg = GeoFormerConfig(
        match=MatchConfig(max_matches=args.max_matches, force_one_match=True),
        geo=GeoModuleConfig(ransac_iters=args.gam_ransac_iters,
                            max_inliers=args.gam_max_inliers,
                            use_pallas=args.pallas),
        use_bf16=args.bf16,
    )
    with process_group_from_env(args.device) as device:
        run_depth_training(
            npz_dir=args.npz_dir,
            root_dir=args.root,
            val_npz_dir=args.val_npz_dir,
            steps=args.steps,
            batch_size=args.batch,
            image_hw=(args.imsize, args.imsize),
            ckpt_dir=args.out,
            log_every=args.log_every,
            val_every=args.val_every,
            n_val_batches=args.n_val_batches,
            seed=args.seed,
            model_cfg=model_cfg,
            lr=args.lr,
            resume=args.resume,
            min_overlap_score=args.min_overlap,
            depth_pad=args.depth_pad,
            device=device,
        )


def cmd_eval(args):
    # --imsize/--ransac-thr default to the benchmark's protocol (they parse
    # as None unless given)
    proto = _EVAL_PROTOCOLS[args.benchmark]
    imsize = proto[0] if args.imsize is None else args.imsize
    ransac_thr = proto[1] if args.ransac_thr is None else args.ransac_thr
    if args.benchmark == "hpatches":
        out = _hpatches(args, args.data, imsize, ransac_thr)
    else:
        cfg, model = _model(args)
        if args.benchmark == "fire":
            from geoformer_tpu_torch.eval.fire import eval_fire

            out = eval_fire(model, cfg, args.data, imsize=imsize,
                            ransac_thr=ransac_thr, device=args.device)
        elif args.benchmark == "isc":
            from geoformer_tpu_torch.eval.isc import eval_isc

            out = eval_isc(model, cfg, args.data, imsize=imsize,
                           ransac_thr=ransac_thr, device=args.device)
        else:
            from geoformer_tpu_torch.eval.isc import eval_isc_classification

            # --data is a text file of `query refer label` lines
            out = eval_isc_classification(model, cfg, args.data,
                                          imsize=imsize,
                                          ransac_thr=ransac_thr,
                                          device=args.device)
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

    if args.seq_shard > 1:
        _not_ported("--seq-shard", "ROADMAP queue 1 item 3, sequence "
                    "parallelism")
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
    if args.draw:
        from geoformer_tpu_torch.utils.plotting import (
            render_matches,
            write_png,
        )

        write_png(args.draw, render_matches(im0, im1, mk0, mk1),
                  text=f"GeoFormer-TPU\n{len(mk0)} matches")
        print(f"figure -> {args.draw}")
    if args.draw_geo:
        from geoformer_tpu_torch.utils.plotting import (
            NO_H_TEXT,
            render_geo_windows,
            write_png,
        )

        write_png(args.draw_geo,
                  render_geo_windows(im0, im1, geo["H"], geo["has_H"],
                                     scale=cfg.coarse_scale,
                                     window_size=cfg.geo.window_size),
                  text=None if geo["has_H"] else NO_H_TEXT)
        if not geo["has_H"]:
            print(NO_H_TEXT)
        print(f"GAM window figure -> {args.draw_geo}")
    mk0 = mk0 * np.array(sc0)
    mk1 = mk1 * np.array(sc1)
    if args.out:
        np.save(args.out, np.concatenate([mk0, mk1, conf[:, None]], axis=1))
        print(f"saved -> {args.out}")


def _export_device(args) -> str:
    """The one device of --platforms (cuda or cpu), else --device."""
    if not args.platforms:
        return args.device
    platforms = [p.strip() for p in args.platforms.split(",") if p.strip()]
    if len(platforms) != 1 or platforms[0] not in ("cuda", "cpu"):
        raise ValueError(f"--platforms {args.platforms!r}: the port exports "
                         f"for one of cuda or cpu")
    return platforms[0]


def cmd_export(args):
    from geoformer_tpu_torch.serving import save_bundle

    device = _export_device(args)
    cfg, model = _model(args)
    save_bundle(args.out, cfg, model, hw=(args.height, args.width),
                batch=args.batch, device=device)
    print(f"serving bundle ({args.batch}x{args.height}x{args.width}, "
          f"platforms={[device]}) -> {args.out}")


def cmd_localize(args):
    from geoformer_tpu_torch.eval.localize_driver import (
        load_pairs_txt,
        run_localization,
    )
    from geoformer_tpu_torch.eval.matcher import BatchedMatcher, load_gray
    from geoformer_tpu_torch.eval.sfm_localize import (
        parse_queries_with_intrinsics,
        write_pose_file,
    )

    if not args.scan_dir and not (args.nvm and args.database):
        raise SystemExit("localize needs either --scan-dir (dense InLoc "
                         "mode) or both --nvm and --database (SfM mode)")
    cfg, model = _model(args)
    matcher = BatchedMatcher(cfg, model, batch_size=1, device=args.device)

    def match_pairs_fn(n0, n1):
        im0, sc0 = load_gray(os.path.join(args.images, n0), args.imsize)
        im1, sc1 = load_gray(os.path.join(args.images, n1), args.imsize)
        (mk0, mk1, _), = matcher.match_batch([im0], [im1])
        return np.concatenate([mk0 * np.array(sc0), mk1 * np.array(sc1)],
                              axis=1)

    queries = parse_queries_with_intrinsics(args.queries)
    query_pairs = load_pairs_txt(args.query_pairs)
    if args.scan_dir:
        # InLoc-style dense-depth mode: 3D from per-db-image depth scans
        # (eval/inloc.py), no NVM or triangulation
        from geoformer_tpu_torch.eval.inloc import (
            load_db_scans,
            localize_queries_dense,
        )

        db_names = sorted({n for _, n in query_pairs})
        scans = load_db_scans(args.scan_dir, db_names)
        qmatches = {}
        for qn, dbn in query_pairs:
            if dbn not in scans:
                continue
            qmatches.setdefault(qn, {})[dbn] = match_pairs_fn(qn, dbn)
        poses = localize_queries_dense(queries, qmatches, scans,
                                       ransac_thr_px=args.ransac_thr,
                                       device=args.device)
        os.makedirs(args.out, exist_ok=True)
        write_pose_file(poses, os.path.join(args.out, "poses.txt"))
    else:
        run_localization(
            nvm_path=args.nvm,
            db_path=args.database,
            out_dir=args.out,
            match_pairs_fn=match_pairs_fn,
            queries=queries,
            query_pairs=query_pairs,
            db_pairs=load_pairs_txt(args.db_pairs) if args.db_pairs else None,
            intrinsics_txt=args.intrinsics_txt,
            covis_topk=args.covis_topk,
            ransac_thr_px=args.ransac_thr,
            device=args.device,
        )
    print(f"poses -> {os.path.join(args.out, 'poses.txt')}")


def cmd_slam(args):
    import glob

    from geoformer_tpu_torch.engine.slam import (
        run_planar_slam,
        save_trajectory,
        trajectory_drift,
    )
    from geoformer_tpu_torch.eval.matcher import BatchedMatcher, load_gray

    paths = sorted(glob.glob(os.path.join(args.images, args.glob)))
    if len(paths) < 2:
        raise SystemExit(f"need >=2 frames, found {len(paths)} "
                         f"in {args.images}/{args.glob}")
    frames = [load_gray(p, args.imsize)[0] for p in paths]
    shapes = {f.shape for f in frames}
    if len(shapes) != 1:
        raise SystemExit(f"frames must share one shape, got {shapes}")

    cfg, model = _model(args)
    matcher = BatchedMatcher(cfg, model, batch_size=1, device=args.device)

    def match_fn(i, j):
        (mk0, mk1, _), = matcher.match_batch([frames[i]], [frames[j]])
        return mk0, mk1

    res = run_planar_slam(frames, match_fn, loop_stride=args.loop_stride,
                          ransac_thr=args.ransac_thr, device=args.device)
    out = {"frames": len(frames),
           "edges_ok": sum(e["ok"] for e in res["edges"]),
           "edges_total": len(res["edges"])}
    if args.gt:
        gt = np.load(args.gt)["H"] if args.gt.endswith(".npz") \
            else np.loadtxt(args.gt)[:, 1:].reshape(-1, 3, 3)
        hw = frames[0].shape
        out["corner_drift_chained_px"] = round(
            trajectory_drift(res["H_chained"], gt, hw), 3)
        out["corner_drift_optimized_px"] = round(
            trajectory_drift(res["H_traj"], gt, hw), 3)
    if args.out:
        save_trajectory(res["H_traj"], args.out)
        out["trajectory"] = args.out
    print(json.dumps(out))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("geoformer_tpu_torch.cli")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--ckpt", default=None,
                        help="a JAX .npz or a torch .ckpt/.pth/.pt "
                             "checkpoint (default: random)")
        sp.add_argument("--match-thr", type=float, default=0.2)
        sp.add_argument("--max-matches", type=int, default=1024)
        sp.add_argument("--gam-ransac-iters", type=int, default=256)
        sp.add_argument("--gam-max-inliers", type=int, default=1024)
        sp.add_argument("--imsize", type=int, default=480)
        sp.add_argument("--bf16", action="store_true",
                        help="bf16 compute path (params stay f32)")
        sp.add_argument("--pallas", action="store_true",
                        help="the hand-written GAM kernels (K1, K2)")
        sp.add_argument("--int8", action="store_true",
                        help="dynamic int8 backbone convolutions (eval-only)")
        sp.add_argument("--int8-full", action="store_true",
                        help="int8 backbone AND transformer projections/MLPs "
                             "(eval-only)")
        sp.add_argument("--device", default="cuda")

    t = sub.add_parser("train")
    t.add_argument("--data", default=None, help="image dir (else procedural)")
    t.add_argument("--data-mix", type=float, default=1.0,
                   help="with --data: per-sample probability of drawing from "
                        "the image dir (rest procedural); 1.0 = images only")
    t.add_argument("--steps", type=int, default=1000)
    t.add_argument("--batch", type=int, default=8)
    t.add_argument("--height", type=int, default=480)
    t.add_argument("--width", type=int, default=640)
    t.add_argument("--out", default="checkpoints")
    t.add_argument("--log-every", type=int, default=50)
    t.add_argument("--seed", type=int, default=66)
    t.add_argument("--max-matches", type=int, default=512)
    t.add_argument("--gam-ransac-iters", type=int, default=256)
    t.add_argument("--gam-max-inliers", type=int, default=512)
    t.add_argument("--lr", type=float, default=0.0,
                   help="override true LR (default: canonical*bs/64)")
    t.add_argument("--warmup", type=int, default=0,
                   help="override warmup in actual steps")
    t.add_argument("--resume", action="store_true",
                   help="continue from the newest state checkpoint in --out")
    t.add_argument("--bank-size", type=int, default=256,
                   help="procedural texture bank size")
    t.add_argument("--bank-refresh", type=int, default=0,
                   help="regenerate the procedural bank every N steps "
                        "(0 = fixed bank)")
    t.add_argument("--sensor-aug", action="store_true",
                   help="camera-realism augmentation on both views "
                        "(defocus/vignette/shot-read-noise/JPEG)")
    t.add_argument("--texture-style", choices=("mixed", "structured"),
                   default="mixed",
                   help="procedural bank family mix")
    t.add_argument("--val-every", type=int, default=0)
    t.add_argument("--tensorboard", action="store_true",
                   help="scalars (and figures) to an event file in <out>/tb")
    t.add_argument("--log-figures", action="store_true",
                   help="a val-batch match figure at each validation "
                        "(with --tensorboard and --val-every)")
    t.add_argument("--bf16", action="store_true",
                   help="bf16 compute path (params stay f32)")
    t.add_argument("--pallas", action="store_true",
                   help="the hand-written GAM kernels (K1-K5)")
    t.add_argument("--device", default="cuda")
    t.set_defaults(fn=cmd_train)

    td = sub.add_parser("train-depth",
                        help="depth-supervised (MegaDepth/ScanNet) training")
    td.add_argument("--npz-dir", required=True, help="train scene npz dir")
    td.add_argument("--root", required=True, help="dataset root dir")
    td.add_argument("--val-npz-dir", default=None, help="val scene npz dir")
    td.add_argument("--steps", type=int, default=1000)
    td.add_argument("--batch", type=int, default=2)
    td.add_argument("--imsize", type=int, default=640,
                    help="square pad size (MegaDepth protocol)")
    td.add_argument("--out", default="checkpoints_depth")
    td.add_argument("--log-every", type=int, default=50)
    td.add_argument("--val-every", type=int, default=500)
    td.add_argument("--n-val-batches", type=int, default=8)
    td.add_argument("--seed", type=int, default=66)
    td.add_argument("--max-matches", type=int, default=512)
    td.add_argument("--gam-ransac-iters", type=int, default=256)
    td.add_argument("--gam-max-inliers", type=int, default=512)
    td.add_argument("--lr", type=float, default=0.0)
    td.add_argument("--resume", action="store_true")
    td.add_argument("--min-overlap", type=float, default=0.4)
    td.add_argument("--depth-pad", type=int, default=2000)
    td.add_argument("--bf16", action="store_true",
                    help="bf16 compute path (params stay f32)")
    td.add_argument("--pallas", action="store_true",
                    help="the hand-written GAM kernels (K1-K5)")
    td.add_argument("--device", default="cuda")
    td.set_defaults(fn=cmd_train_depth)

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
    i.add_argument("--draw", default=None,
                   help="write the match figure to this PNG")
    i.add_argument("--draw-geo", default=None,
                   help="write the GAM window view to this PNG")
    i.add_argument("--seq-shard", type=int, default=0)
    common(i)
    i.set_defaults(fn=cmd_infer)

    lz = sub.add_parser("localize",
                        help="Aachen-style visual localization end-to-end")
    lz.add_argument("--nvm", default=None, help="reference NVM model "
                    "(required unless --scan-dir)")
    lz.add_argument("--database", default=None, help="COLMAP db with ids "
                    "(required unless --scan-dir)")
    lz.add_argument("--scan-dir", default=None,
                    help="InLoc-style dense mode: directory of per-db-image "
                         "npz scans (depth/K/T_w2c); replaces the NVM + "
                         "triangulation path")
    lz.add_argument("--images", required=True, help="image root dir")
    lz.add_argument("--queries", required=True,
                    help="queries_with_intrinsics.txt")
    lz.add_argument("--query-pairs", required=True,
                    help="txt: query db_image per line")
    lz.add_argument("--db-pairs", default=None,
                    help="txt of db pairs (default: covis from NVM)")
    lz.add_argument("--intrinsics-txt", default=None,
                    help="database_intrinsics.txt (Aachen v1)")
    lz.add_argument("--covis-topk", type=int, default=20)
    lz.add_argument("--ransac-thr", type=float, default=12.0)
    lz.add_argument("--out", default="localization_out")
    common(lz)
    lz.set_defaults(fn=cmd_localize)

    sl = sub.add_parser("slam",
                        help="planar SLAM over an image sequence")
    sl.add_argument("--images", required=True, help="frame directory")
    sl.add_argument("--glob", default="*.png")
    sl.add_argument("--loop-stride", type=int, default=0,
                    help=">1 adds (i, i+stride) loop-closure edges")
    sl.add_argument("--ransac-thr", type=float, default=3.0)
    sl.add_argument("--gt", default=None,
                    help="GT trajectory (npz with H [K,3,3], or txt)")
    sl.add_argument("--out", default=None, help="trajectory txt output")
    common(sl)
    sl.set_defaults(fn=cmd_slam)

    ex = sub.add_parser(
        "export",
        help="export a self-contained serving bundle (torch.export program "
             "with its weights; geoformer_tpu_torch.serving.load_bundle runs "
             "it without the model code)")
    ex.add_argument("--out", default="matcher.gfmz")
    ex.add_argument("--height", type=int, default=480)
    ex.add_argument("--width", type=int, default=640)
    ex.add_argument("--batch", type=int, default=1)
    ex.add_argument("--platforms", default=None,
                    help="the export's device, cuda or cpu (default: "
                         "--device)")
    common(ex)
    ex.set_defaults(fn=cmd_export)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
