"""The standing localization gate, on the port: end-to-end accuracy on a
rendered scene.

Counterpart of scripts/localize_protocol.py. Renders a non-planar
3-plane scene (back wall, slanted floor, side wall: textured quads
composited far to near by data/planes.render_planes), writes the
Aachen-style inputs (NVM posed db model, COLMAP database,
queries_with_intrinsics.txt, the query pair list; JPEG images through
eval/jpeg.encode_gray), runs ``cli localize`` with the trained matcher in a
subprocess (match -> quantize -> triangulate -> PnP) and scores the query
poses against the ground truth at the Aachen recall thresholds (0.25 m /
2 deg, 0.5 m / 5 deg, 5 m / 10 deg). It passes (exit 0) iff every query
is within 5 m and 10 deg, as the JAX script.

    python -m geoformer_tpu_torch.eval.localize_protocol [--ckpt ...] \\
        [--bf16 --pallas] [--out DIR] [--scans] [--device cpu]

The same scene, cameras, model files and pairs come from ``--seed``
(20260819) as in the JAX script. With ``--scans`` the db images' depth
maps are written too (npz of depth, K, T_w2c, as eval/inloc.load_db_scans
reads them) and ``cli localize --scan-dir`` (the InLoc-style dense mode)
runs in place of the SfM mode. Without ``--out`` the run works in a new
temporary directory, removed after it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent.parent
HW = (480, 640)
K = np.array([[520.0, 0, 320], [0, 520.0, 240], [0, 0, 1]])
THRESHOLDS = ((0.25, 2.0), (0.5, 5.0), (5.0, 10.0))
# The JAX record (RESULTS.md, round 5): recall 4/4 at every threshold,
# median 6.4 cm / 0.40 deg.
JAX_RECORD = {"recall@5m,10deg": 1.0, "median_center_err_m": 0.064,
              "median_rot_err_deg": 0.40}
# The port on a CPU: this module's run with --device cpu (f32), on the
# same scene, in the SfM mode and with --scans.
CPU_REF = {
    "sfm": {"recall@5m,10deg": 1.0, "median_center_err_m": 0.0495,
            "median_rot_err_deg": 0.333},
    "dense": {"recall@5m,10deg": 1.0, "median_center_err_m": 0.0086,
              "median_rot_err_deg": 0.0558},
}


def build_scene(out: str, seed: int = 20260819, n_db: int = 8,
                n_query: int = 4, scans: bool = False) -> dict:
    """Render the scene and write the localization inputs under ``out``
    (images/, model.nvm, db.db, queries.txt, query_pairs.txt; with
    ``scans`` also scans/<db name>.npz). Returns {'db': {name: T_w2c},
    'query': {name: T_w2c}}; the draws are the JAX script's, in its
    order."""
    from geoformer_tpu_torch.data.native import native_textures
    from geoformer_tpu_torch.data.planes import look_at, render_planes
    from geoformer_tpu_torch.eval.colmap_io import ColmapDatabase
    from geoformer_tpu_torch.eval.jpeg import encode_gray
    from geoformer_tpu_torch.eval.sfm_localize import rotmat2qvec

    rng = np.random.default_rng(seed)
    H, W = HW
    # scene: back wall (z=8), slanted floor, left wall; units are meters
    tex = np.asarray(native_textures(3, 512, 768, seed))
    planes = [
        (np.array([-5.0, -3.0, 8.0]), np.array([10.0, 0, 0]),
         np.array([0, 6.0, 0]), tex[0]),
        (np.array([-5.0, 2.2, 2.0]), np.array([10.0, 0, 0]),
         np.array([0, 1.2, 6.0]), tex[1]),
        (np.array([-4.5, -3.0, 2.0]), np.array([0, 0, 6.0]),
         np.array([0, 6.0, 0]), tex[2]),
    ]
    # cameras: a db arc and interleaved held-out queries
    target = np.array([0.0, 0.0, 8.0])
    db_cams = {}
    for i in range(n_db):
        x = -2.1 + 4.2 * i / max(n_db - 1, 1)
        c = np.array([x, rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.4)])
        db_cams[f"db{i:02d}.jpg"] = look_at(
            c, target + np.array([rng.uniform(-0.5, 0.5),
                                  rng.uniform(-0.3, 0.3), 0]))
    q_cams = {}
    for i in range(n_query):
        x = -1.6 + 3.2 * i / max(n_query - 1, 1)
        c = np.array([x + 0.25, rng.uniform(-0.25, 0.25),
                      0.35 + rng.uniform(0, 0.25)])
        q_cams[f"q{i:02d}.jpg"] = look_at(
            c, target + np.array([rng.uniform(-0.4, 0.4), 0, 0]))

    img_dir = os.path.join(out, "images")
    os.makedirs(img_dir, exist_ok=True)
    if scans:
        os.makedirs(os.path.join(out, "scans"), exist_ok=True)
    for name, T in {**db_cams, **q_cams}.items():
        im, depth = render_planes(K, T, planes, HW, return_depth=True)
        with open(os.path.join(img_dir, name), "wb") as f:
            f.write(encode_gray((im * 255).astype(np.uint8)))
        if scans and name in db_cams:
            np.savez(os.path.join(out, "scans", name[:-4] + ".npz"),
                     depth=depth, K=K, T_w2c=T)

    # 3D points for the NVM tracks (plane grid samples, visibility-checked)
    pts = np.asarray([origin + s * e1 + t * e2
                      for origin, e1, e2, _ in planes
                      for s in np.linspace(0.05, 0.95, 8)
                      for t in np.linspace(0.05, 0.95, 6)])

    def project(T, X):
        pc = X @ T[:3, :3].T + T[:3, 3]
        uv = pc @ K.T
        return uv[:, :2] / uv[:, 2:], pc[:, 2]

    # NVM (posed db model) and COLMAP database
    with open(os.path.join(out, "model.nvm"), "w") as f:
        f.write("NVM_V3\n\n")
        f.write(f"{len(db_cams)}\n")
        for n, T in db_cams.items():
            R = T[:3, :3]
            c = -R.T @ T[:3, 3]
            q = rotmat2qvec(R)
            f.write(f"./{n} {K[0, 0]} {' '.join(map(str, q))} "
                    f"{' '.join(map(str, c))} 0 0\n")
        f.write("\n")
        vis = []
        for pi, X in enumerate(pts):
            track = []
            for ii, T in enumerate(db_cams.values()):
                uv, z = project(T, X[None])
                if z[0] > 0.2 and 0 < uv[0, 0] < W and 0 < uv[0, 1] < H:
                    track.append((ii, pi, uv[0, 0], uv[0, 1]))
            if len(track) >= 2:
                vis.append((X, track))
        f.write(f"{len(vis)}\n")
        for X, track in vis:
            meas = " ".join(f"{i} {fi} {u} {v}" for i, fi, u, v in track)
            f.write(f"{' '.join(map(str, X))} 128 128 128 "
                    f"{len(track)} {meas}\n")

    db_path = os.path.join(out, "db.db")
    if os.path.exists(db_path):
        os.remove(db_path)
    db = ColmapDatabase(db_path)
    for n in db_cams:
        cid = db.add_camera(1, W, H, [K[0, 0], K[1, 1], K[0, 2], K[1, 2]])
        db.add_image(n, cid)
    db.close()

    with open(os.path.join(out, "queries.txt"), "w") as f:
        for n in q_cams:
            f.write(f"{n} PINHOLE {W} {H} {K[0, 0]} {K[1, 1]} "
                    f"{K[0, 2]} {K[1, 2]}\n")
    with open(os.path.join(out, "query_pairs.txt"), "w") as f:
        for qn, Tq in q_cams.items():
            cq = -Tq[:3, :3].T @ Tq[:3, 3]
            byd = sorted(db_cams, key=lambda n: np.linalg.norm(
                (-db_cams[n][:3, :3].T @ db_cams[n][:3, 3]) - cq))
            for n in byd[:4]:
                f.write(f"{qn} {n}\n")
    return {"db": db_cams, "query": q_cams}


def localize_command(out: str, ckpt: str, device: str = "cuda",
                     bf16: bool = False, pallas: bool = False,
                     scans: bool = False) -> list:
    """The ``cli localize`` command of the protocol on the scene at
    ``out``, writing out/run/poses.txt (SfM mode, or with ``scans`` the
    dense mode on out/scans)."""
    mode = (["--scan-dir", os.path.join(out, "scans")] if scans else
            ["--nvm", os.path.join(out, "model.nvm"), "--database",
             os.path.join(out, "db.db")])
    cmd = [sys.executable, "-m", "geoformer_tpu_torch.cli", "localize",
           *mode, "--images", os.path.join(out, "images"),
           "--queries", os.path.join(out, "queries.txt"),
           "--query-pairs", os.path.join(out, "query_pairs.txt"),
           "--out", os.path.join(out, "run"), "--ckpt",
           os.path.abspath(ckpt), "--imsize", "480", "--covis-topk", "3",
           "--device", device]
    return cmd + ["--bf16"] * bf16 + ["--pallas"] * pallas


def score(poses_path: str, q_cams: dict, seed: int, n_db: int,
          scans: bool = False) -> dict:
    """The JAX script's record for the poses at ``poses_path`` against the
    ground-truth query poses ``q_cams``."""
    from geoformer_tpu_torch.eval.sfm_localize import qvec2rotmat

    est = {}
    with open(poses_path) as f:
        for line in f:
            p = line.split()
            est[p[0]] = (np.asarray(p[1:5], float), np.asarray(p[5:8], float))
    rows = []
    for qn, Tq in q_cams.items():
        if qn not in est:
            rows.append((qn, np.inf, np.inf))
            continue
        qv, tv = est[qn]
        R_est = qvec2rotmat(qv)
        rot_err = np.rad2deg(np.arccos(np.clip(
            (np.trace(R_est.T @ Tq[:3, :3]) - 1) / 2, -1, 1)))
        c_est = -R_est.T @ tv
        c_gt = -Tq[:3, :3].T @ Tq[:3, 3]
        rows.append((qn, float(np.linalg.norm(c_est - c_gt)), float(rot_err)))
        print(f"{qn}: center err {rows[-1][1]:.3f} m, rot {rot_err:.2f} deg",
              flush=True)
    recall = [float(np.mean([(d <= dm and r <= rd) for _, d, r in rows]))
              for dm, rd in THRESHOLDS]
    return {"protocol": "localize_synthetic_3plane" + ("_scans" * scans),
            "seed": seed, "n_db": n_db, "n_query": len(q_cams),
            "recall@0.25m,2deg": recall[0], "recall@0.5m,5deg": recall[1],
            "recall@5m,10deg": recall[2],
            "median_center_err_m": float(np.median([d for _, d, _ in rows])),
            "median_rot_err_deg": float(np.median([r for _, _, r in rows]))}


def passed(rec: dict) -> bool:
    return rec["recall@5m,10deg"] == 1.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=str(
        REPO / "checkpoints" / "tpu_r3_main" / "params_final.npz"))
    ap.add_argument("--out", default=None,
                    help="work directory (default: a temporary one)")
    ap.add_argument("--seed", type=int, default=20260819)
    ap.add_argument("--n-db", type=int, default=8)
    ap.add_argument("--n-query", type=int, default=4)
    ap.add_argument("--scans", action="store_true",
                    help="the dense mode (cli localize --scan-dir)")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--pallas", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    out = args.out or tempfile.mkdtemp(prefix="loc_protocol_")
    try:
        cams = build_scene(out, args.seed, args.n_db, args.n_query,
                           scans=args.scans)
        print(f"rendered {len(cams['db'])} db + {len(cams['query'])} "
              "query images", flush=True)
        cmd = localize_command(out, args.ckpt, args.device, args.bf16,
                               args.pallas, scans=args.scans)
        print("running:", " ".join(cmd), flush=True)
        r = subprocess.run(cmd, cwd=REPO)
        if r.returncode:
            return r.returncode
        rec = score(os.path.join(out, "run", "poses.txt"), cams["query"],
                    args.seed, len(cams["db"]), scans=args.scans)
    finally:
        if args.out is None:
            shutil.rmtree(out, ignore_errors=True)
    print(json.dumps(rec))
    return 0 if passed(rec) else 1


if __name__ == "__main__":
    sys.exit(main())
