"""Standing synthetic FIRE and ISC-HE gates, on the port.

Counterpart of scripts/fire_isc_protocol.py: the FIRE and ISC-HE datasets
are not in the repository, so corpora in their official layouts are built
from synthesized images with exact known homographies, and the port's
``cli eval fire``, ``eval isc`` and ``eval isc-cls`` run on them end to end
(JPEG decoding, resolution buckets, control-point files, per-class AUC,
ROC and EER). The builders draw from ``np.random.default_rng`` in the JAX
script's order, so the same seed gives the same classes, warps and control
points; cv2 is replaced by numpy and the port: a float64 four-point solve
(OpenCV's LU, step for step) for getPerspectiveTransform, the port's
native_warp (same convention, exact bilinear where cv2 rounds positions to
1/32 px) for warpPerspective, a separable reflect-101 Gaussian by FFT for
GaussianBlur, and eval/jpeg.encode_gray at quality 95 for imwrite. The
images differ from the JAX builders' by a small mean (pixel rounding of
the warp and the blur, and another JPEG encoder).

    python -m geoformer_tpu_torch.eval.fire_isc_protocol \\
        [--ckpt checkpoints/tpu_r3_main/params_final.npz] [--bf16 --pallas]
    python -m geoformer_tpu_torch.eval.fire_isc_protocol --build-only

The corpora (and the classification list, ``<isc-dir>/cls_pairs.txt``) go
into new temporary directories unless ``--fire-dir`` or ``--isc-dir`` name
one (an existing corpus there is reused); temporary ones are removed after
a run, kept after ``--build-only``. It prints the
JAX script's JSON record and exits 1 when a gate is missed: FIRE mAUC >=
0.99 with no failed pair, ISC AUC@3 >= 0.97, ISC-cls EER <= 0.05.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from geoformer_tpu_torch.data.native import native_warp
from geoformer_tpu_torch.data.synthetic import procedural_texture
from geoformer_tpu_torch.eval.jpeg import encode_gray


# --------------------------------------------------------- cv2 stand-ins
def perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """cv2.getPerspectiveTransform of four float32 point pairs: the 8x8
    system as OpenCV builds it (the products in float32), solved as
    OpenCV's LU solves it (partial pivoting, the back substitution
    dividing by the pivots), in float64: the same bits."""
    src = np.asarray(src, np.float32)
    dst = np.asarray(dst, np.float32)
    a = [[0.0] * 8 for _ in range(8)]
    b = [0.0] * 8
    for i in range(4):
        x, y = src[i]
        u, v = dst[i]
        a[i][0] = a[i + 4][3] = float(x)
        a[i][1] = a[i + 4][4] = float(y)
        a[i][2] = a[i + 4][5] = 1.0
        a[i][6] = float(-x * u)
        a[i][7] = float(-y * u)
        a[i + 4][6] = float(-x * v)
        a[i + 4][7] = float(-y * v)
        b[i] = float(u)
        b[i + 4] = float(v)
    for i in range(8):
        k = i
        for j in range(i + 1, 8):
            if abs(a[j][i]) > abs(a[k][i]):
                k = j
        if k != i:
            a[i], a[k] = a[k], a[i]
            b[i], b[k] = b[k], b[i]
        d = -1.0 / a[i][i]
        for j in range(i + 1, 8):
            alpha = a[j][i] * d
            for c in range(i + 1, 8):
                a[j][c] += alpha * a[i][c]
            b[j] += alpha * b[i]
    for i in range(7, -1, -1):
        s = b[i]
        for c in range(i + 1, 8):
            s -= a[i][c] * b[c]
        b[i] = s / a[i][i]
    return np.array(b + [1.0]).reshape(3, 3)


def gaussian_kernel(sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel(round(8 sigma + 1) | 1, sigma) for a float32
    image: the taps in float64, normalised, then rounded to float32."""
    n = int(np.rint(sigma * 8 + 1)) | 1
    x = np.arange(n) - (n - 1) * 0.5
    k = np.exp(-x * x / (2 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(img, (0, 0), sigma) of a float32 image: a separable
    kernel with reflect-101 borders, each pass an FFT convolution."""
    k = gaussian_kernel(sigma).astype(np.float64)
    r = len(k) // 2
    out = np.asarray(img, np.float64)
    for axis in (1, 0):
        pad = [(0, 0), (0, 0)]
        pad[axis] = (r, r)
        x = np.pad(out, pad, mode="reflect")
        n = x.shape[axis]
        nfft = 1 << int(np.ceil(np.log2(n + len(k) - 1)))
        spec = np.fft.rfft(x, nfft, axis=axis)
        kshape = [1, 1]
        kshape[axis] = -1
        spec *= np.fft.rfft(k, nfft).reshape(kshape)
        full = np.fft.irfft(spec, nfft, axis=axis)
        out = np.take(full, np.arange(2 * r, n), axis=axis)
    return out.astype(np.float32)


def warp(img: np.ndarray, H: np.ndarray) -> np.ndarray:
    """cv2.warpPerspective(img, H, (w, h)) of a float32 image onto its own
    size (bilinear, zeros outside)."""
    return native_warp(np.asarray(img, np.float32)[None],
                       np.asarray(H, np.float64)[None])[0]


def write_jpeg(path: str, img_u8: np.ndarray, quality: int = 95) -> None:
    with open(path, "wb") as f:
        f.write(encode_gray(img_u8, quality))


# ---------------------------------------------------------- FIRE corpus
def _fundus(rng, size: int) -> np.ndarray:
    """Grey fundus-like image in [0, 1]: a bright disc on black, dark
    vessel walks, a brighter optic-disc blob, speckle and mottle."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    c = size / 2.0
    r = np.hypot(yy - c, xx - c)
    disc = (r < 0.46 * size).astype(np.float32)
    base = disc * (0.55 + 0.25 * np.exp(-(r / (0.33 * size)) ** 2))

    ox = c + 0.22 * size * rng.choice([-1, 1])
    oy = c + rng.uniform(-.1, .1) * size
    vess = np.zeros((size, size), np.float32)
    for _ in range(10):
        x, y = ox, oy
        ang = rng.uniform(0, 2 * np.pi)
        wline = rng.uniform(1.5, 3.5)
        for _ in range(int(0.9 * size)):
            ang += rng.normal(0, 0.18)
            x += np.cos(ang)
            y += np.sin(ang)
            xi, yi = int(x), int(y)
            if not (0 <= xi < size and 0 <= yi < size):
                break
            w = int(np.ceil(wline))
            vess[max(0, yi - w):yi + w, max(0, xi - w):xi + w] = 1.0
    vess = gaussian_blur(vess, 1.2)
    base = base * (1.0 - 0.45 * vess)
    od = np.exp(-((yy - oy) ** 2 + (xx - ox) ** 2) / (0.04 * size) ** 2)
    base = base + 0.3 * od * disc
    base += disc * 0.06 * rng.standard_normal((size, size)).astype(np.float32)
    mot = gaussian_blur(
        rng.standard_normal((size, size)).astype(np.float32), size / 24)
    base += disc * 0.5 * mot
    return np.clip(base, 0, 1)


def _warp_mat(rng, size: int, mag: float) -> np.ndarray:
    """Perspective warp (frame to frame) by a corner jitter of ``mag`` of
    the image side."""
    src = np.array([[0, 0], [size, 0], [size, size], [0, size]], np.float32)
    jit = rng.uniform(-mag, mag, (4, 2)).astype(np.float32) * size
    return perspective_transform(src, src + jit)


def _proj(H, pts):
    ph = np.concatenate([pts, np.ones((len(pts), 1))], 1) @ H.T
    return ph[:, :2] / ph[:, 2:]


def _control_points(rng, W, size, n=10, margin=0.18):
    """n points inside image 1 whose warps stay inside image 2."""
    pts1 = []
    while len(pts1) < n:
        p = rng.uniform(margin * size, (1 - margin) * size, (1, 2))
        q = _proj(W, p)
        if (q > 0.02 * size).all() and (q < 0.98 * size).all():
            pts1.append((p[0], q[0]))
    return (np.array([a for a, _ in pts1]), np.array([b for _, b in pts1]))


FIRE_MAGS = {"S": 0.025, "P": 0.07, "A": 0.11}


def build_fire(out_dir: str, seed: int = 0, size: int = 1024,
               n_s: int = 25, n_p: int = 17, n_a: int = 7) -> int:
    """FIRE layout: images/<PAIR>_{1,2}.jpg and
    ground_truth/control_points_<PAIR>_1_2.txt ([10, 4]: x1 y1 x2 y2)."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "ground_truth"), exist_ok=True)
    counts = {"S": n_s, "P": n_p, "A": n_a}
    n = 0
    for cls, cnt in counts.items():
        for k in range(1, cnt + 1):
            pair = f"{cls}{k:02d}"
            im1 = _fundus(rng, size)
            W = _warp_mat(rng, size, FIRE_MAGS[cls])
            im2 = warp(im1, W)
            if cls == "A":
                im2 = np.clip(im2 * rng.uniform(0.8, 1.15) +
                              rng.uniform(-0.06, 0.06), 0, 1)
            p1, p2 = _control_points(rng, W, size)
            np.savetxt(os.path.join(out_dir, "ground_truth",
                                    f"control_points_{pair}_1_2.txt"),
                       np.concatenate([p1, p2], axis=1))
            for idx, im in ((1, im1), (2, im2)):
                write_jpeg(os.path.join(out_dir, "images",
                                        f"{pair}_{idx}.jpg"),
                           (im * 255).astype(np.uint8), 95)
            n += 1
    return n


# ---------------------------------------------------------- ISC corpus
def build_isc(out_dir: str, seed: int = 0, n_pairs: int = 40) -> int:
    """ISC layout: query/<name>_2.jpg, refer/<name>_1.jpg and
    gd/<name>_2-<name>_1.txt with normalised x1 y1 (query) x2 y2 (refer);
    the refer image is the warped view."""
    rng = np.random.default_rng(seed)
    for sub in ("query", "refer", "gd"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    n = 0
    for k in range(n_pairs):
        name = f"isc{k:03d}"
        h1, w1 = int(rng.choice([480, 600, 720])), int(rng.choice([640, 800]))
        q = procedural_texture(rng, (h1, w1))
        src = np.array([[0, 0], [w1, 0], [w1, h1], [0, h1]], np.float32)
        jit = (rng.uniform(-0.12, 0.12, (4, 2)) *
               np.array([[w1, h1]], np.float32)).astype(np.float32)
        h2, w2 = h1, w1
        W = perspective_transform(src, src + jit)        # query -> refer
        r = warp(q, W)
        r = np.clip(r * rng.uniform(0.75, 1.2) + rng.uniform(-0.08, 0.08),
                    0, 1)
        pts = []
        while len(pts) < 10:
            p = rng.uniform([0.1 * w1, 0.1 * h1], [0.9 * w1, 0.9 * h1], (1, 2))
            d = _proj(W, p)
            if (d > [0.02 * w2, 0.02 * h2]).all() and \
                    (d < [0.98 * w2, 0.98 * h2]).all():
                pts.append((p[0] / [w1, h1], d[0] / [w2, h2]))
        gd = np.array([np.concatenate([a, b]) for a, b in pts])
        np.savetxt(os.path.join(out_dir, "gd", f"{name}_2-{name}_1.txt"), gd)
        write_jpeg(os.path.join(out_dir, "query", f"{name}_2.jpg"),
                   (q * 255).astype(np.uint8))
        write_jpeg(os.path.join(out_dir, "refer", f"{name}_1.jpg"),
                   (r * 255).astype(np.uint8))
        n += 1
    return n


def build_isc_cls(isc_dir: str, out_txt: str, seed: int = 0) -> int:
    """Same-scene classification list from the ISC corpus: each (query,
    refer) pair is a positive; each query with the refer image of another
    scene a negative."""
    rng = np.random.default_rng(seed)
    qs = sorted(os.listdir(os.path.join(isc_dir, "query")))
    names = [q[:-len("_2.jpg")] for q in qs]
    lines = []
    for i, n in enumerate(names):
        q = os.path.join(isc_dir, "query", f"{n}_2.jpg")
        lines.append(f"{q} {os.path.join(isc_dir, 'refer', n + '_1.jpg')} 1")
        j = (i + int(rng.integers(1, len(names)))) % len(names)
        lines.append(
            f"{q} {os.path.join(isc_dir, 'refer', names[j] + '_1.jpg')} 0")
    with open(out_txt, "w") as f:
        f.write("\n".join(lines) + "\n")
    return len(lines)


# ---------------------------------------------------------------- runner
def gate(rec: dict) -> bool:
    """The standing gates on a record: FIRE mAUC >= 0.99 with no failed
    pair, ISC AUC@3 >= 0.97, ISC-cls EER <= 0.05 (each where present)."""
    ok = True
    if "fire" in rec:
        ok &= rec["fire"].get("mAUC", 0.0) >= 0.99
        ok &= rec["fire"].get("failed", 1) == 0
    if "isc" in rec:
        ok &= (rec["isc"].get("auc") or [0])[0] >= 0.97
    if "isc_cls" in rec:
        ok &= rec["isc_cls"].get("eer", 1.0) <= 0.05
    return bool(ok)


def run_eval(benchmark: str, data: str, args, scratch: str) -> dict:
    """``cli eval <benchmark>`` in this process; its --json-out record
    with the wall-clock seconds."""
    from geoformer_tpu_torch import cli

    json_out = os.path.join(scratch, f"eval_{benchmark}.json")
    argv = ["eval", benchmark, "--data", data, "--ckpt", args.ckpt,
            "--json-out", json_out, "--device", args.device]
    argv += [f"--{f}" for f in ("bf16", "pallas") if getattr(args, f)]
    print("running: cli " + " ".join(argv), flush=True)
    t0 = time.time()
    cli.main(argv)
    with open(json_out) as f:
        out = json.load(f)
    os.remove(json_out)
    out["wall_clock_s"] = round(time.time() - t0, 1)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="geoformer_tpu_torch.eval.fire_isc_protocol",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt",
                    default="checkpoints/tpu_r3_main/params_final.npz")
    ap.add_argument("--fire-dir", default=None,
                    help="FIRE corpus directory (default: a new temporary "
                         "one)")
    ap.add_argument("--isc-dir", default=None,
                    help="ISC corpus directory (default: a new temporary "
                         "one)")
    ap.add_argument("--seed", type=int, default=20260820)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--pallas", action="store_true")
    ap.add_argument("--build-only", action="store_true")
    ap.add_argument("--skip-fire", action="store_true")
    ap.add_argument("--skip-isc", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    made = []
    for flag, prefix in (("fire_dir", "fire_synth_"), ("isc_dir",
                                                       "isc_synth_")):
        if getattr(args, flag) is None:
            setattr(args, flag, tempfile.mkdtemp(prefix=prefix))
            made.append(getattr(args, flag))
    try:
        t0 = time.time()
        if not os.path.isdir(os.path.join(args.fire_dir, "images")):
            n = build_fire(args.fire_dir, seed=args.seed)
            print(f"built FIRE corpus: {n} pairs at {args.fire_dir} "
                  f"({time.time() - t0:.1f} s)", flush=True)
        t0 = time.time()
        if not os.path.isdir(os.path.join(args.isc_dir, "query")):
            n = build_isc(args.isc_dir, seed=args.seed + 1)
            print(f"built ISC corpus: {n} pairs at {args.isc_dir} "
                  f"({time.time() - t0:.1f} s)", flush=True)
        cls_txt = os.path.join(args.isc_dir, "cls_pairs.txt")
        if not os.path.exists(cls_txt):
            build_isc_cls(args.isc_dir, cls_txt, seed=args.seed + 2)
        if args.build_only:
            made.clear()
            return
        rec = {"protocol": "fire_isc_synth", "seed": args.seed,
               "config": {"bf16": args.bf16, "pallas": args.pallas}}
        scratch = tempfile.mkdtemp(prefix="fire_isc_eval_")
        made.append(scratch)
        if not args.skip_fire:
            rec["fire"] = run_eval("fire", args.fire_dir, args, scratch)
        if not args.skip_isc:
            rec["isc"] = run_eval("isc", args.isc_dir, args, scratch)
            rec["isc_cls"] = run_eval("isc-cls", cls_txt, args, scratch)
        rec["gate_pass"] = gate(rec)
        print(json.dumps(rec))
        if not rec["gate_pass"]:
            sys.exit(1)
    finally:
        for d in made:
            shutil.rmtree(d, ignore_errors=True)


if __name__ == "__main__":
    main()
