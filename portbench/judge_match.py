"""The comparison that decides ``correct`` in the matching cells.

The matcher runs each batch padded to its bucket (multiples of 64 pixels,
zeros, the padded coarse cells masked out); the reference pads and masks
the same. The program's decisions are discrete: which cells match at each
of the two coarse passes, the RANSAC fit between them, and which fine cell
of each window pair wins. So the plain reference (reference/model.py, float32,
TF32 off) follows the program's own decisions stage by stage and judges
each against its own confidences, as a served language model's tokens are
judged by the reference's logits, and holds the program's continuous
features against its own:

1. the reference's backbone and coarse transformer from the images; the
   program's features after the transformer (copied to the host by the
   judged calls) are held against them (``feat_rel``); each of the
   program's first-pass matches (i, j) is judged by how far the
   reference's confidence at (i, j) lies below the best of its row and of
   its column, and below the threshold (``coarse_gap``, natural log);
2. RANSAC on the program's first-pass matches with the same uniforms (the
   program's draws, which are inputs: a generator on the device seeded 0
   for each call, as the matcher draws them); its fit against the
   program's (``ransac_has_H``, ``ransac_inliers``, ``H_px``) and into the
   reference's GAM, whose output the program's is held against
   (``gam_rel``);
3. the second pass as the first (``coarse_gap``);
4. the fine stage at the program's second-pass matches; each returned
   match is judged by how far the reference's fine confidence at the
   window cells it names lies below that window pair's best and below the
   fine threshold, and each second-pass match the program dropped by how
   far the reference's best clears the threshold (``fine_gap``).

The numbers of a run, over its judged calls:

- ``feat_rel``, ``gam_rel``: the mean over the pairs of ||program -
  reference|| / ||reference|| of those features, a pair's two images
  together (a pair whose features are missing reads 1e30);
- ``count_rel``: the largest over the pairs and the three decisions of
  |the program's count - the reference's| / max(the reference's, 8); the
  reference's count of a coarse pass is its mutual nearest neighbours
  above the threshold, up to the capacity, of the fine stage the
  second-pass matches whose best fine confidence clears the fine
  threshold;
- ``coarse_gap_p99``, ``fine_gap_p99``: the 99th percentiles of the gaps;
- ``ransac_has_H`` (pairs whose has_H differs), ``ransac_inliers`` (the
  largest difference of inlier counts), ``H_px`` (the largest mean
  distance of the image corners under the two fits, pairs with both);
- ``answers``: returned answers that do not read back as the forward's own
  (matches out of their windows, counts, confidences or geometry that
  differ): an exact comparison;
- ``fine_err``: the mean absolute log ratio of the program's fine
  confidences to the reference's at the same cells;
- ``judged_coarse``, ``judged_fine``: the matches judged.

Which numbers a cell compares, and their limits, its file under
portbench/limits/ says (PERF.md gives the readings each was set from); the
others are printed for the record. The reference reads the program's
outputs only to judge them, and recomputes everything else from the images
and the checkpoint. It runs one call of eight pairs at a time, in blocks of
``block`` pairs.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import model as ref

EPS = 1e-30


def _log(x):
    return torch.log(torch.clamp(x, min=EPS))


def _coarse(conf, i_ids, j_ids, valid, thr):
    """Gaps of one pass's program matches under the reference's confidence
    conf [b, L, S], and the reference's own count of matches."""
    b = conf.shape[0]
    bi = torch.arange(b, device=conf.device)[:, None]
    c = conf[bi, i_ids, j_ids]                                  # [b, M]
    row = conf.amax(dim=2).gather(1, i_ids)
    col = conf.amax(dim=1).gather(1, j_ids)
    gap = torch.maximum(_log(row) - _log(c), _log(col) - _log(c))
    gap = torch.maximum(gap, math.log(thr) - _log(c))
    v = valid
    # the reference's own count of mutual matches above the threshold
    rb, rj = conf.max(dim=2)
    mutual = conf.amax(dim=1).gather(1, rj) == rb
    n_ref = ((rb > thr) & mutual).sum(-1)
    return gap[v], n_ref


def _count_rel(n_prog, n_ref):
    return ((n_prog - n_ref).abs().float()
            / n_ref.clamp(min=8).float()).tolist()


def _rel(prog, ref_parts, device):
    """Per pair ||program - reference|| / ||reference|| over the pair's
    parts (image 0, image 1), each [b, ...]; None where the program's
    parts are missing."""
    if prog is None:
        return None
    d = n = 0.0
    for p, r in zip(prog, ref_parts):
        p = p.to(device, torch.float32).reshape(r.shape[0], -1)
        r = r.reshape(r.shape[0], -1)
        d = d + ((p - r) ** 2).sum(1)
        n = n + (r * r).sum(1)
    return (d / n.clamp(min=EPS)).sqrt().tolist()


def _add_rel(out, key, got, b):
    out[key] += got if got is not None else [1e30] * b


def _judge_pass(conf, prog, key, sl, thr, out) -> None:
    gap, n_ref = _coarse(conf, prog[f"{key}_i"][sl], prog[f"{key}_j"][sl],
                         prog[f"{key}_valid"][sl], thr)
    out["coarse_gap"] += gap.tolist()
    n_prog = prog[f"{key}_valid"][sl].sum(-1)
    n_ref = n_ref.clamp(max=prog[f"{key}_i"].shape[1])
    out["count_rel"] += _count_rel(n_prog, n_ref)


def judge_call(W, img0, img1, uniforms, prog, feats, answers, cfg,
               quant: int, block: int = 2) -> Dict[str, List[float]]:
    """Judge one match_batch call.

    img0/img1: [B, H, W] on the device; uniforms: the call's RANSAC draws
    [B, iters, capacity]; prog: the forward's outputs (m1_i, m1_j, m1_valid,
    m2_i, m2_j, m2_valid, fine_valid, fine_conf, H, has_H, num_inliers);
    feats: the forward's features by submodule
    ("loftr_coarse" and "geo_module": (image 0's, image 1's), each [B, L,
    C]), either of them missing; answers: what
    match_batch returned, one (mk0, mk1, mc, geo) per pair; quant: the
    matcher's bucket. Returns lists of per-item figures."""
    P = W["params"]
    B, Hh, Ww = img0.shape
    img0, img1, mask = _bucket(img0, img1, quant)
    hw = (img0.shape[1] // ref.COARSE, img0.shape[2] // ref.COARSE)
    thr_c, thr_f = cfg["match"]["thr"], cfg["fine_match"]["thr"]
    geo = ref.geometry(prog["m1_i"], prog["m1_j"], prog["m1_valid"], hw,
                       uniforms, cfg["geo"]["ransac_thr"],
                       cfg["geo"]["min_matches"])
    out = {k: [] for k in ("coarse_gap", "fine_gap", "fine_err", "answers",
                           "count_rel", "ransac_inliers", "ransac_has_H",
                           "H_px", "feat_rel", "gam_rel")}
    # a forward that saw another batch than the call's has no features
    feats = {name: parts for name, parts in feats.items()
             if all(t.shape[0] == B for t in parts)}
    dev = img0.device
    both = geo.has_H & prog["has_H"]
    corners = torch.tensor([[0, 0], [0, Hh - 1], [Ww - 1, 0],
                            [Ww - 1, Hh - 1]], dtype=torch.float32,
                           device=img0.device)
    dist = (ref.warp_points(corners, geo.H) - ref.warp_points(
        corners, prog["H"])).norm(dim=-1).mean(-1)
    out["H_px"] += dist[both].tolist()
    out["ransac_has_H"] += (geo.has_H != prog["has_H"]).float().tolist()
    out["ransac_inliers"] += (geo.num_inliers - prog["num_inliers"]).abs() \
        .float().tolist()
    for s in range(0, B, block):
        sl = slice(s, s + block)
        nb = min(block, B - s)
        with torch.no_grad():
            m = mask[sl]
            f = ref.features(W, img0[sl], img1[sl], m, m)
            _add_rel(out, "feat_rel", _rel(_part(feats, "loftr_coarse",
                                                 sl), (f.f0, f.f1), dev), nb)
            _judge_pass(ref.dual_softmax(f.f0, f.f1, m0=m, m1=m), prog, "m1",
                        sl, thr_c, out)
            g0, g1 = ref.gam(P, f.cnn0, f.cnn1,
                             ref.Geometry(*(x[sl] for x in geo)),
                             cfg["geo"]["max_inliers"])
            _add_rel(out, "gam_rel", _rel(_part(feats, "geo_module", sl),
                                          (g0, g1), dev), nb)
            _judge_pass(ref.dual_softmax(g0, g1, m0=m, m1=m), prog, "m2", sl,
                        thr_c, out)
            fc = ref.fine_confidence(P, f.fine0, f.fine1, g0, g1,
                                     prog["m2_i"][sl], prog["m2_j"][sl],
                                     hw[1])
            for k in range(fc.shape[0]):
                _fine(fc[k], prog, s + k, answers[s + k], hw[1], thr_f, out)
        del f, g0, g1, fc
    return out


def _bucket(img0, img1, quant: int):
    """The images as the matcher runs them: each batch zero-padded at the
    bottom and right to multiples of ``quant`` pixels, with the coarse
    cells of the images themselves marked valid ([B, L] masks)."""
    b, h, w = img0.shape
    hp, wp = -(-h // quant) * quant, -(-w // quant) * quant
    pad = (0, wp - w, 0, hp - h)
    mask = torch.zeros((b, hp // ref.COARSE, wp // ref.COARSE),
                       device=img0.device)
    mask[:, :h // ref.COARSE, :w // ref.COARSE] = 1.0
    return F.pad(img0, pad), F.pad(img1, pad), mask.reshape(b, -1)


def _part(feats, name, sl):
    got = feats.get(name)
    return None if got is None else tuple(t[sl] for t in got)


def _fine(fc, prog, p, answer, grid_w, thr, out) -> None:
    """Judge pair p's returned fine matches under the reference's fine
    confidence fc [M, 25, 25] at the program's second-pass slots."""
    mk0, mk1, mc = (torch.as_tensor(np.asarray(a), device=fc.device)
                    for a in answer[:3])
    v2 = prog["m2_valid"][p]
    kept = prog["fine_valid"][p]
    best = fc.reshape(fc.shape[0], -1).amax(-1)
    out["count_rel"] += _count_rel(kept.sum()[None],
                                   ((best > thr) & v2).sum()[None])
    drop = v2 & ~kept
    out["fine_gap"] += torch.clamp(_log(best[drop]) - math.log(thr),
                                   min=0).tolist()
    slots = torch.nonzero(kept).flatten()
    geo = answer[3]
    if slots.numel() != mk0.shape[0] or \
            geo["has_H"] != bool(prog["has_H"][p]) or \
            geo["num_inliers"] != int(prog["num_inliers"][p]) or \
            not np.array_equal(geo["H"], prog["H"][p].cpu().numpy()) or \
            not torch.equal(mc.float(), prog["fine_conf"][p][slots]
                            .float()):
        out["answers"].append(1.0)
        return
    r = ref.WINDOW // 2
    cells = []
    for mk, ids in ((mk0, prog["m2_i"][p][slots]),
                    (mk1, prog["m2_j"][p][slots])):
        corner = ref.cell_coords(ids, grid_w)
        off = (mk.float() - corner) / ref.FINE + r          # window (x, y)
        whole = torch.round(off)
        ok = ((off - whole).abs() < 1e-3).all(-1) & (whole >= 0).all(-1) \
            & (whole <= 2 * r).all(-1)
        cells.append((whole[:, 1] * ref.WINDOW + whole[:, 0]).long()
                     .clamp(0, ref.WINDOW ** 2 - 1))
        if not bool(ok.all()):
            out["answers"].append(float((~ok).sum()))
            return
    c = fc[slots, cells[0], cells[1]]
    gap = torch.maximum(_log(best[slots]) - _log(c), math.log(thr) - _log(c))
    out["fine_gap"] += gap.tolist()
    out["fine_err"] += (_log(mc.float()) - _log(c)).abs().tolist()
    out["answers"].append(0.0)


def reduce(figs: Dict[str, List[float]]) -> Dict[str, float]:
    """The numbers a run reports from its judged calls."""
    def mean(k):
        return float(np.mean(figs[k])) if figs[k] else 0.0

    def mx(k):
        return max(figs[k]) if figs[k] else 0.0

    def p99(k):
        return float(np.percentile(figs[k], 99)) if figs[k] else 0.0

    return {"feat_rel": mean("feat_rel"), "gam_rel": mean("gam_rel"),
            "fine_err": mean("fine_err"), "count_rel": mx("count_rel"),
            "coarse_gap_p99": p99("coarse_gap"),
            "fine_gap_p99": p99("fine_gap"),
            "ransac_has_H": float(sum(figs["ransac_has_H"])),
            "ransac_inliers": mx("ransac_inliers"), "H_px": mx("H_px"),
            "answers": float(sum(figs["answers"])),
            "judged_coarse": float(len(figs["coarse_gap"])),
            "judged_fine": float(len(figs["fine_err"]))}
