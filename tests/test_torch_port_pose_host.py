"""The port's host pose estimator (geometry/five_point.py, eval/pose.py)
against OpenCV and the JAX package's cv2 loop, on the CPU.

- The 5-point solver on exactly 5 noise-free correspondences (20 seeded
  5-tuples): after unit-Frobenius normalization, up to sign and order,
  its solution set is cv2.findEssentialMat's stacked one within 1e-6, and
  the true E is in the set within 1e-8.
- find_essential_mat reproduces cv2's RANSAC draws (cv::RNG seeded with
  2**64 - 1, subsets of distinct indices) and its stopping rule: on
  noisy sets with outliers its E is cv2's up to sign within 1e-9 and its
  inlier mask equals cv2's.
- recover_pose against cv2.recoverPose on cv2's E, with a partial mask
  and points behind a camera among the inputs, and without a mask: equal
  count and mask, R and t within 1e-9.
- pose_error_for_pair against the JAX package's (cv2) on the twelve
  two-view sets of eval/synthetic.POSE_SETS (300 points, outliers 0/20/40
  %, noise 0/0.5/1 px, rotations 4-14 degrees): equal inlier masks (so the
  counts within 5 %), max(R, t) error within 1 degree of cv2's (here
  within 1e-3: cv2's polynomial roots are ~1e-9 off on noise-free sets,
  which arccos near 1 turns into ~1e-4 degrees),
  and on the noise-free sets R error under 0.01 and t error under 0.05
  degrees; fewer than 5 points give (inf, inf, []).
- run_depth_validation(pose_backend="host") against the JAX loop's host
  branch: a stub val step hands both the same matches (2 batches of 4
  pairs, padded, one pair with 3 valid matches): the AUCs within 0.02,
  here equal to 1e-6, and the precision equal.
- the same on the depth gate's own 32 pairs of 512 matches
  (data/depth_gate_matches.npz): AUCs equal to 1e-6, masks equal, the
  gate's CPU references reproduced.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402

from geoformer_tpu.eval import pose as jpose  # noqa: E402
from geoformer_tpu.train import depth_loop as jloop  # noqa: E402
from geoformer_tpu_torch.eval import pose as ppose  # noqa: E402
from geoformer_tpu_torch.eval.synthetic import (  # noqa: E402
    POSE_SETS,
    five_tuples,
    pose_sets,
    rotation,
    two_view,
)
from geoformer_tpu_torch.geometry import five_point as fp  # noqa: E402
from geoformer_tpu_torch.train import depth_loop as ploop  # noqa: E402
from torch_port_util import one_torch_thread  # noqa: E402,F401


def _normalized(uv0, uv1, K):
    Kinv = np.linalg.inv(K)
    h = lambda uv: (np.c_[uv, np.ones(len(uv))] @ Kinv.T)[:, :2]  # noqa
    return h(uv0), h(uv1)


def _unit(E):
    return E / np.linalg.norm(E)


def _gap(A, B):
    """Largest distance of a matrix of A to its nearest of B, up to sign."""
    return max(min(min(np.abs(a - b).max(), np.abs(a + b).max()) for b in B)
               for a in A)


def test_five_point_solutions_are_cv2s():
    for x1, x2, E_true in five_tuples(20, 20):
        want, mask = cv2.findEssentialMat(x1, x2, np.eye(3),
                                          method=cv2.RANSAC)
        want = [_unit(e) for e in want.reshape(-1, 3, 3)]
        E, valid = fp.essential_five_point(x1[None], x2[None])
        got = E[0][valid[0]]
        assert len(got) == len(want)
        np.testing.assert_allclose(np.linalg.norm(got, axis=(1, 2)), 1.0,
                                   atol=1e-12)
        assert _gap(want, got) < 1e-6 and _gap(got, want) < 1e-6
        assert _gap([E_true], got) < 1e-8
        # exactly 5 points: every solution stacked, an all-ones mask
        stacked, m, iters = fp.find_essential_mat(x1, x2, 1e-3)
        assert stacked.shape == (3 * len(want), 3) and iters == 0
        np.testing.assert_array_equal(m, mask)


def test_rotation_is_cv2s_rodrigues():
    for w in ([0.0, 0.0, 0.0], [0.1, -0.2, 0.3], [1.0, 2.0, -0.5]):
        np.testing.assert_allclose(rotation(w), cv2.Rodrigues(
            np.array(w))[0], rtol=0, atol=1e-12)


def test_cv_rng_sequence():
    """cv::RNG(2**64 - 1): the first outputs of its multiply-with-carry
    step, and uniform() as next() mod the range."""
    rng = fp.CvRNG()
    s, want = (1 << 64) - 1, []
    for _ in range(5):
        s = ((s & 0xFFFFFFFF) * 4164903690 + (s >> 32)) % (1 << 64)
        want.append(s & 0xFFFFFFFF)
    assert [rng.next() for _ in range(5)] == want
    assert fp.CvRNG(0).state == 0xFFFFFFFF
    r = fp.CvRNG(12345)
    a = fp.CvRNG(12345).next() % 7 + 3
    assert r.uniform(3, 10) == a and r.uniform(4, 4) == 4
    sub = fp.draw_subset(fp.CvRNG(), 6)
    assert len(set(sub)) == 5 and all(0 <= i < 6 for i in sub)


@pytest.mark.parametrize("k", [1, 4, 8])
def test_ransac_reproduces_cv2(k):
    uv0, uv1, K, _ = pose_sets(3)[k]
    x1, x2 = _normalized(uv0, uv1, K)
    thr = 0.5 / 420
    want_E, want_mask = cv2.findEssentialMat(
        x1, x2, np.eye(3), threshold=thr, prob=0.99999, method=cv2.RANSAC)
    E, mask, iters = fp.find_essential_mat(x1, x2, thr, prob=0.99999)
    assert E.shape == (3, 3) and mask.dtype == np.uint8
    np.testing.assert_array_equal(mask, want_mask)
    assert _gap([_unit(E)], [_unit(want_E)]) < 1e-9
    assert 0 < iters <= fp.MAX_ITERS
    assert fp.find_essential_mat(x1[:4], x2[:4], thr) == (None, None, 0)


def test_ransac_update_num_iters():
    assert fp.ransac_update_num_iters(0.99999, 0.0, 5, 1000) == 0
    assert fp.ransac_update_num_iters(0.99999, 0.9, 5, 1000) == 1000
    want = np.log(1e-5) / np.log(1 - 0.7 ** 5)
    assert fp.ransac_update_num_iters(0.99999, 0.3, 5, 1000) == round(want)
    assert fp.ransac_update_num_iters(0.99999, 0.3, 5, 40) == 40


def _behind(rng, K, R, t, n):
    """n correspondences of points behind camera 0 (z < 0)."""
    X = rng.uniform([-2, -2, -9], [2, 2, -4], (n, 3))
    uv0 = (X @ K.T)
    uv1 = (X @ R.T + t) @ K.T
    return uv0[:, :2] / uv0[:, 2:], uv1[:, :2] / uv1[:, 2:]


@pytest.mark.parametrize("with_mask", [True, False])
def test_recover_pose_is_cv2s(with_mask):
    rng = np.random.default_rng(5)
    uv0, uv1, K, T = two_view(rng, 200, 0.2, 0.5, 9.0)
    b0, b1 = _behind(rng, K, T[:3, :3], T[:3, 3], 25)
    x1, x2 = _normalized(np.r_[uv0, b0], np.r_[uv1, b1], K)
    E, mask = cv2.findEssentialMat(x1, x2, np.eye(3), threshold=1e-3,
                                   prob=0.999, method=cv2.RANSAC)
    mask = mask.copy()
    mask[rng.random(len(mask)) < 0.3] = 0            # a partial mask
    kw = {"mask": mask.copy()} if with_mask else {}
    n, R, t, m = cv2.recoverPose(E, x1, x2, np.eye(3), 1e9, **kw)[:4]
    got = fp.recover_pose(E, x1, x2, 1e9, **kw)
    assert got[0] == n and n > 50
    np.testing.assert_array_equal(got[3], m)
    np.testing.assert_allclose(got[1], R, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got[2], t, rtol=0, atol=1e-9)
    # the points behind camera 0 are out of the kept candidate's mask
    assert not got[3][-25:].any()


def test_pose_error_for_pair_is_jax_cv2s():
    for (uv0, uv1, K, T), (out, noise, _) in zip(pose_sets(0), POSE_SETS):
        want = jpose.pose_error_for_pair(uv0, uv1, K, K, T)
        got = ppose.pose_error_for_pair(uv0, uv1, K, K, T)
        np.testing.assert_array_equal(got[2], want[2])
        assert abs(got[2].sum() - want[2].sum()) <= 0.05 * want[2].sum()
        assert abs(max(got[:2]) - max(want[:2])) < 1.0
        # cv2's roots are ~1e-9 off on noise-free sets, which arccos near 1
        # turns into ~1e-4 degrees
        np.testing.assert_allclose(got[:2], want[:2], rtol=0, atol=1e-3)
        if noise == 0:
            assert got[1] < 0.01 and got[0] < 0.05, (out, got[:2])
        assert got[2].sum() > 50
    k = np.zeros((4, 2))
    for f in (ppose.pose_error_for_pair, jpose.pose_error_for_pair):
        t_err, R_err, inl = f(k, k, np.eye(3), np.eye(3), np.eye(4))
        assert np.isinf(t_err) and np.isinf(R_err) and len(inl) == 0
    assert ppose.estimate_pose(k, k, np.eye(3), np.eye(3)) is None


CAP = 320


def _val_batches():
    """Two batches of 4 padded match sets with K, T and epipolar errors."""
    rng = np.random.default_rng(8)
    sets = pose_sets(1)[:7]
    batches = []
    for b in range(2):
        mk0 = np.zeros((4, CAP, 2), np.float32)
        mk1 = np.zeros((4, CAP, 2), np.float32)
        valid = np.zeros((4, CAP), bool)
        Ks, Ts = [], []
        for i in range(4):
            j = 4 * b + i
            if j < len(sets):
                uv0, uv1, K, T = sets[j]
                mk0[i, :300], mk1[i, :300] = uv0, uv1
                valid[i, :300] = True
                valid[i, rng.choice(300, 20, replace=False)] = False
            else:                     # three valid matches: no pose
                K, T = sets[0][2], sets[0][3]
                mk0[i, :3] = rng.uniform(0, 600, (3, 2))
                mk1[i, :3] = rng.uniform(0, 600, (3, 2))
                valid[i, :3] = True
            Ks.append(K)
            Ts.append(T)
        batches.append({
            "K0": np.stack(Ks).astype(np.float32),
            "K1": np.stack(Ks).astype(np.float32),
            "T_0to1": np.stack(Ts).astype(np.float32),
            "pd": {"mkpts0": mk0, "mkpts1": mk1, "valid": valid,
                   "epi_errs": (rng.random((4, CAP)) * 1e-3).astype(
                       np.float32)},
            "scalars": {"val_loss": np.float32(0.5 + b)},
        })
    return batches


def test_depth_validation_host_backend_is_jaxs():
    batches = _val_batches()

    def jax_val(state, batch, key):
        return batch["scalars"], batch["pd"]

    def port_val(state, batch, generator=None):
        return ({k: torch.tensor(v) for k, v in batch["scalars"].items()},
                {k: torch.from_numpy(v) for k, v in batch["pd"].items()})

    want = jloop.run_depth_validation(
        jax_val, None, batches, jax.random.key(0), pose_backend="host")
    port_batches = [dict(b, image0=torch.zeros(1),
                         **{k: torch.from_numpy(b[k])
                            for k in ("K0", "K1", "T_0to1")})
                    for b in batches]
    got = ploop.run_depth_validation(port_val, None, port_batches,
                                     pose_backend="host")
    assert set(got) == set(want)
    for k in ("auc@5", "auc@10", "auc@20"):
        assert abs(got[k] - want[k]) <= 0.02
        assert got[k] == pytest.approx(want[k], abs=1e-6)
    assert got["prec@5e-04"] == want["prec@5e-04"]
    assert got["val_loss"] == want["val_loss"] == 1.0
    assert 0.1 < got["auc@5"] < 1.0


def test_depth_gate_matches_host_validation_is_cv2s():
    """The depth gate's own matches (data/depth_gate_matches.npz: the 32
    val pairs of 512 matches of the trained tpu_r5_depth2 that the gate's
    sweep on a CPU gives, saved by torch_port_depth_reference.py port
    --matches): the port's host validation equals the JAX loop's (cv2)
    to 1e-6 in each AUC, each pair's inlier mask equals cv2's and its
    errors are within 1e-3 degrees; the host record is the gate's
    CPU_REF_HOST and the device backend's is CPU_REF, to 1e-6."""
    from geoformer_tpu_torch.eval import depth_gate as dg

    m = dict(np.load(Path(__file__).parent / "data"
                     / "depth_gate_matches.npz"))
    pd_keys = ("mkpts0", "mkpts1", "valid", "epi_errs")
    batches = [{k: v[i:i + 4] for k, v in m.items()}
               for i in range(0, len(m["valid"]), 4)]
    scalars = {"val_loss": np.float32(0.0)}
    want = jloop.run_depth_validation(
        lambda state, batch, key: (scalars, {k: batch[k] for k in pd_keys}),
        None, batches, jax.random.key(0), pose_backend="host")
    tb = [{"image0": torch.zeros(1),
           **{k: torch.from_numpy(v) for k, v in b.items()}}
          for b in batches]

    def port_val(state, batch, generator=None):
        return {"val_loss": torch.zeros(())}, {k: batch[k] for k in pd_keys}

    got = ploop.run_depth_validation(port_val, None, tb, pose_backend="host")
    dev = ploop.run_depth_validation(port_val, None, tb)
    for k in dg.AUCS:
        assert got[k] == pytest.approx(want[k], abs=1e-6)
        assert got[k] == pytest.approx(dg.CPU_REF_HOST[k], abs=1e-6)
        assert dev[k] == pytest.approx(dg.CPU_REF[k], abs=1e-6)
    for b in batches:
        for i in range(len(b["valid"])):
            v = b["valid"][i]
            args = (b["mkpts0"][i][v], b["mkpts1"][i][v], b["K0"][i],
                    b["K1"][i], b["T_0to1"][i])
            t_w, R_w, in_w = jpose.pose_error_for_pair(*args)
            t_g, R_g, in_g = ppose.pose_error_for_pair(*args)
            np.testing.assert_array_equal(in_g, in_w)
            assert abs(t_g - t_w) < 1e-3 and abs(R_g - R_w) < 1e-3
