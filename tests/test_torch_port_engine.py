"""The port's bundle adjustment, SfM glue, SE(3) pose graph and trajectory
alignment against the JAX package's, on the scenes of tests/test_engine.py.

Both packages get the same f32 inputs. The solvers iterate Gauss-Newton
on problems whose final residual is at the f32 noise floor, and the
gauge-fixed systems are ill-conditioned along the scene's depth, so the
two packages' sums in another order move the solution by more than an
ulp: the tolerances below were set from the measured gaps (cameras within
4e-4, points within 2.5e-3 of coordinates up to 10, after 12 iterations)
with a margin of about 5x. Each history's first cost is held to 1e-2
relative, and both finish below the same anchors as tests/test_engine.py.
Single-shot functions (reprojection errors, Huber weights, triangulation,
Umeyama, camera centres, the problem builder) are held to f32 rounding.

The sharded solvers run at world size 2 in two processes over gloo
(core/mesh.launch) and are held against the JAX solvers over a 2-device
mesh on the same problem and against the port's one-process ba_solve.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import geoformer_tpu.engine as jeng  # noqa: E402
import geoformer_tpu_torch.engine as teng  # noqa: E402
from geoformer_tpu.engine import ba as jba  # noqa: E402
from geoformer_tpu.engine import pose_graph as jpg  # noqa: E402
from geoformer_tpu.engine import sfm as jsfm  # noqa: E402
from geoformer_tpu.engine import trajectory as jtr  # noqa: E402
from geoformer_tpu_torch.core import mesh  # noqa: E402
from geoformer_tpu_torch.engine import ba as tba  # noqa: E402
from geoformer_tpu_torch.engine import pose_graph as tpg  # noqa: E402
from geoformer_tpu_torch.engine import sfm as tsfm  # noqa: E402
from geoformer_tpu_torch.engine import trajectory as ttr  # noqa: E402
from test_engine import _make_ba_problem  # noqa: E402
from torch_port_ranks import engine_solve  # noqa: E402
from torch_port_util import one_torch_thread  # noqa: E402,F401

CAM_TOL, PT_TOL = 2e-3, 1.2e-2     # abs, after the GN iterations
K_PIX = np.array([[300.0, 0, 160], [0, 300, 120], [0, 0, 1]], np.float32)


def _t(prob) -> tba.BAProblem:
    """A JAX BAProblem as the port's (int32 indices become int64)."""
    return tba.BAProblem(*(torch.from_numpy(np.array(x)) for x in prob))._replace(
        obs_cam=torch.from_numpy(np.array(prob.obs_cam, np.int64)),
        obs_pt=torch.from_numpy(np.array(prob.obs_pt, np.int64)))


def _close_solution(got, ref):
    (c, p, h), (cr, pr, hr) = got, ref
    assert c.dtype == p.dtype == h.dtype == torch.float32
    np.testing.assert_allclose(c.numpy(), np.asarray(cr), atol=CAM_TOL)
    np.testing.assert_allclose(p.numpy(), np.asarray(pr), atol=PT_TOL)
    np.testing.assert_allclose(h.numpy()[0], np.asarray(hr)[0], rtol=1e-2)
    assert h.shape == np.asarray(hr).shape


@pytest.fixture(scope="module")
def noisy():
    prob, cams_gt = _make_ba_problem(np.random.default_rng(1),
                                     pose_noise=0.02, point_noise=0.05)
    return prob, cams_gt


def test_engine_exports_what_the_jax_engine_exports():
    names = {n for n in dir(jeng) if not n.startswith("_")
             and callable(getattr(jeng, n))}
    assert names == {"ba_solve", "se3_exp", "se3_log", "align_umeyama",
                     "ate_rmse"}
    assert all(callable(getattr(teng, n)) for n in names)


def test_reprojection_errors_and_huber_weights_match_jax(noisy):
    prob, _ = noisy
    np.testing.assert_allclose(
        tba.reprojection_errors(_t(prob)).numpy(),
        np.asarray(jba.reprojection_errors(prob)), rtol=1e-5, atol=1e-4)
    for delta in (0.5, 2.0):
        np.testing.assert_allclose(
            tba.huberize(_t(prob), delta).numpy(),
            np.asarray(jba.huberize(prob, delta)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("huber", [0.0, 1.0])
def test_ba_solve_matches_jax(noisy, huber):
    prob, cams_gt = noisy
    got = tba.ba_solve(_t(prob), iters=12, huber_delta=huber)
    _close_solution(got, jba.ba_solve(prob, iters=12, huber_delta=huber))
    final = _t(prob)._replace(cams=got[0], points=got[1])
    err = tba.reprojection_errors(final)
    assert float(torch.sqrt((err ** 2).mean())) < 0.05
    ate = ttr.ate_rmse(ttr.camera_centers(got[0]),
                       ttr.camera_centers(torch.from_numpy(cams_gt)))
    assert float(ate) < 0.01


def test_ba_solve_cg_matches_jax(noisy):
    prob, _ = noisy
    got = tba.ba_solve_cg(_t(prob), iters=6, cg_iters=16)
    _close_solution(got, jba.ba_solve_cg(prob, iters=6, cg_iters=16))
    assert float(got[2][-1]) < 1e-3


def test_ba_respects_validity_padding_as_jax():
    prob, _ = _make_ba_problem(np.random.default_rng(2), pose_noise=0.01,
                               point_noise=0.02)
    bad = jnp.arange(prob.obs_uv.shape[0]) % 2 == 1
    prob = prob._replace(obs_uv=jnp.where(bad[:, None], prob.obs_uv + 500.0,
                                          prob.obs_uv), obs_valid=~bad)
    got = tba.ba_solve(_t(prob), iters=10)
    _close_solution(got, jba.ba_solve(prob, iters=10))
    err = tba.reprojection_errors(_t(prob)._replace(cams=got[0],
                                                    points=got[1])).numpy()
    assert (err[np.asarray(bad)] == 0).all()
    assert float(np.sqrt((err[~np.asarray(bad)] ** 2).mean())) < 0.05


def _loop_graph():
    """tests/test_engine.py's loop: 8 poses, noisy odometry, one exact
    loop closure weighted 10, an extra invalid edge."""
    rng = np.random.default_rng(3)
    k = 8
    step = np.asarray(jeng.se3_exp(jnp.asarray(
        np.array([0, 0, 0.1, 0.5, 0.05, 0], np.float32))))
    gt = [np.eye(4, dtype=np.float32)]
    for _ in range(1, k):
        gt.append(step @ gt[-1])
    gt = np.stack(gt)
    ei, ej, eT = [], [], []
    for i in range(k - 1):
        noise = np.asarray(jeng.se3_exp(jnp.asarray(
            rng.normal(0, 0.01, 6).astype(np.float32))))
        eT.append(noise @ gt[i + 1] @ np.linalg.inv(gt[i]))
        ei.append(i)
        ej.append(i + 1)
    ei += [0, 2]
    ej += [k - 1, 5]
    eT += [gt[k - 1] @ np.linalg.inv(gt[0]), np.eye(4, dtype=np.float32)]
    init = [np.eye(4, dtype=np.float32)]
    for i in range(k - 1):
        init.append(eT[i] @ init[i])
    arrays = dict(poses=np.stack(init).astype(np.float32),
                  edge_i=np.array(ei), edge_j=np.array(ej),
                  edge_T=np.stack(eT).astype(np.float32),
                  edge_valid=np.arange(len(ei)) != len(ei) - 1,
                  edge_weight=np.where(np.arange(len(ei)) == k - 1, 10.0,
                                       1.0).astype(np.float32))
    return arrays, gt


def test_pose_graph_matches_jax():
    a, gt = _loop_graph()
    jgraph = jpg.PoseGraph(**{k: jnp.asarray(v.astype(np.int32)
                                             if k.startswith("edge_i")
                                             or k == "edge_j" else v)
                              for k, v in a.items()})
    tgraph = tpg.PoseGraph(**{k: torch.from_numpy(v) for k, v in a.items()})
    ref, ref_hist = jpg.optimize_pose_graph(jgraph, iters=10)
    got, hist = tpg.optimize_pose_graph(tgraph, iters=10)
    assert got.dtype == hist.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)
    np.testing.assert_allclose(hist.numpy(), np.asarray(ref_hist),
                               rtol=1e-2, atol=1e-5)
    ate = ttr.ate_rmse(ttr.camera_centers(got),
                       ttr.camera_centers(torch.from_numpy(gt)), align=False)
    assert float(ate) < 0.05


def test_umeyama_ate_and_camera_centers_match_jax():
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(30, 3)).astype(np.float32)
    th = 0.7
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]], np.float32)
    for scale, flip in ((2.0, 1.0), (0.5, -1.0)):
        gt = scale * pts @ (R * np.array([1, 1, flip], np.float32)).T \
            + np.array([1, 2, 3], np.float32)
        gt = (gt + rng.normal(0, 0.01, gt.shape)).astype(np.float32)
        for ws in (True, False):
            got = ttr.align_umeyama(torch.from_numpy(pts),
                                    torch.from_numpy(gt), with_scale=ws)
            ref = jtr.align_umeyama(jnp.asarray(pts), jnp.asarray(gt),
                                    with_scale=ws)
            for g, r in zip(got, ref):
                np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                           rtol=1e-4, atol=1e-4)
        for align in (True, False):
            np.testing.assert_allclose(
                float(ttr.ate_rmse(torch.from_numpy(pts),
                                   torch.from_numpy(gt), align)),
                float(jtr.ate_rmse(jnp.asarray(pts), jnp.asarray(gt),
                                   align)), rtol=1e-4)
    cams = np.stack([np.asarray(jeng.se3_exp(jnp.asarray(x)))
                     for x in rng.normal(size=(5, 6)).astype(np.float32)])
    np.testing.assert_allclose(
        ttr.camera_centers(torch.from_numpy(cams)).numpy(),
        np.asarray(jtr.camera_centers(jnp.asarray(cams))), atol=1e-6)


def test_triangulate_matches_jax():
    rng = np.random.default_rng(6)
    T0 = np.eye(4, dtype=np.float32)
    T1 = np.asarray(jeng.se3_exp(jnp.asarray(
        np.array([0, 0.05, 0, 0.8, 0, 0], np.float32))))
    pts = rng.uniform([-2, -2, 6], [2, 2, 10], (40, 3)).astype(np.float32)

    def proj(T):
        pc = pts @ T[:3, :3].T + T[:3, 3]
        return ((pc / pc[:, 2:]) @ K_PIX.T)[:, :2].astype(np.float32)

    uv0, uv1 = proj(T0), proj(T1)
    got = tsfm.triangulate(*(torch.from_numpy(x) for x in
                             (T0, T1, K_PIX, uv0, uv1)))
    ref = np.asarray(jsfm.triangulate(*(jnp.asarray(x) for x in
                                        (T0, T1, K_PIX, uv0, uv1))))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.numpy(), pts, atol=5e-2)


def test_chain_tracks_and_build_ba_problem_match_jax():
    rng = np.random.default_rng(7)
    C, P = 5, 60
    pts = rng.uniform([-2, -2, 6], [2, 2, 10], (P, 3)).astype(np.float32)
    cams = []
    for i in range(C):
        xi = np.zeros(6, np.float32)
        xi[3] = 0.25 * i
        cams.append(np.asarray(jeng.se3_exp(jnp.asarray(xi))))
    cams = np.stack(cams)
    uvs = []
    for c in range(C):
        pc = pts @ cams[c, :3, :3].T + cams[c, :3, 3]
        uvs.append(((pc / pc[:, 2:]) @ K_PIX.T)[:, :2])
    pairs = [(uvs[i], uvs[i + 1]) for i in range(C - 1)]
    tracks = tsfm.chain_tracks(pairs, cell=8.0)
    ref_tracks = jsfm.chain_tracks(pairs, cell=8.0)
    assert len(tracks) == len(ref_tracks)
    for a, b in zip(tracks, ref_tracks):
        assert [f for f, _ in a] == [f for f, _ in b]
        np.testing.assert_array_equal(np.stack([u for _, u in a]),
                                      np.stack([u for _, u in b]))
    full = [t for t in tracks if len(t) == C]
    got = tsfm.build_ba_problem(cams, K_PIX, full, max_points=64,
                                max_obs=200, device="cpu")
    ref = jsfm.build_ba_problem(cams, K_PIX, full, max_points=64,
                                max_obs=200)
    for name in ("obs_cam", "obs_pt", "obs_uv", "obs_valid", "cams", "K"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(ref.points),
                               rtol=1e-3, atol=1e-3)
    assert got.obs_valid.sum() == 200         # capacity reached
    err = tba.reprojection_errors(got)
    assert float(torch.sqrt((err ** 2).sum() / got.obs_valid.sum())) < 0.5


def _split_by_points(prob, shards: int):
    """The problem's observations regrouped by point into ``shards`` equal
    slices with the points, obs_pt made local to its slice (the layout
    ba_solve_points_sharded takes)."""
    P = prob.points.shape[0]
    per = P // shards
    pt = np.asarray(prob.obs_pt)
    order = np.argsort(pt, kind="stable")
    local = pt[order] % per
    pick = lambda a: jnp.asarray(np.asarray(a)[order])   # noqa: E731
    return prob._replace(obs_cam=pick(prob.obs_cam),
                         obs_pt=jnp.asarray(local.astype(np.int32)),
                         obs_uv=pick(prob.obs_uv),
                         obs_valid=pick(prob.obs_valid))


def test_sharded_solvers_at_world_size_2_match_jax_mesh(tmp_path):
    prob, _ = _make_ba_problem(np.random.default_rng(5), C=4, P=64,
                               pose_noise=0.02, point_noise=0.05)
    by_pts = _split_by_points(prob, 2)
    j_mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    ref_obs = jba.ba_solve_sharded(prob, j_mesh, iters=8)
    ref_pts = jba.ba_solve_points_sharded(by_pts, j_mesh, iters=8)
    one = tba.ba_solve(_t(prob), iters=8)
    host = [{k: np.asarray(v) for k, v in _t(p)._asdict().items()}
            for p in (prob, by_pts)]
    ranks = mesh.launch(engine_solve, 2, (host, 8),
                        init_dir=str(tmp_path), timeout=240)
    # every rank holds the same solution
    for a, b in zip(ranks[0], ranks[1]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    obs_sharded, pts_sharded = ranks[0]
    for got, ref in ((obs_sharded, ref_obs), (pts_sharded, ref_pts)):
        _close_solution(tuple(torch.from_numpy(x) for x in got), ref)
    _close_solution(tuple(torch.from_numpy(x) for x in obs_sharded),
                    tuple(x.numpy() for x in one))
    assert pts_sharded[1].shape == (64, 3)
    for cams, points, _ in (obs_sharded, pts_sharded):
        err = tba.reprojection_errors(_t(prob)._replace(
            cams=torch.from_numpy(cams), points=torch.from_numpy(points)))
        assert float(torch.sqrt((err ** 2).mean())) < 0.05
