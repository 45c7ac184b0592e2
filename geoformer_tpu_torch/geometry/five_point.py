"""The host's essential-matrix RANSAC and pose recovery, in numpy float64.

What the JAX package's host pose estimator (geoformer_tpu/eval/pose.py)
asks of OpenCV, without OpenCV:

- essential_five_point: Nister's minimal problem for many 5-tuples at
  once. The nullspace of each 5x9 epipolar system (E = x E0 + y E1 +
  z E2 + E3), the ten cubic constraints (det E = 0 and
  2 E E^T E - tr(E E^T) E = 0) as a 10x20 matrix over the monomials of
  x, y, z, its cubic block eliminated, and the 10x10 action matrix of z on
  the remaining monomials (x^2, xy, xz, y^2, yz, z^2, x, y, z, 1). Its
  eigenvalues are the solutions' z, its eigenvectors give x and y. Every
  real solution comes out with unit Frobenius norm, up to 10 a tuple.
- find_essential_mat: cv2.findEssentialMat(method=RANSAC) on normalized
  points (identity intrinsics), as OpenCV's point-set registrator runs it.
  Its generator is cv::RNG seeded with 2**64 - 1 on every call (a
  multiply-with-carry generator, coefficient 4164903690); a subset is 5
  distinct indices, each drawn by ``next() % n`` until unseen. Every real
  solution of a subset is scored by its Sampson error, cast to float32,
  against float32(thr^2); a model with strictly more inliers than the best
  so far (and than 4) replaces it and lowers the iteration count to
  log(1 - prob) / log(1 - (1 - outliers)^5), at most 1000. The subsets are
  drawn ahead in growing chunks, each chunk solved and scored in a few
  batched calls ([T, 10, 10] eigenproblems, a [T*10, N] error matrix),
  and the sequential loop replayed over the counts, so the model kept is
  the one OpenCV's loop keeps. Exactly 5 points give every solution
  stacked [3k, 3] and an all-ones mask; fewer, or no model, give None.
- recover_pose: cv2.recoverPose: the four (R, t) of the SVD decomposition,
  each point triangulated (the smallest right singular vector of its 4x4
  DLT system), counted where it lies in front of both cameras and nearer
  than distance_thresh, the candidate with most such points kept (the
  first of equal counts), the given mask applied.

The solver is not OpenCV's (which roots a degree-10 polynomial), so a
solution agrees with cv2's to rounding, and the order of a tuple's
solutions can differ: where two solutions of one subset tie for the best
count, or recoverPose's candidates tie, another one can be kept.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

_RNG_COEFF = 4164903690
_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1
MODEL_POINTS = 5
MAX_ITERS = 1000
_IMAG_TOL = 1e-10       # cv2 drops roots with a larger imaginary part
_FIRST_CHUNK, _MAX_CHUNK = 32, 256


class CvRNG:
    """cv::RNG: state s (64 bits); next() sets
    s = (s mod 2^32) * 4164903690 + (s >> 32) and returns s mod 2^32."""

    def __init__(self, state: int = _M64):
        self.state = state or _M32

    def next(self) -> int:
        s = self.state
        s = ((s & _M32) * _RNG_COEFF + (s >> 32)) & _M64
        self.state = s
        return s & _M32

    def uniform(self, a: int, b: int) -> int:
        """An int in [a, b), as cv::RNG::uniform(int, int)."""
        return a if a == b else self.next() % (b - a) + a


def draw_subset(rng: CvRNG, count: int, size: int = MODEL_POINTS) -> list:
    """``size`` distinct indices in [0, count), redrawn until unseen, as the
    registrator's getSubset draws them."""
    idx = []
    for _ in range(size):
        i = rng.uniform(0, count)
        while i in idx:
            i = rng.uniform(0, count)
        idx.append(i)
    return idx


def ransac_update_num_iters(p: float, ep: float, model_points: int,
                            max_iters: int) -> int:
    """cv::RANSACUpdateNumIters: the iterations that find an all-inlier
    subset with probability p at outlier share ep, at most max_iters."""
    p = min(max(p, 0.0), 1.0)
    ep = min(max(ep, 0.0), 1.0)
    tiny = np.finfo(np.float64).tiny
    num = max(1.0 - p, tiny)
    denom = 1.0 - (1.0 - ep) ** model_points
    if denom < tiny:
        return 0
    num = np.log(num)
    denom = np.log(denom)
    if denom >= 0 or -num >= max_iters * -denom:
        return max_iters
    return int(np.rint(num / denom))


# ------------------------------------------------------------ the solver ---

# the 20 monomials of degree <= 3: the ten cubic ones (eliminated), then the
# quotient basis the action matrix acts on
_CUBIC = [(3, 0, 0), (2, 1, 0), (2, 0, 1), (1, 2, 0), (1, 1, 1), (1, 0, 2),
          (0, 3, 0), (0, 2, 1), (0, 1, 2), (0, 0, 3)]
_BASIS = [(2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1), (0, 0, 2),
          (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
_MONO3 = _CUBIC + _BASIS
_MONO1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]      # E0..E3
_MONO2 = sorted({tuple(a + b for a, b in zip(u, v))
                 for u in _MONO1 for v in _MONO1}, reverse=True)


def _product_table(left, right, out):
    """[len(left), len(right), len(out)] 0/1: which monomial of ``out`` the
    product of a monomial of ``left`` and one of ``right`` is."""
    pos = {m: i for i, m in enumerate(out)}
    t = np.zeros((len(left), len(right), len(out)))
    for i, u in enumerate(left):
        for j, v in enumerate(right):
            t[i, j, pos[tuple(a + b for a, b in zip(u, v))]] = 1.0
    return t


_P11 = _product_table(_MONO1, _MONO1, _MONO2)
_P21 = _product_table(_MONO2, _MONO1, _MONO3)
# z times each basis monomial: a cubic monomial (a row of the eliminated
# system) or another basis monomial
_Z_TIMES = [(m[0], m[1], m[2] + 1) for m in _BASIS]


def _constraint_matrix(basis: np.ndarray) -> np.ndarray:
    """basis [T, 4, 3, 3] (E0..E3) -> [T, 10, 20]: det E and the nine
    entries of 2 E E^T E - tr(E E^T) E over _MONO3, E = x E0 + y E1 +
    z E2 + E3. A product of polynomials is the outer product of their
    coefficients times a product table."""
    T = len(basis)
    E = np.moveaxis(basis, 1, -1)                         # [T, 3, 3, 4]
    p11 = _P11.reshape(16, 10)
    p21 = _P21.reshape(40, 20)
    EEt = np.einsum("tika,tjkb->tijab", E, E).reshape(T, 3, 3, 16) @ p11
    EEtE = np.einsum("tikm,tkjb->tijmb", EEt, E).reshape(T, 3, 3, 40) @ p21
    trace = np.einsum("tiim->tm", EEt)
    trE = np.einsum("tm,tijb->tijmb", trace, E).reshape(T, 3, 3, 40) @ p21
    cubic = (2.0 * EEtE - trE).reshape(T, 9, 20)

    def mul11(a, b):
        return np.einsum("ta,tb->tab", a, b).reshape(T, 16) @ p11

    cof = np.stack([
        mul11(E[:, 1, 1], E[:, 2, 2]) - mul11(E[:, 1, 2], E[:, 2, 1]),
        mul11(E[:, 1, 2], E[:, 2, 0]) - mul11(E[:, 1, 0], E[:, 2, 2]),
        mul11(E[:, 1, 0], E[:, 2, 1]) - mul11(E[:, 1, 1], E[:, 2, 0]),
    ], 1)                                                 # [T, 3, 10]
    det = np.einsum("tjm,tjb->tmb", cof, E[:, 0]).reshape(T, 40) @ p21
    return np.concatenate([det[:, None], cubic], 1)


def _solve_blocks(A: np.ndarray, B: np.ndarray):
    """A^-1 B for a stack of square A, and which A were invertible (a
    singular one gives zeros)."""
    try:
        return np.linalg.solve(A, B), np.ones(len(A), bool)
    except np.linalg.LinAlgError:
        out = np.zeros(A.shape[:-1] + B.shape[-1:])
        ok = np.zeros(len(A), bool)
        for i in range(len(A)):
            try:
                out[i] = np.linalg.solve(A[i], B[i])
                ok[i] = True
            except np.linalg.LinAlgError:
                pass
        return out, ok


def epipolar_rows(x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
    """[..., N, 9] rows of x2^T E x1 = 0 over E's entries, row-major."""
    a, b = x1[..., 0], x1[..., 1]
    c, d = x2[..., 0], x2[..., 1]
    one = np.ones_like(a)
    return np.stack([c * a, c * b, c, d * a, d * b, d, a, b, one], -1)


def essential_five_point(x1: np.ndarray, x2: np.ndarray):
    """Every real essential matrix of each 5-tuple.

    x1, x2: [T, 5, 2] normalized correspondences (x2^T E x1 = 0).
    Returns (E [T, 10, 3, 3], valid [T, 10]): unit Frobenius norm; a slot
    is valid where its eigenvalue is real (imaginary part at most 1e-10)
    and its solution finite."""
    x1 = np.asarray(x1, np.float64)
    x2 = np.asarray(x2, np.float64)
    T = len(x1)
    _, _, vt = np.linalg.svd(epipolar_rows(x1, x2), full_matrices=True)
    basis = vt[:, 5:9].reshape(T, 4, 3, 3)                # E0, E1, E2, E3
    C = _constraint_matrix(basis)
    G, ok = _solve_blocks(C[:, :, :10], C[:, :, 10:])     # cubic = -G basis
    pos3 = {m: i for i, m in enumerate(_MONO3)}
    action = np.zeros((T, 10, 10))
    for row, m in enumerate(_Z_TIMES):
        col = pos3[m]
        if col < 10:
            action[:, row] = -G[:, col]
        else:
            action[:, row, col - 10] = 1.0
    w, v = np.linalg.eig(action)                          # v[:, :, k]
    with np.errstate(divide="ignore", invalid="ignore"):
        xs = (v[:, 6] / v[:, 9]).real
        ys = (v[:, 7] / v[:, 9]).real
    zs = w.real
    E = (xs[..., None, None] * basis[:, None, 0]
         + ys[..., None, None] * basis[:, None, 1]
         + zs[..., None, None] * basis[:, None, 2] + basis[:, None, 3])
    norm = np.sqrt((E * E).sum((-2, -1)))
    with np.errstate(divide="ignore", invalid="ignore"):
        E = E / norm[..., None, None]
    valid = (ok[:, None] & (np.abs(w.imag) <= _IMAG_TOL)
             & np.isfinite(E).all((-2, -1)) & (norm > 0))
    return np.where(valid[..., None, None], E, 0.0), valid


# ------------------------------------------------------------ the RANSAC ---

def sampson_errors(E: np.ndarray, x1: np.ndarray, x2: np.ndarray):
    """Sampson errors [K, N] of E [K, 3, 3] on normalized points x1, x2
    [N, 2], in float32 as cv2 stores them:
    (x2^T E x1)^2 / ((E x1)_0^2 + (E x1)_1^2 + (E^T x2)_0^2 + (E^T x2)_1^2)."""
    h1 = np.concatenate([x1, np.ones((len(x1), 1))], 1).T     # [3, N]
    h2 = np.concatenate([x2, np.ones((len(x2), 1))], 1).T
    e = E.reshape(-1, 9)
    ex = [e[:, 3 * i:3 * i + 3] @ h1 for i in range(3)]      # (E x1)_i
    etx = [e[:, i::3] @ h2 for i in range(2)]               # (E^T x2)_i
    num = ex[0] * h2[0] + ex[1] * h2[1] + ex[2]
    den = ex[0] * ex[0] + ex[1] * ex[1] + etx[0] * etx[0] + etx[1] * etx[1]
    with np.errstate(divide="ignore", invalid="ignore"):
        return (num * num / den).astype(np.float32)


def find_essential_mat(points1, points2, threshold: float,
                       prob: float = 0.999, max_iters: int = MAX_ITERS):
    """cv2.findEssentialMat(points1, points2, eye(3), RANSAC, prob,
    threshold, max_iters) on normalized points [N, 2].

    Returns (E, mask, iterations): E [3, 3] (or [3k, 3], every solution,
    for exactly 5 points) or None, mask [N, 1] uint8 in {0, 1} (None with
    E), and the subsets the loop drew."""
    x1 = np.asarray(points1, np.float64).reshape(-1, 2)
    x2 = np.asarray(points2, np.float64).reshape(-1, 2)
    n = len(x1)
    if n < MODEL_POINTS:
        return None, None, 0
    if n == MODEL_POINTS:
        E, valid = essential_five_point(x1[None], x2[None])
        E = E[0][valid[0]]
        if not len(E):
            return None, None, 0
        return E.reshape(-1, 3), np.ones((n, 1), np.uint8), 0
    thr2 = np.float32(threshold * threshold)
    rng = CvRNG()
    niters = max(max_iters, 1)
    best, best_E, best_mask = 0, None, None
    it, chunk = 0, _FIRST_CHUNK
    while it < niters:
        idx = np.array([draw_subset(rng, n)
                        for _ in range(min(chunk, niters - it))])
        chunk = min(2 * chunk, _MAX_CHUNK)
        E, valid = essential_five_point(x1[idx], x2[idx])
        sub, slot = np.nonzero(valid)            # the real solutions, in order
        inl = sampson_errors(E[sub, slot], x1, x2) <= thr2    # [K, N]
        counts = inl.sum(-1)
        first = np.searchsorted(sub, np.arange(len(idx) + 1))
        for j in range(len(idx)):
            if it >= niters:
                break
            for m in range(first[j], first[j + 1]):
                g = int(counts[m])
                if g > max(best, MODEL_POINTS - 1):
                    best, best_E, best_mask = g, E[j, slot[m]], inl[m]
                    niters = ransac_update_num_iters(
                        prob, (n - g) / n, MODEL_POINTS, niters)
            it += 1
    if best == 0:
        return None, None, it
    return best_E.copy(), best_mask.astype(np.uint8)[:, None], it


# ------------------------------------------------------- pose recovery -----

def decompose_essential(E: np.ndarray):
    """(R1, R2, t) of cv2.decomposeEssentialMat: E = U diag V^T with
    det U = det V = 1, R1 = U W V^T, R2 = U W^T V^T, t = U[:, 2]."""
    U, _, Vt = np.linalg.svd(np.asarray(E, np.float64).reshape(3, 3))
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    return U @ W @ Vt, U @ W.T @ Vt, U[:, 2].copy()


def triangulate(P0: np.ndarray, P1: np.ndarray, x1: np.ndarray,
                x2: np.ndarray) -> np.ndarray:
    """[4, N] homogeneous points of cv2.triangulatePoints: the right
    singular vector of each point's 4x4 DLT system with the least singular
    value (its sign is the SVD's)."""
    rows = []
    for P, x in ((P0, x1), (P1, x2)):
        rows.append(x[:, 0, None] * P[2] - P[0])
        rows.append(x[:, 1, None] * P[2] - P[1])
    A = np.stack(rows, 1)                                 # [N, 4, 4]
    _, _, vt = np.linalg.svd(A)
    return vt[:, 3].T


def _in_front(P: np.ndarray, x1, x2, dist: float) -> np.ndarray:
    P0 = np.eye(3, 4)
    Q = triangulate(P0, P, x1, x2)
    mask = Q[2] * Q[3] > 0
    with np.errstate(divide="ignore", invalid="ignore"):
        Q = Q / Q[3]
        mask &= Q[2] < dist
        depth = P[2] @ Q
    mask &= depth > 0
    mask &= depth < dist
    return mask


def recover_pose(E, points1, points2, distance_thresh: float = 50.0,
                 mask: Optional[np.ndarray] = None
                 ) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray]:
    """cv2.recoverPose(E, points1, points2, eye(3), distance_thresh, mask)
    on normalized points [N, 2].

    Returns (count, R [3, 3], t [3, 1], mask [N, 1] uint8): the points of
    the kept candidate in front of both cameras, as 255, or as the given
    mask's value where it is set."""
    x1 = np.asarray(points1, np.float64).reshape(-1, 2)
    x2 = np.asarray(points2, np.float64).reshape(-1, 2)
    R1, R2, t = decompose_essential(E)
    cands = [(R1, t), (R2, t), (R1, -t), (R2, -t)]
    masks = [_in_front(np.concatenate([R, tt[:, None]], 1), x1, x2,
                       distance_thresh).astype(np.uint8) * 255
             for R, tt in cands]
    if mask is not None:
        given = np.asarray(mask, np.uint8).reshape(-1)
        masks = [given & m for m in masks]
    goods = [int(np.count_nonzero(m)) for m in masks]
    k = int(np.argmax(goods))             # the first of equal counts
    R, tt = cands[k]
    return goods[k], R.copy(), tt.reshape(3, 1).copy(), masks[k][:, None]
