"""BOT-SORT's camera-motion estimators in the port (``data/imgproc.py``,
no cv2) against cv2 (5.0.0), and ``GMC.apply`` against the JAX
package's ``GMC`` (which calls cv2), on seeded textured frames with known
shifts and rotations, with and without outliers:

- ``corner_min_eigen_val`` equal to ``cv2.cornerMinEigenVal(g, 3, 3)``
  and ``good_features_to_track`` to ``cv2.goodFeaturesToTrack(g, 1000,
  0.01, 1, blockSize=3)``: the same corners in the same order. The widths
  are multiples of 32, where cv2's vector rows have no tail. Corners of
  exactly equal response are named (printed); their order is OpenCV's
  comparator's (the later pixel first), reproduced;
- ``pyr_down`` equal to ``cv2.pyrDown``;
- ``calc_optical_flow_pyr_lk``: the same status and points (OpenCV's
  fixed point, its window sums in float32 in its SIMD lanes' order);
- ``estimate_affine_partial_2d``: the same inlier mask (cv2's RANSAC
  draws) and the same matrix (OpenCV 5's Levenberg-Marquardt refinement,
  copied step by step), also on random point sets of 3 to 1500 points;
  its parts, ``_jt_times`` equal to ``cv2.gemm(..., GEMM_1_T)`` and
  ``_solve_svd`` to ``cv2.solve(..., DECOMP_SVD)``;
- ``GMC.apply`` equal to JAX's, the estimate near the known motion;
  ``none`` the identity; ``ecc``, ``orb`` and ``sift`` raise
  ``NotImplementedError`` naming their ROADMAP item."""
import cv2
import numpy as np
import pytest

from yolo_contour_regression_tpu.trackers.bot_sort import GMC as JaxGMC
from yolo_contour_regression_tpu_torch.data import imgproc
from yolo_contour_regression_tpu_torch.trackers.bot_sort import GMC



def textured(h, w, seed, sigma=3.0):
    r = np.random.RandomState(seed)
    b = cv2.GaussianBlur((r.rand(h, w) * 255).astype(np.uint8), (0, 0), sigma)
    return cv2.normalize(b, None, 0, 255, cv2.NORM_MINMAX).astype(np.uint8)


def moved(img, angle, shift):
    h, w = img.shape[:2]
    m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
    m[:, 2] += shift
    return cv2.warpAffine(img, m, (w, h), borderMode=cv2.BORDER_REFLECT), m


MOTIONS = [(0.0, (6.0, -4.0)), (1.5, (2.5, 3.0)), (-2.0, (-9.0, 1.0)), (0.5, (0.0, 0.0))]


@pytest.mark.parametrize("hw", [(240, 320), (96, 128), (64, 64)])
def test_corners_equal_cv2(hw):
    for seed, sigma in ((0, 3.0), (1, 1.0), (2, 6.0)):
        g = textured(*hw, seed, sigma)
        np.testing.assert_array_equal(imgproc.corner_min_eigen_val(g),
                                      cv2.cornerMinEigenVal(g, 3, 3))
        want = cv2.goodFeaturesToTrack(g, maxCorners=1000, qualityLevel=0.01, minDistance=1,
                                       blockSize=3)
        np.testing.assert_array_equal(imgproc.good_features_to_track(g), want)


def test_tied_corners_take_cv2s_order():
    """Flat rectangles: their corners' responses tie exactly; the order of
    tied corners is OpenCV's (the later pixel in raster order first)."""
    g = np.full((64, 96), 30, np.uint8)
    g[10:30, 10:40] = 200
    g[40:60, 50:80] = 200
    want = cv2.goodFeaturesToTrack(g, maxCorners=1000, qualityLevel=0.01, minDistance=1,
                                   blockSize=3)
    got = imgproc.good_features_to_track(g)
    np.testing.assert_array_equal(got, want)
    e = imgproc.corner_min_eigen_val(g)
    vals = [e[int(y), int(x)] for x, y in got.reshape(-1, 2)]
    ties = [(tuple(got[i, 0]), tuple(got[j, 0])) for i in range(len(vals))
            for j in range(i + 1, len(vals)) if vals[i] == vals[j]]
    print(f"{len(ties)} pairs of corners with tied responses, e.g. {ties[:4]}")
    assert ties
    assert imgproc.good_features_to_track(np.zeros((32, 32), np.uint8)) is None


@pytest.mark.parametrize("hw", [(240, 320), (61, 83), (15, 20), (1, 5)])
def test_pyr_down_equals_cv2(hw):
    g = np.random.default_rng(hw[1]).integers(0, 256, hw, dtype=np.uint8)
    np.testing.assert_array_equal(imgproc.pyr_down(g), cv2.pyrDown(g))


@pytest.mark.parametrize("motion", MOTIONS)
def test_optical_flow_and_affine_equal_cv2(motion):
    base = textured(240, 320, 7)
    nxt, _ = moved(base, *motion)
    rng = np.random.default_rng(0)
    nxt[100:140, 150:200] = rng.integers(0, 256, (40, 50))  # an object moving alone
    pts = cv2.goodFeaturesToTrack(base, maxCorners=1000, qualityLevel=0.01, minDistance=1,
                                  blockSize=3)
    want, wstatus, _ = cv2.calcOpticalFlowPyrLK(base, nxt, pts, None)
    got, status = imgproc.calc_optical_flow_pyr_lk(base, nxt, pts)
    np.testing.assert_array_equal(status, wstatus)
    ok = status.ravel() == 1
    print(f"{motion}: {int(ok.sum())} of {len(pts)} points tracked")
    np.testing.assert_array_equal(got[ok], want[ok])
    assert ok.sum() > 100
    src, dst = pts[ok], want[ok]
    dst[::7] += rng.uniform(-20, 20, dst[::7].shape).astype(np.float32)  # outliers
    m, inl = cv2.estimateAffinePartial2D(src, dst, method=cv2.RANSAC)
    gm, ginl = imgproc.estimate_affine_partial_2d(src, dst)
    np.testing.assert_array_equal(ginl, inl)
    np.testing.assert_array_equal(gm, m)
    assert inl.sum() < len(inl)


def test_affine_small_sets_equal_cv2():
    rng = np.random.default_rng(5)
    for n in (2, 3, 4, 5, 8, 20):
        for _ in range(10):
            src = rng.uniform(0, 100, (n, 2)).astype(np.float32)
            dst = (src * 1.01 + rng.uniform(-3, 3, 2) + rng.normal(0, 1, (n, 2))).astype(
                np.float32)
            m, inl = cv2.estimateAffinePartial2D(src, dst, method=cv2.RANSAC)
            gm, ginl = imgproc.estimate_affine_partial_2d(src, dst)
            np.testing.assert_array_equal(ginl, inl)
            np.testing.assert_array_equal(gm, m)


@pytest.mark.parametrize("noise", [0.01, 0.5, 5.0])
def test_affine_random_sets_equal_cv2(noise):
    """Similarities of random point sets (3 to 1500 points, up to a quarter
    outliers): the sizes cross ``_jt_times``'s switch to OpenBLAS and its
    block split, and the refinement runs from one to all its iterations."""
    rng = np.random.default_rng(int(noise * 100))
    for _ in range(25):
        n = int(rng.integers(3, 1500))
        src = rng.uniform(0, 300, (n, 2)).astype(np.float32)
        th, sc = rng.uniform(-0.02, 0.02), 1 + rng.uniform(-0.01, 0.01)
        rot = sc * np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        dst = (src @ rot.T + rng.uniform(-3, 3, 2) + rng.normal(0, noise, (n, 2))).astype(
            np.float32)
        dst[:int(rng.integers(0, n // 4 + 1))] += 20
        m, inl = cv2.estimateAffinePartial2D(src, dst, method=cv2.RANSAC)
        gm, ginl = imgproc.estimate_affine_partial_2d(src, dst)
        np.testing.assert_array_equal(ginl, inl)
        np.testing.assert_array_equal(gm, m)


@pytest.mark.parametrize("n", [3, 150, 600])
def test_affine_exact_motions_equal_cv2(n):
    """Points moved by an exact similarity (a still camera, a shift, a zoom):
    residuals of zero, where the refinement's step and its quality are 0 / 0."""
    src = np.random.default_rng(n).uniform(0, 300, (n, 2)).astype(np.float32)
    for dst in (src.copy(), src + np.float32(0.5), src * np.float32(2)):
        m, inl = cv2.estimateAffinePartial2D(src, dst, method=cv2.RANSAC)
        gm, ginl = imgproc.estimate_affine_partial_2d(src, dst)
        np.testing.assert_array_equal(ginl, inl)
        np.testing.assert_array_equal(gm, m)


@pytest.mark.parametrize("rows", [3, 16, 98, 99, 100, 128, 129, 137, 255, 256, 257, 700])
def test_jt_times_equals_cv2_gemm(rows):
    rng = np.random.default_rng(rows)
    jac = np.zeros((rows, 4))
    jac[:, 0] = rng.uniform(0, 300, rows).astype(np.float32)
    jac[:, 1] = -rng.uniform(0, 300, rows).astype(np.float32)
    jac[:, 2] = 1
    r = rng.normal(size=rows) * 2
    want = cv2.gemm(jac, r.reshape(-1, 1), 1.0, None, 0.0, flags=cv2.GEMM_1_T).ravel()
    np.testing.assert_array_equal(imgproc._jt_times(jac, r), want)


def test_solve_svd_equals_cv2_solve():
    rng = np.random.default_rng(0)
    for _ in range(200):
        a = rng.normal(size=(4, 4))
        a = a @ a.T + np.diag(rng.uniform(0, 1e6, 4))
        b = rng.normal(size=4)
        _, want = cv2.solve(a, b.reshape(4, 1), flags=cv2.DECOMP_SVD)
        np.testing.assert_array_equal(imgproc._solve_svd(a, b), want.ravel())


@pytest.mark.parametrize("motion", MOTIONS)
def test_gmc_apply_equals_jax(motion):
    """Two 480x640 BGR frames (downscaled 2x inside), the second moved by
    the camera and holding an object that moves on its own (outliers to
    the camera's motion): the first apply is the identity on both sides,
    the second estimates the camera's motion."""
    base = cv2.cvtColor(textured(480, 640, 11), cv2.COLOR_GRAY2BGR)
    base[..., 1] = np.roll(base[..., 1], 3, 1)
    thing = cv2.cvtColor(textured(90, 120, 12, sigma=1.5), cv2.COLOR_GRAY2BGR)
    base[100:190, 300:420] = thing
    nxt, m = moved(base, *motion)
    nxt[130:220, 330:450] = thing
    got, want = GMC(), JaxGMC()
    np.testing.assert_array_equal(got.apply(base), want.apply(base))
    g, w = got.apply(nxt), want.apply(nxt)
    assert g.dtype == w.dtype == np.float32
    print(f"{motion}: port {g.tolist()} JAX {w.tolist()} true {m.tolist()}")
    np.testing.assert_array_equal(g, w)
    assert np.abs(g[:, :2] - m[:, :2]).max() < 0.01 and np.abs(g[:, 2] - m[:, 2]).max() < 1.0


def test_gmc_methods():
    np.testing.assert_array_equal(GMC("none").apply(np.zeros((8, 8, 3), np.uint8)),
                                  np.eye(2, 3, dtype=np.float32))
    assert GMC(None).method == "none"
    for method in ("ecc", "orb", "sift"):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 3.2b"):
            GMC(method)
    with pytest.raises(ValueError):
        GMC("bogus")
