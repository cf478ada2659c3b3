"""A CPU model of the GT-ray kernel's angle-bin search
(``yolo_contour_regression_tpu_torch/csrc/gt_rays.cu``), held to the plain
version ``ops/polar.py:_gt_rays_dense`` bit for bit.

The kernel cannot run without a card, so this file checks its selection
logic here: the angles and distances come from the port's own torch ops
(``point_angles_deg`` and the distance of ``_gt_rays_dense``), exactly as
the plain version computes them, and only what the kernel does with them
is modelled, in numpy float32, step for step:

- phase 2: each angle goes to the 1-degree bin it is nearest,
  ``floor(ang + 0.5) mod 360`` (``ang`` may be 360.0, which is bin 0), by a
  counting sort: counts, an exclusive prefix, and a scatter of the point
  indices, in whatever order the scatter runs (the kernel's atomics pick one);
- phase 3: ray r owns bin b0 = 10 r; ring j is bins b0 - j and b0 + j
  (modulo 360; ring 180 is one bin), whose angles are at least ``j - 0.5``
  degrees from the ray, less a rounding far below ``STOP_MARGIN_DEG``. The
  bins are in slot order, so the rings 0 .. J are one run of slots. The ray
  counts the angles of rings 0-3 (every angle within 3 degrees lies
  there): with none, it is ``RAY_EPS`` at once (the gate). Otherwise it
  scans its own bin if that holds 4 or more (their diffs are within half a
  degree, so the gate is passed), else rings 0-3, keeping the 4 least
  (diff, index) pairs in lexicographic order; it is ``RAY_EPS`` if the
  least diff is above 3 degrees. Then it
  widens the window: with fewer than 4 found, to the least J whose rings
  hold 4 (a binary search over the counts); with 4, to every ring that may
  hold a diff up to d3, the 4th least, ``J = int(d3 + 0.5 + 2 margin)``
  (strict: an equal diff at a lower index still displaces), until the
  window holds all it needs. The ray is the largest of the 4 distances, then
  at least ``RAY_EPS``.
"""
import numpy as np
import pytest
import torch

from chip_smoke import RAY_SCENES, ray_contours, ray_inputs, ray_scenes
from yolo_contour_regression_tpu_torch.ops import polar


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads while this module runs: under the suite's parallel
    workers torch's default, one thread per core in every worker,
    oversubscribes the CPU and slows the port's side many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

F = np.float32
BINS = polar.NUM_CONTOUR_POINTS  # csrc/gt_rays.cu: kBins, 1 degree each
BINS_PER_RAY = BINS // polar.NUM_RAYS
GATE_RING = 3  # csrc/gt_rays.cu: kGateRing
STOP_MARGIN_DEG = F(1e-3)  # csrc/gt_rays.cu: kStopMarginDeg
GATE = F(polar.ANGLE_GAP_DEG)
RAY_EPS = F(polar.RAY_EPS)
NO_POINT = polar.NUM_CONTOUR_POINTS  # the kernel's index of an empty top-4 slot
PAIRS_PER_BLOCK = 8  # csrc/gt_rays.cu: kPairsPerBlock; a block runs 8 x 36 threads


def angles_and_distances(contours, centers):
    """(P, 360) f32 angles and distances of each pair's points, by the
    torch ops of ``_gt_rays_dense``."""
    c, x = torch.from_numpy(contours), torch.from_numpy(centers)
    ang = polar.point_angles_deg(c, x)
    v = c - x[..., None, :]
    dist = torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])
    return ang.numpy(), dist.numpy()


def bins(ang):
    """Phase 2's bin of each angle, in float32 as the kernel rounds it."""
    b = np.floor(ang + F(0.5)).astype(np.int64)
    return np.where(b >= BINS, b - BINS, b)


def bucket(ang, order):
    """The counting sort: angles and point indices grouped by bin, each
    bin's slots filled in ``order``; start (361,) bounds each bin."""
    b = bins(ang)
    start = np.concatenate([[0], np.cumsum(np.bincount(b, minlength=BINS))])
    nxt = start[:-1].copy()
    sang, sidx = np.empty_like(ang), np.empty(len(ang), np.int64)
    for i in order:
        sang[nxt[b[i]]], sidx[nxt[b[i]]] = ang[i], i
        nxt[b[i]] += 1
    return sang, sidx, start


def search_pair(ang, dist, order=None, lexicographic=True, rings=True, wrap=True,
                strict=True):
    """Phases 2-3 for one pair: rays (36,) f32, points scanned per ray (36,).
    The keywords make wrong variants, to show the cases here catch them:
    ``lexicographic=False`` keeps a strict ``<`` on the diff alone (ties go to
    the first visited), ``rings=False`` scans the ray's own bin only,
    ``wrap=False`` drops the bins past 0 or 359, ``strict=False`` takes the
    rings up to ``floor(d3 + 0.5) - 1`` only, with no margin."""
    sang, sidx, start = bucket(ang, range(len(ang)) if order is None else order)

    def first(b):  # the first slot of bin b, for b in [-360, 720]: bins repeat every 360
        return start[b % BINS] + BINS * (b // BINS)

    rays, work = np.empty(polar.NUM_RAYS, F), np.zeros(polar.NUM_RAYS, np.int64)
    for r in range(polar.NUM_RAYS):
        theta, b0 = F(r * polar.RAY_STEP_DEG), r * BINS_PER_RAY
        if first(b0 + GATE_RING + 1) - first(b0 - GATE_RING) == 0:
            rays[r] = RAY_EPS
            continue
        top = [(np.inf, NO_POINT)] * polar.ANGLE_TOPK

        def scan(j0, j1):  # slots j0 .. j1 - 1, taken modulo 360
            for j in range(j0, j1):
                if not wrap and not 0 <= j < BINS:
                    continue
                a, i = sang[j % BINS], int(sidx[j % BINS])
                d = abs(a - theta)
                d = F(360) - d if d > F(180) else d
                if (float(d), i) < top[-1] if lexicographic else float(d) < top[-1][0]:
                    top[-1] = (float(d), i)
                    top.sort(key=(lambda e: e) if lexicographic else (lambda e: e[0]))
                work[r] += 1

        def end(ring):  # one past the last bin of rings 0 .. ring
            return b0 + BINS // 2 if ring == BINS // 2 else b0 + ring + 1

        # first the ray's own bin if it holds 4, else the gate's window (rings 0-3)
        cov = GATE_RING if rings and first(b0 + 1) - first(b0) < polar.ANGLE_TOPK else 0
        scan(first(b0 - cov), first(b0 + cov + 1))
        gated = False
        while rings:
            if top[0][0] > GATE:
                gated = True
                break
            if top[-1][0] == np.inf:  # fewer than 4: the least ring window holding 4
                ring = next(j for j in range(cov + 1, BINS // 2 + 1)
                            if first(end(j)) - first(b0 - j) >= polar.ANGLE_TOPK)
            else:  # every ring that may hold a diff <= d3
                need = F(top[-1][0]) + (F(0.5) + F(2) * STOP_MARGIN_DEG if strict else F(0.5))
                ring = min(int(need) - (0 if strict else 1), BINS // 2)
                if ring <= cov:
                    break
            scan(first(b0 - ring), first(b0 - cov))
            scan(first(end(cov)), first(end(ring)))
            cov = ring
        found = [i for _, i in top if i != NO_POINT]
        rays[r] = RAY_EPS if gated or not found else max(max(dist[i] for i in found), RAY_EPS)
    return rays, work


def model_rays(contours, centers, **kw):
    """The search for every pair: (P, 360, 2), (P, 2) -> rays (P, 36),
    points scanned (P, 36)."""
    ang, dist = angles_and_distances(contours, centers)
    out = [search_pair(a, d, **kw) for a, d in zip(ang, dist)]
    return np.stack([o[0] for o in out]), np.stack([o[1] for o in out])


def dense_rays(contours, centers):
    return polar._gt_rays_dense(torch.from_numpy(contours), torch.from_numpy(centers)).numpy()


def scene_pairs(names=RAY_SCENES):
    """The named scenes of ``chip_smoke.ray_scenes`` as (P, 360, 2), (P, 2)."""
    contours, centers = ray_scenes()
    pick = [RAY_SCENES.index(n) for n in names]
    k = centers.shape[1]
    return (np.ascontiguousarray(np.repeat(contours[pick], k, 0)),
            np.ascontiguousarray(centers[pick].reshape(-1, 2)))


def seeded_pairs(kind):
    if kind == "rows":  # the assigner's form: K centers about each GT, valid ones only
        contours, centers, valid = ray_inputs(6, 12, seed=12)
        return (np.ascontiguousarray(contours[np.nonzero(valid)[0]]),
                np.ascontiguousarray(centers[valid]))
    contours, c, r = ray_contours(48, seed=5)
    rng = np.random.default_rng(5)
    return contours, (c + rng.uniform(-1.5, 1.5, (48, 2)) * r[:, None]).astype(np.float32)


@pytest.mark.parametrize("scene", RAY_SCENES)
def test_search_equals_dense_on_each_scene(scene):
    contours, centers = scene_pairs([scene])
    got, _ = model_rays(contours, centers)
    np.testing.assert_array_equal(got, dense_rays(contours, centers))


@pytest.mark.parametrize("kind", ["rows", "pairs"])
def test_search_equals_dense_on_seeded_inputs(kind):
    contours, centers = seeded_pairs(kind)
    got, _ = model_rays(contours, centers)
    np.testing.assert_array_equal(got, dense_rays(contours, centers))


@pytest.mark.parametrize("order", ["reversed", "shuffled"])
def test_search_does_not_depend_on_the_scatter_order(order):
    """The kernel's atomics fill each bin in any order; the lexicographic
    (diff, index) top 4 gives the same rays whatever that order is."""
    contours, centers = scene_pairs()
    ang, dist = angles_and_distances(contours, centers)
    rng = np.random.default_rng(0)
    want = dense_rays(contours, centers)
    for p in range(len(ang)):
        perm = np.arange(360)[::-1] if order == "reversed" else rng.permutation(360)
        got, _ = search_pair(ang[p], dist[p], order=perm)
        np.testing.assert_array_equal(got, want[p])


@pytest.mark.parametrize("variant", ["ties_by_visit_order", "own_bin_only",
                                     "rings_not_wrapped"])
def test_the_scenes_catch_a_wrong_search(variant):
    """Three wrong searches, each of which the scenes must catch: ties taken
    by the order of the visit (a strict ``<`` on the diff, bins filled in
    reverse), no ring beyond the ray's own bin, and rings that do not wrap
    at 0/360."""
    contours, centers = scene_pairs()
    ang, dist = angles_and_distances(contours, centers)
    want = dense_rays(contours, centers)
    kw = {"ties_by_visit_order": {"lexicographic": False, "order": np.arange(360)[::-1]},
          "own_bin_only": {"rings": False}, "rings_not_wrapped": {"wrap": False}}[variant]
    wrong = sum(int((search_pair(a, d, **kw)[0] != w).sum()) for a, d, w in zip(ang, dist, want))
    assert wrong > 0


def brute_force_rays(ang, dist):
    """The plain version's selection on given angles, in numpy: every diff,
    a stable sort, the 4 first, the 3-degree gate (an independent check of
    the search on angles no contour gives exactly)."""
    theta = np.arange(0, 360, polar.RAY_STEP_DEG).astype(F)
    diff = np.abs(ang[None, :] - theta[:, None])
    diff = np.where(diff > F(180), F(360) - diff, diff)
    order = np.argsort(diff, axis=-1, kind="stable")
    ray = dist[order[:, :polar.ANGLE_TOPK]].max(-1)
    ray = np.where(np.take_along_axis(diff, order[:, :1], -1)[:, 0] > GATE, RAY_EPS, ray)
    return np.maximum(ray, RAY_EPS).astype(F)


@pytest.mark.parametrize("case", ["equal_diff_across_the_edge", "rounded_into_the_next_bin"])
def test_stop_rule_at_the_ring_edge(case):
    """Ray 35 (350 degrees) finds 3 points within 5 degrees and its 4th at
    339.5 (bin 340, ring 10, diff 10.5). Ring 11 then holds a point that
    displaces it: at 0.5 exactly (bin 1, diff 10.5) with a lower index, or at
    0.49999997 (the float below 0.5), which ``ang + 0.5`` rounds into bin 1
    though it lies nearer bin 0. The strict widening with its margin scans
    ring 11 and finds it; one without the margin does not."""
    rng = np.random.default_rng(1)
    ang = rng.uniform(20, 300, 360).astype(F)  # far from rays 32-35 and 0
    ang[[1, 2, 3, 300]] = F(350.0), F(345.0), F(355.0), F(339.5)
    ang[0] = F(0.5) if case == "equal_diff_across_the_edge" else np.nextafter(F(0.5), F(0))
    dist = rng.uniform(1, 100, 360).astype(F)
    dist[0] = F(500.0)  # the displacing point is the farthest: the ray shows the pick
    assert bins(ang)[[0, 1, 2, 3, 300]].tolist() == [1, 350, 345, 355, 340]
    want = brute_force_rays(ang, dist)
    assert want[35] == F(500.0)
    np.testing.assert_array_equal(search_pair(ang, dist)[0], want)
    assert search_pair(ang, dist, strict=False)[0][35] != want[35]
    np.testing.assert_array_equal(search_pair(ang, dist, order=np.arange(360)[::-1])[0], want)


def test_the_scenes_hold_what_they_claim():
    """Each hard case is in the data: ties at the 4th/5th nearest; angles at
    the gate, at 360.0 and at sector edges; sectors of 0 and of 30+ points;
    a center on a contour point; rays that the gate ends at once."""
    contours, centers = ray_scenes()
    k = centers.shape[1]
    pc, px = scene_pairs()
    ang, dist = angles_and_distances(pc, px)
    theta = np.arange(0, 360, 10, dtype=F)
    diff = np.abs(ang[:, None, :] - theta[:, None])
    diff = np.sort(np.where(diff > F(180), F(360) - diff, diff), -1)
    scene = np.repeat(np.arange(len(RAY_SCENES)), k)
    at = {n: scene == RAY_SCENES.index(n) for n in RAY_SCENES}
    assert (diff[at["circle_ties"], :, 3] == diff[at["circle_ties"], :, 4]).sum() >= 10
    gate = diff[at["gate_exact"], :, 0]
    assert ((gate > 3) & (gate < 3.0002)).any() and ((gate <= 3) & (gate > 2.9998)).any()
    wrap = ang[at["wrap_and_sector_edges"]]
    assert ((wrap < 1e-4).sum() > 4 and (wrap > 360 - 1e-4).sum() > 4
            and (np.abs((wrap + 5) % 10 - 10 * np.round(((wrap + 5) % 10) / 10)) < 1e-4).sum() > 36)
    sector = (bins(ang[at["concave_star"]][0]) + BINS_PER_RAY // 2) // BINS_PER_RAY % polar.NUM_RAYS
    counts = np.bincount(sector, minlength=polar.NUM_RAYS)  # 10-degree sectors about the rays
    assert (counts == 0).any() and (counts >= 30).any()
    assert (dist[at["center_on_point"]] == 0).sum(-1).min() >= 1
    assert (dist[at["one_point"]][0] == 0).all()
    assert (diff[at["far_outside"], :, 0] > GATE).mean() > 0.9
    assert (ang == F(360)).any() or (np.abs(ang - 360) < 1e-4).any()
    assert np.array_equal(contours[RAY_SCENES.index("center_on_point")][::45],
                          centers[RAY_SCENES.index("center_on_point")])


def kernel_order(ang):
    """The kernel's phase-3 order for one pair's 36 rays: each ray's cost
    class from the counts (0 if its gate's window is empty, else its own
    bin's points if 4 or more, else the window's; classes by powers of 2,
    the dearest first)."""
    count = np.bincount(bins(ang), minlength=BINS)
    cls = np.empty(polar.NUM_RAYS, np.int64)
    for r in range(polar.NUM_RAYS):
        b0 = r * BINS_PER_RAY
        window = count[np.arange(b0 - GATE_RING, b0 + GATE_RING + 1) % BINS].sum()
        cost = 0 if window == 0 else (count[b0] if count[b0] >= polar.ANGLE_TOPK else window)
        cls[r] = 7 - min(int(cost).bit_length(), 7)
    return cls


def test_search_work_and_divergence_on_the_train_shape():
    """What the search scans at the trainer's R = 128, K = 128 (the first 16
    rows of ``chip_smoke.ray_inputs(128, 128, seed=128)``, as
    ``chip_smoke.py`` gives the kernel), counted on the CPU: the share of
    rays the gate ends at once, points scanned per ray, and the SIMT
    efficiency of phase 3's scan (the sum of the lanes' points over 32 times
    the warp's most, warps of 32 threads of a block of 8 pairs x 36 rays),
    with the threads in (pair, ray) order and in the kernel's cost order
    (a stable sort by cost class, dearest first). Printed (``pytest -s``)
    for ``PERF.md``; asserts only what must hold."""
    contours, centers, valid = ray_inputs(128, 128, seed=128)
    contours, centers, valid = contours[:16], centers[:16], valid[:16]
    rows = np.nonzero(valid)[0]
    pc = np.ascontiguousarray(contours[rows])
    got, work = model_rays(pc, centers[valid])
    np.testing.assert_array_equal(got, dense_rays(pc, centers[valid]))
    ang, _ = angles_and_distances(pc, centers[valid])
    per_thread = np.zeros(valid.shape + (polar.NUM_RAYS,), np.int64)
    cls = np.full(valid.shape + (polar.NUM_RAYS,), 7)  # invalid pairs cost nothing
    per_thread[valid] = work
    cls[valid] = np.stack([kernel_order(a) for a in ang])
    live = valid.reshape(16, -1, PAIRS_PER_BLOCK).any(-1)  # all-invalid blocks exit
    blocks = per_thread.reshape(16, -1, PAIRS_PER_BLOCK * polar.NUM_RAYS)[live]
    order = np.argsort(cls.reshape(16, -1, PAIRS_PER_BLOCK * polar.NUM_RAYS)[live], -1,
                       kind="stable")
    effs = []
    for b in (blocks, np.take_along_axis(blocks, order, -1)):
        warps = b.reshape(len(b), -1, 32)
        effs.append(warps.sum() / (32 * warps.max(-1)).sum())
    short = float((got == RAY_EPS).mean())
    print(f"\ntrain shape, {len(got)} valid pairs in {len(blocks)} live blocks: {short:.1%} of "
          f"rays end at the gate; points scanned per ray mean {work.mean():.2f}, max "
          f"{work.max()}; per live ray {work[got != RAY_EPS].mean():.2f}; phase-3 SIMT "
          f"efficiency {effs[0]:.1%} in (pair, ray) order, {effs[1]:.1%} in cost order")
    assert 0 < effs[0] < effs[1] <= 1 and work.mean() < 20
