"""The train-time augmentation on the device (counterpart of the JAX
package's ``data/device_augment.py``): mosaic-4, the affine (and
perspective) warp, MixUp, the flips and HSV, as batched tensor ops on the
batch's device. The host only letterboxes (``data/dataset.py:TrainDataset``).

It is split in two:

- ``draw_augment(rng, batch, hyp, imgsz)`` makes every random draw of one
  step on the host, from a ``numpy.random.Generator``: the mosaic partners,
  and per image the mosaic choice, its center, the affine terms, MixUp's
  choice, ratio (beta(32, 32)) and partner, the flips and the HSV gains.
  Every variable is drawn on every step, used or not, so the stream never
  depends on earlier outcomes. The draws are not JAX's; a test can build the
  same dict from the values a JAX key gives (``_augment_one`` and
  ``augment_batch`` split their key into these very draws).
- ``apply_augment(batch, draws, hyp, imgsz, n_out)`` is deterministic.

In data parallelism each rank augments its own rows (``engine/step.py``
draws from a generator keyed by the seed, the step and the rank), so the
mosaic and MixUp partners are rank-local, as JAX draws within each shard
(``fold_in(key, axis_index("batch"))``).

Mosaic and the warp are one gather, as in JAX's ``_warp_image``: each
output pixel is mapped back through the inverse affine onto the virtual
2S x 2S canvas, whose quadrant picks the tile and its offset (the
reference's corner-at-center placement), and is sampled bilinearly with the
gray border. The same gather serves the axis-aligned default, which JAX
resamples separably in bfloat16: here everything is float32, so an image
agrees with JAX's float32 warps to summation order and with its bfloat16
default to about one level. Labels: contours and box corners go through the
same 3x3 matrix; the 4 tiles' 4N instances are cut to ``n_out`` by validity,
then area (a stable sort: among equals the lowest index wins). Keypoints
(a pose batch) go through the same matrix; one warped outside the image
(x or y below 0 or above S) loses its visibility, and ``fliplr`` swaps the
left and right keypoints by ``hyp.flip_idx``.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

PAD_VALUE = 114.0  # the letterbox and warp border gray


def _f(hyp, name: str, default: float = 0.0) -> float:
    return float(getattr(hyp, name, default) or 0.0)


# ---------------------------------------------------------------------------
# the draws
# ---------------------------------------------------------------------------

def draw_augment(rng: np.random.Generator, batch: int, hyp, imgsz: int) -> Dict[str, np.ndarray]:
    """One step's random draws for ``batch`` images of ``imgsz``, from
    ``rng``, as numpy arrays (B = batch):

    - ``partners`` (B, 3) int: the mosaic's other three tiles, in-batch;
    - ``mosaic`` (B,) bool; ``center`` (B, 2) the mosaic center (y, x) in
      [0.5 S, 1.5 S);
    - ``perspective`` (B, 2), ``degrees`` (B,), ``scale`` (B,), ``shear``
      (B, 2) in degrees, ``translate`` (B, 2) (x, y) as fractions of S;
    - ``mixup`` (B,) bool, ``mixup_ratio`` (B,) beta(32, 32),
      ``mixup_partner`` (B,) int;
    - ``fliplr``, ``flipud`` (B,) bool; ``hsv`` (B, 3) uniform in [-1, 1).
    """
    B, S = int(batch), float(imgsz)
    persp, deg, scl = _f(hyp, "perspective"), _f(hyp, "degrees"), _f(hyp, "scale", 0.5)
    shr, trn = _f(hyp, "shear"), _f(hyp, "translate", 0.1)

    def uniform(lo, hi, shape):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    return {
        "partners": rng.integers(0, B, (B, 3)),
        "mosaic": rng.random(B) < _f(hyp, "mosaic", 1.0),
        "center": uniform(0.5 * S, 1.5 * S, (B, 2)),
        "perspective": uniform(-persp, persp, (B, 2)),
        "degrees": uniform(-deg, deg, (B,)),
        "scale": uniform(1.0 - scl, 1.0 + scl, (B,)),
        "shear": uniform(-shr, shr, (B, 2)),
        "translate": uniform(0.5 - trn, 0.5 + trn, (B, 2)),
        "mixup": rng.random(B) < _f(hyp, "mixup"),
        "mixup_ratio": rng.beta(32.0, 32.0, B).astype(np.float32),
        "mixup_partner": rng.integers(0, B, B),
        "fliplr": rng.random(B) < _f(hyp, "fliplr", 0.5),
        "flipud": rng.random(B) < _f(hyp, "flipud"),
        "hsv": uniform(-1.0, 1.0, (B, 3)),
    }


# ---------------------------------------------------------------------------
# color
# ---------------------------------------------------------------------------

def rgb_to_hsv(rgb: torch.Tensor):
    """rgb in [0, 1] (..., 3) -> h in [0, 1), s, v."""
    r, g, b = rgb.unbind(-1)
    mx = rgb.amax(-1)
    mn = rgb.amin(-1)
    d = mx - mn
    safe = torch.where(d > 0, d, torch.ones_like(d))
    h = torch.where(mx == r, torch.remainder((g - b) / safe, 6.0),
                    torch.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0)) / 6.0
    h = torch.where(d > 0, h, torch.zeros_like(h))
    s = torch.where(mx > 0, d / torch.where(mx > 0, mx, torch.ones_like(mx)), torch.zeros_like(mx))
    return h, s, mx


def hsv_to_rgb(h, s, v) -> torch.Tensor:
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*vals):
        out = vals[5]
        for k in (4, 3, 2, 1, 0):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], -1)


def hsv_jitter(img: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """Multiplicative HSV gains (B, 3) on RGB images (B, H, W, 3) in [0, 1];
    the hue wraps, saturation and value clip (the reference's LUTs)."""
    g = gains[:, None, None, :]
    h, s, v = rgb_to_hsv(img)
    h = torch.remainder(h * g[..., 0], 1.0)
    s = (s * g[..., 1]).clamp(0.0, 1.0)
    v = (v * g[..., 2]).clamp(0.0, 1.0)
    return hsv_to_rgb(h, s, v)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def _tile_offsets(yc, xc, content_hw, pads):
    """Canvas position (oy, ox) of each tile's (0, 0) pixel, (B, 4, 2): tile
    q's content corner nearest the mosaic center lands on (yc, xc).
    content_hw, pads (B, 4, 2) as (h, w) and (top, left)."""
    ch, cw = content_hw[..., 0], content_hw[..., 1]
    py, px = pads[..., 0], pads[..., 1]
    oy = torch.stack([yc - py[:, 0] - ch[:, 0], yc - py[:, 1] - ch[:, 1],
                      yc - py[:, 2], yc - py[:, 3]], -1)
    ox = torch.stack([xc - px[:, 0] - cw[:, 0], xc - px[:, 1],
                      xc - px[:, 2] - cw[:, 2], xc - px[:, 3]], -1)
    return torch.stack([oy, ox], -1)


def _affine_matrix(draws: Dict[str, np.ndarray], out_size: int, in_size: np.ndarray
                   ) -> np.ndarray:
    """(B, 3, 3) float32 ``T @ Sh @ R @ P @ C`` from the draws, on the host
    (JAX ``_affine_matrix_dyn``): C centers the (in_size)^2 input, P the
    perspective, R the rotation and scale, Sh the shear, T the translation
    into the out_size^2 output."""
    f32 = np.float32
    B = in_size.shape[0]

    def eye():
        return np.tile(np.eye(3, dtype=f32), (B, 1, 1))

    C = eye()
    C[:, 0, 2] = C[:, 1, 2] = -in_size.astype(f32) / f32(2.0)
    P = eye()
    P[:, 2, 0], P[:, 2, 1] = draws["perspective"][:, 0], draws["perspective"][:, 1]
    a = draws["degrees"].astype(f32) * f32(math.pi) / f32(180.0)
    sc = draws["scale"].astype(f32)
    ca, sa = np.cos(a) * sc, np.sin(a) * sc
    R = eye()
    R[:, 0, 0], R[:, 0, 1], R[:, 1, 0], R[:, 1, 1] = ca, sa, -sa, ca
    Sh = eye()
    shear = draws["shear"].astype(f32) * f32(math.pi) / f32(180.0)
    Sh[:, 0, 1], Sh[:, 1, 0] = np.tan(shear[:, 0]), np.tan(shear[:, 1])
    T = eye()
    T[:, 0, 2] = draws["translate"][:, 0] * f32(out_size)
    T[:, 1, 2] = draws["translate"][:, 1] * f32(out_size)
    return T @ Sh @ R @ P @ C


def _warp_images(tiles, Minv, yc, xc, offsets, use_mosaic, S: int) -> torch.Tensor:
    """Fused mosaic and warp, one gather: tiles (B, 4, S, S, 3) uint8 ->
    (B, S, S, 3) float32 (JAX ``_warp_image``, batched). Each output pixel
    (x, y) samples the canvas at ``Minv @ (x, y, 1)``; the canvas quadrant
    picks the tile (tile 0 without mosaic) and its offset; 4 bilinear taps,
    each outside its tile or the canvas reading the gray border."""
    B = tiles.shape[0]
    dev = tiles.device
    o = torch.arange(S, device=dev, dtype=torch.float32)
    xs, ys = o[None, None, :], o[None, :, None]
    m = Minv[:, :, :, None, None]

    def row(i):
        # XLA's rounding of this 3-term product on the CPU, which the JAX
        # gather takes: fma(m1, y, m0 * x) + m2 (the fma in float64 holds it
        # to one rounding)
        p = (m[:, i, 0] * xs).double() + m[:, i, 1].double() * ys.double()
        return p.float() + m[:, i, 2]

    c2 = row(2)
    cx, cy = row(0) / c2, row(1) / c2

    um = use_mosaic[:, None, None]
    L = torch.where(use_mosaic, 2.0 * S, 1.0 * S)[:, None, None]
    in_canvas = (cx >= 0) & (cx < L) & (cy >= 0) & (cy < L)
    q = torch.where(um, (cy >= yc[:, None, None]).long() * 2 + (cx >= xc[:, None, None]).long(),
                    torch.zeros_like(cx, dtype=torch.long))
    off = torch.gather(offsets, 1, q.reshape(B, -1, 1).expand(-1, -1, 2)).reshape(B, S, S, 2)
    sx = cx - off[..., 1]
    sy = cy - off[..., 0]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()

    flat = tiles.reshape(-1, 3)
    base = (torch.arange(B, device=dev)[:, None, None] * 4 + q) * (S * S)

    def tap(yi, xi):
        ok = (xi >= 0) & (xi < S) & (yi >= 0) & (yi < S) & in_canvas
        idx = base + yi.clamp(0, S - 1) * S + xi.clamp(0, S - 1)
        v = flat[idx.reshape(-1)].reshape(B, S, S, 3).to(torch.float32)
        return torch.where(ok[..., None], v, PAD_VALUE)

    top = tap(y0i, x0i) * (1 - fx) + tap(y0i, x0i + 1) * fx
    bot = tap(y0i + 1, x0i) * (1 - fx) + tap(y0i + 1, x0i + 1) * fx
    return top * (1 - fy) + bot * fy


def _warp_points(pts: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """(B, ..., 2) points through each batch entry's 3x3 (B, 3, 3),
    perspective-safe."""
    m = M.reshape(M.shape[0], *([1] * (pts.dim() - 2)), 3, 3)
    x, y = pts[..., 0], pts[..., 1]
    px = x * m[..., 0, 0] + y * m[..., 0, 1] + m[..., 0, 2]
    py = x * m[..., 1, 0] + y * m[..., 1, 1] + m[..., 1, 2]
    w = x * m[..., 2, 0] + y * m[..., 2, 1] + m[..., 2, 2]
    w = torch.where(w.abs() > 1e-9, w, torch.ones_like(w))
    return torch.stack([px / w, py / w], -1)


def _box_candidates(wh_before, wh_after, area_thr=0.01, wh_thr=2.0, ar_thr=100.0, eps=1e-16):
    """The keep filter after the warp (reference ``box_candidates``)."""
    w1, h1 = wh_before[..., 0], wh_before[..., 1]
    w2, h2 = wh_after[..., 0], wh_after[..., 1]
    ar = torch.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return (w2 > wh_thr) & (h2 > wh_thr) & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr)


def _take(a: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """a (B, K, ...) gathered along K by order (B, n)."""
    idx = order.reshape(order.shape + (1,) * (a.dim() - 2)).expand(order.shape + a.shape[2:])
    return torch.gather(a, 1, idx)


def _by_priority(keep: torch.Tensor, area: torch.Tensor, n_out: int) -> torch.Tensor:
    """(B, n_out) indices: valid first, then by area, largest first; a
    stable sort, so among equals the lowest index wins (``jnp.argsort``)."""
    prio = torch.where(keep, area + 1.0, torch.full_like(area, -1.0))
    return torch.sort(-prio, dim=1, stable=True).indices[:, :n_out]


# ---------------------------------------------------------------------------
# the batch transform
# ---------------------------------------------------------------------------

def apply_augment(batch: Dict[str, torch.Tensor], draws: Dict, hyp, imgsz: int, n_out: int
                  ) -> Dict[str, torch.Tensor]:
    """The device transform of one raw batch with the given draws (JAX
    ``augment_batch`` with ``_augment_one``, batched).

    batch: ``img`` (B, S, S, 3) uint8 BGR as the loader gives it, ``cls``
    (B, N), ``bboxes`` (B, N, 4) normalized xywh, ``segments`` (B, N, 360,
    2) normalized, ``mask_gt`` (B, N), ``content_hw`` and ``pad_tl`` (B, 2),
    and optionally ``keypoints`` (B, N, K, 3), xy normalized and a
    visibility. draws: ``draw_augment``'s dict of numpy arrays. Returns the
    batch the loss takes: ``img`` (B, S, S, 3) float32 RGB in [0, 1], and
    labels with ``n_out`` instances (with ``keypoints`` where given)."""
    S = int(imgsz)
    images = batch["img"]
    dev = images.device
    B, N = images.shape[0], batch["mask_gt"].shape[1]
    # the affine and its inverse (in float64: JAX's float32 LU differs from
    # it in the last bits) on the host, sent with the draws
    M_np = _affine_matrix(draws, S, np.where(draws["mosaic"], 2.0 * S, 1.0 * S))
    d = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in draws.items()}
    M = torch.from_numpy(M_np).to(dev)
    Minv = torch.from_numpy(np.linalg.inv(M_np.astype(np.float64)).astype(np.float32)).to(dev)

    # mosaic tiles: tile 0 is the sample itself, then its three partners
    sel = torch.cat([torch.arange(B, device=dev)[:, None], d["partners"].long()], 1)
    tiles = images[sel]
    t_cls, t_boxes = batch["cls"][sel], batch["bboxes"].float()[sel]
    t_segs, t_mask = batch["segments"].float()[sel], batch["mask_gt"].bool()[sel]
    t_chw, t_pad = batch["content_hw"].float()[sel], batch["pad_tl"].float()[sel]
    t_kpts = batch["keypoints"].float()[sel] if "keypoints" in batch else None

    use_mosaic = d["mosaic"].bool()
    zero = torch.zeros((), device=dev)
    yc = torch.where(use_mosaic, d["center"][:, 0], zero)
    xc = torch.where(use_mosaic, d["center"][:, 1], zero)
    offs = torch.where(use_mosaic[:, None, None], _tile_offsets(yc, xc, t_chw, t_pad), zero)
    img = _warp_images(tiles, Minv, yc, xc, offs, use_mosaic, S)

    # labels: tile frame -> canvas -> output, each tile shifted by its offset
    tile_valid = t_mask & (use_mosaic[:, None, None]
                           | (torch.arange(4, device=dev) == 0)[None, :, None])
    shift = offs.flip(-1)  # (ox, oy)
    segs_canvas = t_segs * S + shift[:, :, None, None, :]
    has_seg = t_segs.abs().sum((-1, -2)) > 1e-6  # (B, 4, N)
    bx = t_boxes * S
    box_min = bx[..., :2] - bx[..., 2:] / 2 + shift[:, :, None, :]
    box_max = bx[..., :2] + bx[..., 2:] / 2 + shift[:, :, None, :]
    pre_min = torch.where(has_seg[..., None], segs_canvas.amin(-2), box_min)
    pre_max = torch.where(has_seg[..., None], segs_canvas.amax(-2), box_max)
    wh_before = pre_max - pre_min

    segs_out = _warp_points(segs_canvas, M).clamp(0.0, S)
    c4 = torch.stack([box_min, torch.stack([box_max[..., 0], box_min[..., 1]], -1),
                      box_max, torch.stack([box_min[..., 0], box_max[..., 1]], -1)], -2)
    c4w = _warp_points(c4, M)
    out_min = torch.where(has_seg[..., None], segs_out.amin(-2), c4w.amin(-2).clamp(0.0, S))
    out_max = torch.where(has_seg[..., None], segs_out.amax(-2), c4w.amax(-2).clamp(0.0, S))
    wh_after = out_max - out_min
    keep = tile_valid & _box_candidates(wh_before, wh_after)
    out_boxes = torch.cat([(out_min + out_max) / 2, out_max - out_min], -1)
    if t_kpts is not None:  # px; a keypoint warped out of the image is not visible
        kxy = _warp_points(t_kpts[..., :2] * S + shift[:, :, None, None, :], M)
        out_of = (kxy[..., 0] < 0) | (kxy[..., 0] > S) | (kxy[..., 1] < 0) | (kxy[..., 1] > S)
        kvis = torch.where(out_of, torch.zeros_like(t_kpts[..., 2]), t_kpts[..., 2])

    # merge the 4 tiles' 4N instances -> n_out by validity, then area
    def flat(a):
        return a.reshape((B, 4 * N) + a.shape[3:])

    keep_f = flat(keep)
    order = _by_priority(keep_f, flat(wh_after[..., 0] * wh_after[..., 1]), n_out)
    out = {"cls": _take(flat(t_cls), order), "bboxes": _take(flat(out_boxes), order) / S,
           "segments": _take(flat(segs_out), order) / S, "mask_gt": _take(keep_f, order)}
    if t_kpts is not None:
        out["keypoints"] = torch.cat([_take(flat(kxy), order) / S,
                                      _take(flat(kvis), order)[..., None]], -1)
    geometry = [k for k in ("bboxes", "segments", "keypoints") if k in out]

    img = img.flip(-1) / 255.0  # BGR -> RGB

    # MixUp: a beta(32, 32) blend with an in-batch partner, labels united
    if _f(hyp, "mixup") > 0:
        do, r, pidx = d["mixup"].bool(), d["mixup_ratio"].float(), d["mixup_partner"].long()
        r4 = r[:, None, None, None]
        img = torch.where(do[:, None, None, None], img * r4 + img[pidx] * (1 - r4), img)
        m2 = torch.cat([out["mask_gt"], out["mask_gt"][pidx] & do[:, None]], 1)
        area = out["bboxes"][..., 2] * out["bboxes"][..., 3]
        order = _by_priority(m2, torch.cat([area, area[pidx]], 1), n_out)
        for k in ("cls", *geometry):
            out[k] = _take(torch.cat([out[k], out[k][pidx]], 1), order)
        out["mask_gt"] = _take(m2, order)

    # flips
    for key, axis, coord in (("fliplr", 2, 0), ("flipud", 1, 1)):
        if _f(hyp, key, 0.5 if key == "fliplr" else 0.0) > 0:
            do = d[key].bool()
            img = torch.where(do[:, None, None, None], img.flip(axis), img)
            for k in geometry:
                v = out[k].clone()
                m = do.reshape(-1, *([1] * (v.dim() - 2)))
                v[..., coord] = torch.where(m, 1.0 - v[..., coord], v[..., coord])
                out[k] = v
            flip_idx = getattr(hyp, "flip_idx", None)
            if key == "fliplr" and flip_idx and "keypoints" in out:
                k = out["keypoints"]
                kf = k[:, :, torch.as_tensor(list(flip_idx), device=dev).long()]
                out["keypoints"] = torch.where(do[:, None, None, None], kf, k)

    # HSV, pixels only
    if any(_f(hyp, f"hsv_{c}") > 0 for c in "hsv"):
        scale = torch.tensor([_f(hyp, "hsv_h"), _f(hyp, "hsv_s"), _f(hyp, "hsv_v")], device=dev)
        img = hsv_jitter(img, d["hsv"].float() * scale + 1.0)

    res = {"img": img.to(torch.float32), "cls": out["cls"].to(torch.int32),
           "bboxes": out["bboxes"], "segments": out["segments"], "mask_gt": out["mask_gt"]}
    if "keypoints" in out:
        res["keypoints"] = out["keypoints"]
    return res


def make_augment_fn(hyp, imgsz: int, max_instances: int):
    """The step's transform ``fn(rng, images_u8, labels) -> (images,
    labels)``: ``draw_augment`` from ``rng`` (a ``numpy.random.Generator``),
    then ``apply_augment`` with ``n_out = min(4 * n_in, max_instances)``,
    ``n_in`` being the batch's padded instance count."""

    def fn(rng: np.random.Generator, images: torch.Tensor, labels: Dict[str, torch.Tensor]):
        n_out = min(4 * int(labels["mask_gt"].shape[-1]), int(max_instances))
        draws = draw_augment(rng, images.shape[0], hyp, imgsz)
        out = apply_augment({**labels, "img": images}, draws, hyp, imgsz, n_out)
        return out.pop("img"), out

    return fn


def normalize_batch(images_u8: torch.Tensor) -> torch.Tensor:
    """The transform without augmentation: uint8 BGR (B, S, S, 3) -> float32
    RGB in [0, 1]."""
    return images_u8.to(torch.float32).flip(-1) / 255.0
