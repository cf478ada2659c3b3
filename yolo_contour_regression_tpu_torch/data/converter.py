"""COCO json to YOLO label files (counterpart of the JAX package's
``data/converter.py``), numpy and the standard library: the 91 -> 80 class
map, RLE decoding (uncompressed counts and pycocotools' compressed string)
and encoding, masks to polygons by the port's contour finder
(``ops/contours.py``, cv2's ``findContours`` rule), the merge of polygon
parts, and ``convert_coco``. Its output is the JAX converter's, byte for
byte.
"""
from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..ops.contours import find_contours_external


def coco91_to_coco80_class() -> List[Optional[int]]:
    """The 91 COCO category ids (0-based) to the 80 used ids; None for the
    11 unused."""
    x = [None] * 91
    idx80 = 0
    # the 11 unused COCO ids
    missing = {11, 25, 28, 29, 44, 65, 67, 68, 70, 82, 90}
    for i in range(91):
        if (i + 1) in missing:
            continue
        x[i] = idx80
        idx80 += 1
    return x


def rle_to_mask(rle, h: int, w: int) -> np.ndarray:
    """COCO RLE (counts list or compressed LEB128 string) -> (h, w) uint8."""
    counts = rle["counts"] if isinstance(rle, dict) else rle
    if isinstance(counts, str):
        counts = _decode_compressed_rle(counts.encode())
    elif isinstance(counts, bytes):
        counts = _decode_compressed_rle(counts)
    mask = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for c in counts:
        if val:
            mask[pos : pos + c] = 1
        pos += c
        val ^= 1
    return mask.reshape(w, h).T  # COCO RLE is column-major


def _decode_compressed_rle(s: bytes) -> List[int]:
    """COCO's LEB128-style compressed RLE (pycocotools rleFrString)."""
    counts, p = [], 0
    while p < len(s):
        x, k, more = 0, 0, True
        while more:
            c = s[p] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def mask_to_rle(mask: np.ndarray) -> dict:
    """(h, w) binary mask -> COCO uncompressed RLE dict (column-major counts),
    the inverse of ``rle_to_mask``."""
    h, w = mask.shape
    flat = np.asarray(mask, bool).T.reshape(-1)  # column-major
    # run-length: counts alternate 0-runs and 1-runs, starting with zeros
    change = np.nonzero(np.diff(flat))[0] + 1
    pos = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(pos).tolist()
    if flat.size and flat[0]:  # must start with a zero-run
        counts = [0] + counts
    return {"size": [int(h), int(w)], "counts": [int(c) for c in counts]}


def mask_to_polygons(mask: np.ndarray, min_points: int = 6) -> List[np.ndarray]:
    """The mask's outer contours (cv2's ``findContours`` rule) of at least
    ``min_points`` coordinates (3 points), (n, 2) float32."""
    cs = find_contours_external(mask.astype(np.uint8))
    return [c.reshape(-1, 2).astype(np.float32) for c in cs if c.size >= min_points]


def merge_multi_segment(segments: List[np.ndarray]) -> np.ndarray:
    """Connect polygon parts into one: greedily the part nearest to what is
    merged, joined at their closest points and back."""
    if len(segments) == 1:
        return segments[0]
    merged = segments[0]
    rest = list(segments[1:])
    while rest:
        dists = [
            np.linalg.norm(merged[:, None] - s[None, :], axis=-1).min() for s in rest
        ]
        j = int(np.argmin(dists))
        s = rest.pop(j)
        d = np.linalg.norm(merged[:, None] - s[None, :], axis=-1)
        mi, si = np.unravel_index(d.argmin(), d.shape)
        merged = np.concatenate(
            [merged[: mi + 1], s[si:], s[: si + 1], merged[mi:]], 0
        )
    return merged


def convert_coco(
    labels_dir: str,
    save_dir: str = "coco_converted",
    use_segments: bool = True,
    cls91to80: bool = True,
):
    """Each ``*.json`` of COCO instances in ``labels_dir`` -> YOLO label
    files under ``save_dir/labels/<json stem without instances_>/``: a
    line an annotation, the class (91 -> 80 with ``cls91to80``) and its
    polygon normalized to 6 decimals (RLE masks by their outer contours,
    parts merged), or its box without ``use_segments``; crowd entries
    without RLE are skipped. Returns ``save_dir``."""
    save_dir = Path(save_dir)
    remap = coco91_to_coco80_class()
    for json_file in sorted(Path(labels_dir).glob("*.json")):
        out_dir = save_dir / "labels" / json_file.stem.replace("instances_", "")
        out_dir.mkdir(parents=True, exist_ok=True)
        data = json.loads(json_file.read_text())
        images = {img["id"]: img for img in data["images"]}
        anns = defaultdict(list)
        for a in data["annotations"]:
            anns[a["image_id"]].append(a)
        for img_id, img in images.items():
            h, w = img["height"], img["width"]
            lines = []
            for a in anns.get(img_id, []):
                if a.get("iscrowd", 0) and not isinstance(a.get("segmentation"), dict):
                    continue
                cid = a["category_id"] - 1
                cls = remap[cid] if cls91to80 else cid
                if cls is None:
                    continue
                seg = a.get("segmentation")
                if use_segments and seg:
                    if isinstance(seg, dict):  # RLE
                        polys = mask_to_polygons(rle_to_mask(seg, h, w))
                        if not polys:
                            continue
                        poly = merge_multi_segment(polys)
                    else:
                        polys = [np.asarray(s, np.float32).reshape(-1, 2) for s in seg]
                        poly = merge_multi_segment(polys)
                    poly = poly / np.asarray([w, h], np.float32)
                    vals = " ".join(f"{v:.6f}" for v in poly.reshape(-1))
                    lines.append(f"{cls} {vals}")
                else:
                    x, y, bw, bh = a["bbox"]
                    cx, cy = (x + bw / 2) / w, (y + bh / 2) / h
                    lines.append(f"{cls} {cx:.6f} {cy:.6f} {bw / w:.6f} {bh / h:.6f}")
            name = Path(img["file_name"]).with_suffix(".txt").name
            (out_dir / name).write_text("\n".join(lines))
    return str(save_dir)
