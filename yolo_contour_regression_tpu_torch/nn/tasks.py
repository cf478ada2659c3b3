"""Model config -> NCHW ``nn.Module`` graph (counterpart of the JAX
package's ``nn/tasks.py``).

``parse_model`` applies the same scaling rules as the JAX version: depth
gain ``n = max(round(n * depth), 1)``, width gain ``c2 = make_divisible(
min(c2, max_ch) * width, 8)`` except for the nc passthrough, and the scale
letter from the config's ``scales`` block. It works on a config **dict** (a
checkpoint's ``model_yaml``, or ``YOLOV8_SEG`` and ``YOLOV8`` below), so no
yaml parser is needed. Layers are registered as ``model.{i}`` so the
state-dict keys are the reference's. Strides are tracked through the graph
(a transposed conv divides by its stride, Focus's space-to-depth doubles
it) instead of calibrated by a dummy forward.

Six task models: ``SegmentationModel`` (the polar ``Segment`` head),
``DetectionModel`` (the stock ``Detect`` head with DFL), ``PoseModel``
(the ``Pose`` head: ``Detect`` and a keypoint branch),
``SegmentationOriModel`` (the proto-mask ``Segmentori`` head: ``Detect``,
mask coefficients and prototypes), ``ClassificationModel`` (the
``Classify`` head) and ``RTDETRDetectionModel`` (the ``RTDETRDecoder``
head); ``build_model`` picks one by the config's head
(``guess_model_task``).
``yaml_model_load`` maps a model name to its config dict (``MODEL_CFGS``:
every yaml of the JAX package; ``yolo_nas_s`` is ``YOLO_NAS``, YOLO-NAS's
graph on the ``Detect`` head, at scale ``s``),
and ``init_weights`` gives a fresh model the JAX package's initialization.
"""
from __future__ import annotations

import copy
import inspect
import math
import re
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from .modules import block as block_mod
from .modules import conv as conv_mod
from .modules import head as head_mod
from .modules import transformer as tr_mod

# cfg/models/yolov8-seg.yaml of the JAX package as a dict: RepConv/RepBlock
# backbone, SPPF, Conv2 PAN neck and the polar Segment head (36 rays).
YOLOV8_SEG: Dict[str, Any] = {
    "nc": 10,
    "scales": {
        "n": [0.33, 0.25, 1024],
        "s": [0.33, 0.50, 1024],
        "m": [0.67, 0.75, 768],
        "l": [1.00, 1.00, 512],
        "x": [1.00, 1.25, 512],
    },
    "backbone": [
        [-1, 1, "RepConv", [64, 3, 2]],  # 0 P1/2
        [-1, 1, "RepConv", [128, 3, 2]],  # 1 P2/4
        [-1, 3, "RepBlock", [128, True]],  # 2
        [-1, 1, "RepConv", [256, 3, 2]],  # 3 P3/8
        [-1, 6, "RepBlock", [256, True]],  # 4
        [-1, 1, "RepConv", [512, 3, 2]],  # 5 P4/16
        [-1, 6, "RepBlock", [512, True]],  # 6
        [-1, 1, "RepConv", [1024, 3, 2]],  # 7 P5/32
        [-1, 3, "RepBlock", [1024, True]],  # 8
        [-1, 1, "SPPF", [1024, 5]],  # 9
    ],
    "head": [
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],  # 10
        [[-1, 6], 1, "Concat", [1]],  # 11 cat backbone P4
        [-1, 3, "Conv2", [512]],  # 12
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],  # 13
        [[-1, 4], 1, "Concat", [1]],  # 14 cat backbone P3
        [-1, 3, "Conv2", [256]],  # 15 P3/8-small
        [-1, 1, "RepConv", [256, 3, 2]],  # 16
        [[-1, 12], 1, "Concat", [1]],  # 17 cat head P4
        [-1, 3, "Conv2", [512]],  # 18 P4/16-medium
        [-1, 1, "RepConv", [512, 3, 2]],  # 19
        [[-1, 9], 1, "Concat", [1]],  # 20 cat head P5
        [-1, 3, "Conv2", [1024]],  # 21 P5/32-large
        [[15, 18, 21], 1, "Segment", ["nc", 36, 256]],  # 22 polar Segment(P3, P4, P5)
    ],
    "scale": "n",
}

# cfg/models/yolov8.yaml of the JAX package as a dict: the stock YOLOv8
# detect graph, a C2f backbone and neck and the Detect (DFL) head.
YOLOV8: Dict[str, Any] = {
    "nc": 80,
    "scales": copy.deepcopy(YOLOV8_SEG["scales"]),
    "backbone": [
        [-1, 1, "Conv", [64, 3, 2]],  # 0 P1/2
        [-1, 1, "Conv", [128, 3, 2]],  # 1 P2/4
        [-1, 3, "C2f", [128, True]],  # 2
        [-1, 1, "Conv", [256, 3, 2]],  # 3 P3/8
        [-1, 6, "C2f", [256, True]],  # 4
        [-1, 1, "Conv", [512, 3, 2]],  # 5 P4/16
        [-1, 6, "C2f", [512, True]],  # 6
        [-1, 1, "Conv", [1024, 3, 2]],  # 7 P5/32
        [-1, 3, "C2f", [1024, True]],  # 8
        [-1, 1, "SPPF", [1024, 5]],  # 9
    ],
    "head": [
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],  # 10
        [[-1, 6], 1, "Concat", [1]],  # 11
        [-1, 3, "C2f", [512]],  # 12
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],  # 13
        [[-1, 4], 1, "Concat", [1]],  # 14
        [-1, 3, "C2f", [256]],  # 15 P3/8-small
        [-1, 1, "Conv", [256, 3, 2]],  # 16
        [[-1, 12], 1, "Concat", [1]],  # 17
        [-1, 3, "C2f", [512]],  # 18 P4/16-medium
        [-1, 1, "Conv", [512, 3, 2]],  # 19
        [[-1, 9], 1, "Concat", [1]],  # 20
        [-1, 3, "C2f", [1024]],  # 21 P5/32-large
        [[15, 18, 21], 1, "Detect", ["nc"]],  # 22 Detect(P3, P4, P5)
    ],
}

# cfg/models/yolov8-pose.yaml of the JAX package as a dict: the yolov8 graph
# with the Pose head, nc 1 and COCO's 17 keypoints (x, y, visibility)
YOLOV8_POSE: Dict[str, Any] = {
    "nc": 1,
    "kpt_shape": [17, 3],
    "scales": copy.deepcopy(YOLOV8_SEG["scales"]),
    "backbone": copy.deepcopy(YOLOV8["backbone"]),
    "head": copy.deepcopy(YOLOV8["head"][:-1]) + [
        [[15, 18, 21], 1, "Pose", ["nc", "kpt_shape"]],  # 22 Pose(P3, P4, P5)
    ],
}

# cfg/models/yolov8-segori.yaml of the JAX package as a dict: the yolov8
# graph with the stock proto-mask head, 32 prototypes of 256 channels (the
# JAX parser scales neither)
YOLOV8_SEGORI: Dict[str, Any] = {
    "nc": 9,
    "scales": copy.deepcopy(YOLOV8_SEG["scales"]),
    "backbone": copy.deepcopy(YOLOV8["backbone"]),
    "head": copy.deepcopy(YOLOV8["head"][:-1]) + [
        [[15, 18, 21], 1, "Segmentori", ["nc", 32, 256]],  # 22 Segmentori(P3, P4, P5)
    ],
}

# cfg/models/yolov8-cls.yaml of the JAX package as a dict: the C2f backbone
# without SPPF and the Classify head, nc 2 (the fork's)
YOLOV8_CLS: Dict[str, Any] = {
    "nc": 2,
    "scales": copy.deepcopy(YOLOV8_SEG["scales"]),
    "backbone": copy.deepcopy(YOLOV8["backbone"][:9]),
    "head": [[-1, 1, "Classify", ["nc"]]],  # 9
}

# cfg/models/yolov8-rtdetr.yaml of the JAX package as a dict: the yolov8
# graph with the RT-DETR decoder head (hd 256, nq 300, 8 heads, 4 points, 6
# layers, d_ffn 1024, the JAX module's defaults)
YOLOV8_RTDETR: Dict[str, Any] = {
    "nc": 80,
    "scales": copy.deepcopy(YOLOV8_SEG["scales"]),
    "backbone": copy.deepcopy(YOLOV8["backbone"]),
    "head": copy.deepcopy(YOLOV8["head"][:-1]) + [
        [[15, 18, 21], 1, "RTDETRDecoder", ["nc"]],  # 22
    ],
}

# cfg/models/rtdetr-l.yaml of the JAX package as a dict (its strings as YAML
# reads them): PPHGNetV2 backbone, AIFI encoder, RepC3 neck, the RT-DETR
# decoder at 256 channels
RTDETR_L: Dict[str, Any] = {
    "nc": 80,
    "scales": {"l": [1.0, 1.0, 1024]},
    "backbone": [
        [-1, 1, "HGStem", [32, 48]],  # 0 P2/4
        [-1, 6, "HGBlock", [48, 128, 3]],
        [-1, 1, "DWConv", [128, 3, 2, 1, False]],  # 2 P3/8
        [-1, 6, "HGBlock", [96, 512, 3]],
        [-1, 1, "DWConv", [512, 3, 2, 1, False]],  # 4 P4/16
        [-1, 6, "HGBlock", [192, 1024, 5, True, False]],
        [-1, 6, "HGBlock", [192, 1024, 5, True, True]],
        [-1, 6, "HGBlock", [192, 1024, 5, True, True]],
        [-1, 1, "DWConv", [1024, 3, 2, 1, False]],  # 8 P5/32
        [-1, 6, "HGBlock", [384, 2048, 5, True, False]],
    ],
    "head": [
        [-1, 1, "Conv", [256, 1, 1, "None", 1, 1, False]],  # 10
        [-1, 1, "AIFI", [1024, 8]],
        [-1, 1, "Conv", [256, 1, 1]],  # 12 Y5
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [7, 1, "Conv", [256, 1, 1, "None", 1, 1, False]],
        [[-2, -1], 1, "Concat", [1]],
        [-1, 3, "RepC3", [256]],
        [-1, 1, "Conv", [256, 1, 1]],  # 17 Y4
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [3, 1, "Conv", [256, 1, 1, "None", 1, 1, False]],
        [[-2, -1], 1, "Concat", [1]],
        [-1, 3, "RepC3", [256]],  # 21 X3
        [-1, 1, "Conv", [256, 3, 2]],
        [[-1, 17], 1, "Concat", [1]],
        [-1, 3, "RepC3", [256]],  # 24 F4
        [-1, 1, "Conv", [256, 3, 2]],
        [[-1, 12], 1, "Concat", [1]],
        [-1, 3, "RepC3", [256]],  # 27 F5
        [[21, 24, 27], 1, "RTDETRDecoder", ["nc"]],  # 28
    ],
}

# cfg/models/yolo_nas.yaml of the JAX package as a dict: the YOLO-NAS graph
# rebuilt from its published topology, a RepConv stem and four [RepConv-down
# + NASCSP] stages (depths 2/3/5/2), SPP(5, 9, 13), a PAN neck of NASCSPs and
# the DFL Detect head; scales s, m and l
YOLO_NAS: Dict[str, Any] = {
    "nc": 80,
    "scales": {"s": [1.00, 1.00, 768], "m": [1.33, 1.25, 960], "l": [1.67, 1.50, 1152]},
    "backbone": [
        [-1, 1, "RepConv", [48, 3, 2]],  # 0 stem P1/2
        [-1, 1, "RepConv", [96, 3, 2]],  # 1 P2/4
        [-1, 2, "NASCSP", [96, True]],  # 2
        [-1, 1, "RepConv", [192, 3, 2]],  # 3 P3/8
        [-1, 3, "NASCSP", [192, True]],  # 4
        [-1, 1, "RepConv", [384, 3, 2]],  # 5 P4/16
        [-1, 5, "NASCSP", [384, True]],  # 6
        [-1, 1, "RepConv", [768, 3, 2]],  # 7 P5/32
        [-1, 2, "NASCSP", [768, True]],  # 8
        [-1, 1, "SPP", [768, [5, 9, 13]]],  # 9
    ],
    "head": [
        [-1, 1, "Conv", [192, 1, 1]],  # 10 reduce
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 6], 1, "Concat", [1]],
        [-1, 2, "NASCSP", [192]],  # 13
        [-1, 1, "Conv", [96, 1, 1]],  # 14 reduce
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 4], 1, "Concat", [1]],
        [-1, 2, "NASCSP", [96]],  # 17 P3/8-small
        [-1, 1, "RepConv", [96, 3, 2]],
        [[-1, 13], 1, "Concat", [1]],
        [-1, 2, "NASCSP", [192]],  # 20 P4/16-medium
        [-1, 1, "RepConv", [192, 3, 2]],
        [[-1, 9], 1, "Concat", [1]],
        [-1, 2, "NASCSP", [384]],  # 23 P5/32-large
        [[17, 20, 23], 1, "Detect", ["nc"]],  # 24
    ],
}

# cfg/models/yolov3.yaml of the JAX package as a dict: Darknet-53's
# Bottleneck backbone and the YOLOv3 neck on the Detect head; one scale,
# through depth_multiple and width_multiple
YOLOV3: Dict[str, Any] = {
    "nc": 80,
    "depth_multiple": 1.0,
    "width_multiple": 1.0,
    "backbone": [
        [-1, 1, "Conv", [32, 3, 1]],  # 0
        [-1, 1, "Conv", [64, 3, 2]],  # 1 P1/2
        [-1, 1, "Bottleneck", [64]],
        [-1, 1, "Conv", [128, 3, 2]],  # 3 P2/4
        [-1, 2, "Bottleneck", [128]],
        [-1, 1, "Conv", [256, 3, 2]],  # 5 P3/8
        [-1, 8, "Bottleneck", [256]],
        [-1, 1, "Conv", [512, 3, 2]],  # 7 P4/16
        [-1, 8, "Bottleneck", [512]],
        [-1, 1, "Conv", [1024, 3, 2]],  # 9 P5/32
        [-1, 4, "Bottleneck", [1024]],  # 10
    ],
    "head": [
        [-1, 1, "Bottleneck", [1024, False]],  # 11
        [-1, 1, "Conv", [512, 1, 1]],
        [-1, 1, "Conv", [1024, 3, 1]],
        [-1, 1, "Conv", [512, 1, 1]],
        [-1, 1, "Conv", [1024, 3, 1]],  # 15 P5/32-large
        [-2, 1, "Conv", [256, 1, 1]],
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 8], 1, "Concat", [1]],
        [-1, 1, "Bottleneck", [512, False]],
        [-1, 1, "Bottleneck", [512, False]],
        [-1, 1, "Conv", [256, 1, 1]],
        [-1, 1, "Conv", [512, 3, 1]],  # 22 P4/16-medium
        [-2, 1, "Conv", [128, 1, 1]],
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 6], 1, "Concat", [1]],
        [-1, 1, "Bottleneck", [256, False]],
        [-1, 2, "Bottleneck", [256, False]],  # 27 P3/8-small
        [[27, 22, 15], 1, "Detect", ["nc"]],  # 28
    ],
}

# cfg/models/yolov5.yaml of the JAX package as a dict: a 6x6 stem, C3
# stages, SPPF, a C3 PAN neck and the Detect head
YOLOV5: Dict[str, Any] = {
    "nc": 80,
    "scales": {
        "n": [0.33, 0.25, 1024],
        "s": [0.33, 0.50, 1024],
        "m": [0.67, 0.75, 1024],
        "l": [1.00, 1.00, 1024],
        "x": [1.33, 1.25, 1024],
    },
    "backbone": [
        [-1, 1, "Conv", [64, 6, 2, 2]],  # 0 P1/2
        [-1, 1, "Conv", [128, 3, 2]],  # 1 P2/4
        [-1, 3, "C3", [128]],
        [-1, 1, "Conv", [256, 3, 2]],  # 3 P3/8
        [-1, 6, "C3", [256]],
        [-1, 1, "Conv", [512, 3, 2]],  # 5 P4/16
        [-1, 9, "C3", [512]],
        [-1, 1, "Conv", [1024, 3, 2]],  # 7 P5/32
        [-1, 3, "C3", [1024]],
        [-1, 1, "SPPF", [1024, 5]],  # 9
    ],
    "head": [
        [-1, 1, "Conv", [512, 1, 1]],  # 10
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 6], 1, "Concat", [1]],
        [-1, 3, "C3", [512, False]],  # 13
        [-1, 1, "Conv", [256, 1, 1]],  # 14
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 4], 1, "Concat", [1]],
        [-1, 3, "C3", [256, False]],  # 17 P3/8
        [-1, 1, "Conv", [256, 3, 2]],
        [[-1, 14], 1, "Concat", [1]],
        [-1, 3, "C3", [512, False]],  # 20 P4/16
        [-1, 1, "Conv", [512, 3, 2]],
        [[-1, 10], 1, "Concat", [1]],
        [-1, 3, "C3", [1024, False]],  # 23 P5/32
        [[17, 20, 23], 1, "Detect", ["nc"]],  # 24
    ],
}

# cfg/models/yolov6.yaml of the JAX package as a dict: repeated 3x3 Conv
# stages, SPPF, a neck upsampling by raw transposed convs (no BN, a bias)
# and the Detect head
YOLOV6: Dict[str, Any] = {
    "nc": 80,
    "scales": copy.deepcopy(YOLOV8_SEG["scales"]),
    "backbone": [
        [-1, 1, "Conv", [64, 3, 2]],  # 0 P1/2
        [-1, 1, "Conv", [128, 3, 2]],  # 1 P2/4
        [-1, 6, "Conv", [128, 3, 1]],
        [-1, 1, "Conv", [256, 3, 2]],  # 3 P3/8
        [-1, 12, "Conv", [256, 3, 1]],
        [-1, 1, "Conv", [512, 3, 2]],  # 5 P4/16
        [-1, 18, "Conv", [512, 3, 1]],
        [-1, 1, "Conv", [1024, 3, 2]],  # 7 P5/32
        [-1, 6, "Conv", [1024, 3, 1]],
        [-1, 1, "SPPF", [1024, 5]],  # 9
    ],
    "head": [
        [-1, 1, "Conv", [256, 1, 1]],  # 10
        [-1, 1, "nn.ConvTranspose2d", [256, 2, 2, 0]],
        [[-1, 6], 1, "Concat", [1]],
        [-1, 1, "Conv", [256, 3, 1]],
        [-1, 9, "Conv", [256, 3, 1]],  # 14
        [-1, 1, "Conv", [128, 1, 1]],  # 15
        [-1, 1, "nn.ConvTranspose2d", [128, 2, 2, 0]],
        [[-1, 4], 1, "Concat", [1]],
        [-1, 1, "Conv", [128, 3, 1]],
        [-1, 9, "Conv", [128, 3, 1]],  # 19
        [-1, 1, "Conv", [128, 3, 2]],
        [[-1, 15], 1, "Concat", [1]],
        [-1, 1, "Conv", [256, 3, 1]],
        [-1, 9, "Conv", [256, 3, 1]],  # 23
        [-1, 1, "Conv", [256, 3, 2]],
        [[-1, 10], 1, "Concat", [1]],
        [-1, 1, "Conv", [512, 3, 1]],
        [-1, 9, "Conv", [512, 3, 1]],  # 27
        [[19, 23, 27], 1, "Detect", ["nc"]],  # 28
    ],
}

# cfg/models/yolov8-det-rep.yaml of the JAX package as a dict: the yolov8-seg
# RepConv/RepBlock graph (one RepBlock a stage, one Conv2 a neck stage) on
# the Detect head, nc 1; its scale n is its own (0.05, 0.1, 512)
YOLOV8_DET_REP: Dict[str, Any] = {
    "nc": 1,
    "scales": {
        "n": [0.05, 0.1, 512],
        "s": [0.33, 0.50, 1024],
        "m": [0.67, 0.75, 768],
        "l": [1.00, 1.00, 512],
        "x": [1.00, 1.25, 512],
    },
    "backbone": [[f, 1, m, copy.deepcopy(a)] for f, _, m, a in YOLOV8_SEG["backbone"]],
    "head": [
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 6], 1, "Concat", [1]],
        [-1, 1, "Conv2", [512]],  # 12
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 4], 1, "Concat", [1]],
        [-1, 1, "Conv2", [256]],  # 15 P3/8-small
        [-1, 1, "Conv", [256, 3, 2]],
        [[-1, 12], 1, "Concat", [1]],
        [-1, 1, "Conv2", [512]],  # 18 P4/16-medium
        [-1, 1, "Conv", [512, 3, 2]],
        [[-1, 9], 1, "Concat", [1]],
        [-1, 1, "Conv2", [1024]],  # 21 P5/32-large
        [[15, 18, 21], 1, "Detect", ["nc"]],  # 22
    ],
}

# cfg/models/yolov8-p2.yaml of the JAX package as a dict: the yolov8 graph
# with a P2/4 output level, four levels (strides 4-32)
YOLOV8_P2: Dict[str, Any] = {
    "nc": 80,
    "scales": copy.deepcopy(YOLOV8_SEG["scales"]),
    "backbone": copy.deepcopy(YOLOV8["backbone"]),
    "head": copy.deepcopy(YOLOV8["head"][:6]) + [
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 2], 1, "Concat", [1]],
        [-1, 3, "C2f", [128]],  # 18 P2/4-xsmall
        [-1, 1, "Conv", [128, 3, 2]],
        [[-1, 15], 1, "Concat", [1]],
        [-1, 3, "C2f", [256]],  # 21 P3/8-small
        [-1, 1, "Conv", [256, 3, 2]],
        [[-1, 12], 1, "Concat", [1]],
        [-1, 3, "C2f", [512]],  # 24 P4/16-medium
        [-1, 1, "Conv", [512, 3, 2]],
        [[-1, 9], 1, "Concat", [1]],
        [-1, 3, "C2f", [1024]],  # 27 P5/32-large
        [[18, 21, 24, 27], 1, "Detect", ["nc"]],  # 28
    ],
}

# cfg/models/yolov8-p6.yaml of the JAX package as a dict: the yolov8
# backbone with a P6/64 stage and a C2 neck, four levels (strides 8-64)
YOLOV8_P6: Dict[str, Any] = {
    "nc": 80,
    "scales": copy.deepcopy(YOLOV8_SEG["scales"]),
    "backbone": copy.deepcopy(YOLOV8["backbone"][:7]) + [
        [-1, 1, "Conv", [768, 3, 2]],  # 7 P5/32
        [-1, 3, "C2f", [768, True]],
        [-1, 1, "Conv", [1024, 3, 2]],  # 9 P6/64
        [-1, 3, "C2f", [1024, True]],
        [-1, 1, "SPPF", [1024, 5]],  # 11
    ],
    "head": [
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 8], 1, "Concat", [1]],
        [-1, 3, "C2", [768, False]],  # 14
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 6], 1, "Concat", [1]],
        [-1, 3, "C2", [512, False]],  # 17
        [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
        [[-1, 4], 1, "Concat", [1]],
        [-1, 3, "C2", [256, False]],  # 20 P3/8-small
        [-1, 1, "Conv", [256, 3, 2]],
        [[-1, 17], 1, "Concat", [1]],
        [-1, 3, "C2", [512, False]],  # 23 P4/16-medium
        [-1, 1, "Conv", [512, 3, 2]],
        [[-1, 14], 1, "Concat", [1]],
        [-1, 3, "C2", [768, False]],  # 26 P5/32-large
        [-1, 1, "Conv", [768, 3, 2]],
        [[-1, 11], 1, "Concat", [1]],
        [-1, 3, "C2", [1024, False]],  # 29 P6/64-xlarge
        [[20, 23, 26, 29], 1, "Detect", ["nc"]],  # 30
    ],
}

# cfg/models/yolov8-pose-p6.yaml of the JAX package as a dict: the p6 graph
# on the Pose head, nc 1 and 17 keypoints
YOLOV8_POSE_P6: Dict[str, Any] = {
    "nc": 1,
    "kpt_shape": [17, 3],
    "scales": copy.deepcopy(YOLOV8_SEG["scales"]),
    "backbone": copy.deepcopy(YOLOV8_P6["backbone"]),
    "head": copy.deepcopy(YOLOV8_P6["head"][:-1]) + [
        [[20, 23, 26, 29], 1, "Pose", ["nc", "kpt_shape"]],  # 30
    ],
}

# config name -> (module class, positional field names after c1, kind):
# "conv" width-scaled c2, repeated n times; "csp" width-scaled c2 taking n;
# "hg" the PPHGNetV2 blocks, c2 unscaled, HGBlock taking n; "aifi" the
# encoder layer at its input's width; "same_ch" a module keeping its
# input's width; "transformer_block" width-scaled c2 taking n as its layers
_CSP_FIELDS = ("c2", "n", "shortcut", "g", "e")
REGISTRY = {
    "Conv": (conv_mod.Conv, ("c2", "k", "s", "p", "g", "d", "act"), "conv"),
    "Conv2": (conv_mod.Conv2, ("c2", "k", "s", "p", "g", "d", "act"), "conv"),
    "RepConv": (conv_mod.RepConv, ("c2", "k", "s", "g", "d", "act"), "conv"),
    "DWConv": (conv_mod.DWConv, ("c2", "k", "s", "d", "act"), "conv"),
    "LightConv": (conv_mod.LightConv, ("c2", "k", "act"), "conv"),
    "ConvTranspose": (conv_mod.ConvTranspose, ("c2", "k", "s", "p", "bn", "act"), "conv"),
    "nn.ConvTranspose2d": (conv_mod.conv_transpose_raw, ("c2", "k", "s", "p"), "conv"),
    "Focus": (conv_mod.Focus, ("c2", "k", "s", "p", "act"), "conv"),
    "GhostConv": (conv_mod.GhostConv, ("c2", "k", "s", "g", "act"), "conv"),
    "CBAM": (conv_mod.CBAM, ("k",), "same_ch"),
    "Bottleneck": (block_mod.Bottleneck, ("c2", "shortcut", "g", "k", "e"), "conv"),
    "GhostBottleneck": (block_mod.GhostBottleneck, ("c2", "k", "s"), "conv"),
    "SPP": (block_mod.SPP, ("c2", "k"), "conv"),
    "SPPF": (block_mod.SPPF, ("c2", "k"), "conv"),
    "RepBlock": (block_mod.RepBlock, ("c2", "n", "shortcut"), "csp"),
    "C1": (block_mod.C1, ("c2", "n"), "csp"),
    "C2": (block_mod.C2, _CSP_FIELDS, "csp"),
    "C2f": (block_mod.C2f, _CSP_FIELDS, "csp"),
    "C3": (block_mod.C3, _CSP_FIELDS, "csp"),
    "C3x": (block_mod.C3x, _CSP_FIELDS, "csp"),
    "C3Ghost": (block_mod.C3Ghost, _CSP_FIELDS, "csp"),
    "RepC3": (block_mod.RepC3, ("c2", "n", "e"), "csp"),
    "NASCSP": (block_mod.NASCSP, ("c2", "n", "shortcut", "e"), "csp"),
    "HGStem": (block_mod.HGStem, ("cm", "c2"), "hg"),
    "HGBlock": (block_mod.HGBlock, ("cm", "c2", "k", "n", "lightconv", "shortcut", "act"), "hg"),
    "AIFI": (tr_mod.AIFI, ("cm", "num_heads"), "aifi"),
    "TransformerBlock": (tr_mod.TransformerBlock, ("c2", "num_heads", "num_layers"),
                         "transformer_block"),
    "Concat": (conv_mod.Concat, ("dim",), "concat"),
    "nn.Upsample": (nn.Upsample, (), "upsample"),
    "Segment": (head_mod.PolarSegment, ("nc", "nm", "npr"), "head"),
    "Detect": (head_mod.Detect, ("nc",), "head"),
    "Pose": (head_mod.Pose, ("nc", "kpt_shape"), "head"),
    "Segmentori": (head_mod.SegmentProto, ("nc", "nm", "npr"), "head"),
    "Classify": (head_mod.Classify, ("nc",), "head"),
    "RTDETRDecoder": (head_mod.RTDETRDecoder, ("nc",), "head"),
}
# a head's config name -> its task (the JAX ``HEAD_TASKS``)
HEAD_TASKS = {"Segment": "segment", "Segmentori": "segment_ori", "Detect": "detect",
              "Pose": "pose", "Classify": "classify", "RTDETRDecoder": "rtdetr"}


def make_divisible(x: float, divisor: int = 8) -> int:
    return int(math.ceil(x / divisor) * divisor)


def _scale_factor(name: str, kwargs: Dict[str, Any]) -> float:
    """How a "conv" kind layer scales the stride, per repeat: its ``s``
    (the class's default where the config gives none), divided by for a
    transposed conv, and doubled by Focus's space-to-depth."""
    cls = REGISTRY[name][0]
    default = inspect.signature(cls).parameters.get("s")
    s = kwargs.get("s", default.default if default is not None else 1)
    if name in ("ConvTranspose", "nn.ConvTranspose2d"):
        return 1.0 / s
    return s * 2 if name == "Focus" else s


class LayerSpec:
    """One graph layer: from-index ``f``, module name and kwargs, input
    channels ``c1`` (a list for multi-input layers), output channels ``c2``,
    repeats and output stride (a list per level for the head)."""

    __slots__ = ("i", "f", "name", "kwargs", "kind", "c1", "c2", "repeats", "stride")

    def __init__(self, i, f, name, kwargs, kind, c1, c2, repeats, stride):
        self.i, self.f, self.name, self.kwargs, self.kind = i, f, name, kwargs, kind
        self.c1, self.c2, self.repeats, self.stride = c1, c2, repeats, stride


def parse_model(cfg: dict, ch: int = 3):
    """Config dict -> (specs, save, head_spec), with the JAX version's
    scaling rules and from-index normalization; the argument ``kpt_shape``
    takes the config's (default (17, 3))."""
    nc = cfg.get("nc", 80)
    kpt_shape = tuple(cfg.get("kpt_shape", (17, 3)))
    scales = cfg.get("scales")
    depth = cfg.get("depth_multiple", 1.0)
    width = cfg.get("width_multiple", 1.0)
    max_channels = float("inf")
    if scales:
        scale = cfg.get("scale") or tuple(scales.keys())[0]
        depth, width, max_channels = scales[scale]

    chs: List[int] = [ch]
    strides: List[float] = [1]
    specs: List[LayerSpec] = []
    save: List[int] = []
    head_spec: Optional[LayerSpec] = None

    for i, (f, n, name, args) in enumerate(list(cfg["backbone"]) + list(cfg["head"])):
        args = list(args)
        if isinstance(f, int):
            f = f if f == -1 else f % i
        else:
            f = [x if x == -1 else x % i for x in f]
        for j, a in enumerate(args):
            if a == "nc":
                args[j] = nc
            elif a == "kpt_shape":
                args[j] = kpt_shape
            elif a in ("True", "False", "None"):
                args[j] = {"True": True, "False": False, "None": None}[a]
        if name not in REGISTRY:
            raise KeyError(f"module '{name}' is not ported (ported: {sorted(REGISTRY)})")
        _, fields, kind = REGISTRY[name]
        n = max(round(n * depth), 1) if n > 1 else n
        c1 = chs[f] if isinstance(f, int) else [chs[x] for x in f]
        s_in = strides[f] if isinstance(f, int) else [strides[x] for x in f]

        kwargs: Dict[str, Any] = {}
        repeats = 1
        stride = s_in
        if kind in ("conv", "csp"):
            c2 = args[0]
            if c2 != nc:
                c2 = make_divisible(min(c2, max_channels) * width, 8)
            vals = [c2] + args[1:]
            if kind == "csp":
                vals = [c2, n] + args[1:]
            else:
                repeats = n
            kwargs = dict(zip(fields, vals))
            stride = s_in * _scale_factor(name, kwargs) ** repeats
        elif kind == "hg":
            c2 = args[1]
            vals = args[:3] + [n] + args[3:] if name == "HGBlock" else args
            kwargs = dict(zip(fields, vals))
            stride = s_in * (4 if name == "HGStem" else 1)
        elif kind in ("aifi", "same_ch"):
            c2 = c1
            kwargs = dict(zip(fields, args))
        elif kind == "transformer_block":  # JAX's zip: no num_heads given, n takes its place
            c2 = make_divisible(min(args[0], max_channels) * width, 8)
            kwargs = dict(zip(fields, [c2] + args[1:2] + [n]))
        elif kind == "concat":
            c2 = sum(c1)
            kwargs["dim"] = 1
            stride = s_in[0]
        elif kind == "upsample":
            c2 = c1
            kwargs["scale_factor"] = args[1] if len(args) > 1 else 2
            kwargs["mode"] = args[2] if len(args) > 2 else "nearest"
            stride = s_in / kwargs["scale_factor"]
        else:  # head
            kwargs = dict(zip(fields, args))
            if name == "Segment" and len(args) > 2:
                kwargs["npr"] = make_divisible(min(args[2], max_channels) * width, 8)
            c2 = nc

        spec = LayerSpec(i, f, name, kwargs, kind, c1, c2, repeats, stride)
        specs.append(spec)
        if kind == "head":
            head_spec = spec
        save.extend(x % i for x in ([f] if isinstance(f, int) else f) if x != -1)
        if i == 0:
            chs, strides = [], []
        chs.append(c2)
        strides.append(stride)
    return specs, sorted(set(save)), head_spec


def build_layer(spec: LayerSpec) -> nn.Module:
    cls, _, kind = REGISTRY[spec.name]
    if kind in ("concat", "upsample"):
        return cls(**spec.kwargs)
    if kind == "head":
        return cls(ch=spec.c1, **spec.kwargs)
    mods = [cls(spec.c1 if r == 0 else spec.c2, **spec.kwargs) for r in range(spec.repeats)]
    return mods[0] if spec.repeats == 1 else nn.Sequential(*mods)


class GraphModel(nn.Module):
    """The wired network: ``model.{i}`` layers, routed by their from-index."""

    def __init__(self, cfg: dict, ch: int = 3):
        super().__init__()
        self.specs, self.save, self.head_spec = parse_model(cfg, ch=ch)
        self.model = nn.ModuleList(build_layer(s) for s in self.specs)

    def forward(self, x, **head_kw):
        """x (B, 3, H, W) -> the head's output; ``head_kw`` goes to the head
        alone (RT-DETR's ``dn``)."""
        y: Dict[int, Any] = {}
        out = x
        for spec, m in zip(self.specs, self.model):
            if isinstance(spec.f, int):
                inp = out if spec.f == -1 else y[spec.f]
            else:
                inp = [out if j == -1 else y[j] for j in spec.f]
            out = m(inp, **head_kw) if head_kw and spec is self.head_spec else m(inp)
            if spec.i in self.save:
                y[spec.i] = out
        return out  # head output


class TaskModel(GraphModel):
    """A graph whose last layer is the head ``head_name``: its config, class
    count, names and output strides. ``forward`` gives the head's raw
    per-level maps. ``fused`` is set by ``nn/fuse.py`` (the deploy form)."""

    task = ""
    head_name = ""

    def __init__(self, cfg: dict, nc: Optional[int] = None, ch: int = 3):
        cfg = copy.deepcopy(dict(cfg))
        if nc and nc != cfg.get("nc"):
            cfg["nc"] = nc
        super().__init__(cfg, ch=ch)
        if self.head_spec is None or self.head_spec.name != self.head_name:
            raise ValueError(f"{type(self).__name__} needs a '{self.head_name}' head")
        self.yaml = cfg
        self.nc = cfg["nc"]
        stride = self.head_spec.stride  # a list per level; one number for Classify
        self.strides = tuple(int(s) for s in stride) if isinstance(stride, list) else ()
        self.names = {i: f"class{i}" for i in range(self.nc)}
        self.fused = False

    @property
    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


class SegmentationModel(TaskModel):
    """Polar-contour segmentation model: ``predict_parts`` gives the head's
    predict-path decode."""

    task = "segment"
    head_name = "Segment"

    def __init__(self, cfg: Optional[dict] = None, nc: Optional[int] = None, ch: int = 3):
        super().__init__(cfg if cfg is not None else YOLOV8_SEG, nc=nc, ch=ch)
        self.nm = self.head_spec.kwargs.get("nm", 36)

    def predict(self, x):
        """x (B, 3, H, W) float -> (B, 4 + nc + 3 * nm, A): xyxy boxes,
        sigmoid scores, the contours' x, y and valid flags
        (``decode_polar``; the exported predict)."""
        return head_mod.decode_polar(self(x), self.strides, self.nc, self.nm)

    def predict_parts(self, x, sigmoid: bool = True):
        """x (B, 3, H, W) float -> (boxes (B, A, 4), scores (B, A, nc),
        extras (B, A, 38)); ``sigmoid=False`` returns raw class logits."""
        return head_mod.decode_polar_parts(self(x), self.strides, self.nc, self.nm, sigmoid=sigmoid)


class DetectionModel(TaskModel):
    """The stock YOLOv8 detect model: ``predict`` gives (B, 4 + nc, A), xywh
    boxes in pixels and sigmoid scores (``decode_detect``)."""

    task = "detect"
    head_name = "Detect"
    reg_max = 16

    def __init__(self, cfg: Optional[dict] = None, nc: Optional[int] = None, ch: int = 3):
        super().__init__(cfg if cfg is not None else YOLOV8, nc=nc, ch=ch)

    def predict(self, x):
        """x (B, 3, H, W) float -> (B, 4 + nc, A)."""
        return head_mod.decode_detect(self(x), self.strides, self.nc, self.reg_max)

    def predict_augmented(self, x):
        raise NotImplementedError("test-time augmentation (predict_augmented) is not ported")


class PoseModel(TaskModel):
    """The keypoint model: ``predict`` gives (B, 4 + nc + nk, A), the detect
    decode (xywh boxes in pixels, sigmoid scores) and then the keypoints
    decoded in pixels (``decode_pose``), ``nk = K * D`` rows ordered
    keypoint by keypoint."""

    task = "pose"
    head_name = "Pose"
    reg_max = 16

    def __init__(self, cfg: Optional[dict] = None, nc: Optional[int] = None, ch: int = 3):
        super().__init__(cfg if cfg is not None else YOLOV8_POSE, nc=nc, ch=ch)
        self.kpt_shape = tuple(int(v) for v in self.head_spec.kwargs["kpt_shape"])

    def predict(self, x):
        """x (B, 3, H, W) float -> (B, 4 + nc + nk, A)."""
        outs = self(x)
        nk = self.kpt_shape[0] * self.kpt_shape[1]
        feat_hw = [(o.shape[2], o.shape[3]) for o in outs]
        y = head_mod.decode_detect([o[:, :-nk] for o in outs], self.strides, self.nc,
                                   self.reg_max)
        kpt = head_mod.flatten_levels([o[:, -nk:] for o in outs])
        k = head_mod.decode_pose(kpt, self.strides, feat_hw, self.kpt_shape)
        return torch.cat([y, k.reshape(k.shape[0], k.shape[1], nk).transpose(1, 2)], dim=1)


class SegmentationOriModel(TaskModel):
    """The stock proto-mask segmentation model: ``predict`` gives ((B, 4 +
    nc + nm, A), proto): the detect decode (xywh boxes in pixels, sigmoid
    scores), then the nm mask coefficients of each anchor, and the
    prototypes (B, nm, hp, wp), NCHW where JAX keeps (B, hp, wp, nm)."""

    task = "segment_ori"
    head_name = "Segmentori"
    reg_max = 16

    def __init__(self, cfg: Optional[dict] = None, nc: Optional[int] = None, ch: int = 3):
        super().__init__(cfg if cfg is not None else YOLOV8_SEGORI, nc=nc, ch=ch)
        self.nm = int(self.head_spec.kwargs.get("nm", 32))

    def predict(self, x):
        """x (B, 3, H, W) float -> ((B, 4 + nc + nm, A), proto)."""
        levels, proto = self(x)
        nm = self.nm
        y = head_mod.decode_detect([o[:, :o.shape[1] - nm] for o in levels], self.strides,
                                   self.nc, self.reg_max)
        mc = head_mod.flatten_levels([o[:, -nm:] for o in levels])
        return torch.cat([y, mc.transpose(1, 2)], dim=1), proto


class ClassificationModel(TaskModel):
    """The classify model: ``predict`` (its decode is the identity) gives
    (B, nc) sigmoid probabilities. It has no strides."""

    task = "classify"
    head_name = "Classify"

    def __init__(self, cfg: Optional[dict] = None, nc: Optional[int] = None, ch: int = 3):
        super().__init__(cfg if cfg is not None else YOLOV8_CLS, nc=nc, ch=ch)

    def predict(self, x):
        """x (B, 3, H, W) float -> (B, nc)."""
        return self(x)


class RTDETRDetectionModel(TaskModel):
    """The RT-DETR model: ``forward(x, dn=None)`` gives the decoder's train
    or eval output (``RTDETRDecoder``), ``predict`` (its decode is the
    identity) (B, nq, 4 + nc), normalized cxcywh boxes and sigmoid scores;
    no anchors, no NMS. Strides (8, 16, 32), as JAX's."""

    task = "rtdetr"
    head_name = "RTDETRDecoder"

    def __init__(self, cfg: Optional[dict] = None, nc: Optional[int] = None, ch: int = 3):
        super().__init__(cfg if cfg is not None else YOLOV8_RTDETR, nc=nc, ch=ch)
        self.strides = (8, 16, 32)

    def predict(self, x):
        """x (B, 3, H, W) float -> (B, nq, 4 + nc)."""
        return self(x)


TASK_MODELS = {"segment": SegmentationModel, "detect": DetectionModel, "pose": PoseModel,
               "segment_ori": SegmentationOriModel, "classify": ClassificationModel,
               "rtdetr": RTDETRDetectionModel}


def guess_model_task(cfg: dict) -> str:
    """A config's task, by its last layer's head (``detect`` for a head the
    table does not know, as in the JAX version)."""
    return HEAD_TASKS.get(cfg["head"][-1][2], "detect")


def build_model(cfg: dict, nc: Optional[int] = None) -> TaskModel:
    """The task model of a config dict; ``NotImplementedError`` for a task
    that is not ported."""
    task = guess_model_task(cfg)
    if task not in TASK_MODELS:
        raise NotImplementedError(f"task {task!r} is not ported (ported: {sorted(TASK_MODELS)})")
    return TASK_MODELS[task](cfg, nc=nc)


# the model configs, by the base name of their yaml in the JAX package: all
# of its 15
MODEL_CFGS: Dict[str, Dict[str, Any]] = {
    "yolov8-seg": YOLOV8_SEG, "yolov8": YOLOV8, "yolov8-pose": YOLOV8_POSE,
    "yolov8-segori": YOLOV8_SEGORI, "yolov8-cls": YOLOV8_CLS, "yolov8-rtdetr": YOLOV8_RTDETR,
    "rtdetr-l": RTDETR_L, "yolo_nas": YOLO_NAS, "yolov3": YOLOV3, "yolov5": YOLOV5,
    "yolov6": YOLOV6, "yolov8-det-rep": YOLOV8_DET_REP, "yolov8-p2": YOLOV8_P2,
    "yolov8-p6": YOLOV8_P6, "yolov8-pose-p6": YOLOV8_POSE_P6,
}


def yaml_model_load(name) -> Dict[str, Any]:
    """A model name such as ``"yolov8n-seg.yaml"`` or ``"yolov8n.yaml"`` ->
    its config dict, the scale letter taken from the name as the JAX
    ``yaml_model_load`` takes it (``yolov8n-seg`` -> ``yolov8-seg`` at
    scale ``n``; ``yolo_nas_s`` -> ``yolo_nas`` at scale ``s``; ``yolov3``, which
    has no scales, as it is). A name that is not in ``MODEL_CFGS`` raises
    ``NotImplementedError``."""
    stem = Path(str(name)).stem
    m = (re.match(r"(.*yolov\d+)([nslmx])([-_].+)?$", stem)
         or re.match(r"(.*yolov\d+)([nslmx])$", stem))
    base, scale = (m.group(1) + (m.group(3) or ""), m.group(2)) if m else (stem, "")
    nas = re.match(r"(yolo_nas)_([sml])$", stem)
    if not m and nas:
        base, scale = nas.groups()
    if base not in MODEL_CFGS:
        raise NotImplementedError(f"model {name!r} is not a config of the JAX package "
                                  f"({sorted(k + '.yaml' for k in MODEL_CFGS)}, any scale letter)")
    cfg = copy.deepcopy(MODEL_CFGS[base])
    cfg["scale"] = scale  # none: the first of ``scales``, as parse_model takes it
    return cfg


# flax's lecun_normal: a unit normal truncated at +-2, whose std is this, is
# scaled by sqrt(1 / fan_in) / this, so that the draws' std is sqrt(1 / fan_in)
TRUNC_NORMAL_STD = 0.87962566103423978


def _trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator):
    """``t`` <- normal(0, std) truncated at +-2 std, by the inverse CDF."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand(t.shape, generator=generator, dtype=torch.float64) * (hi - lo) + lo
    z = (torch.erfinv(u) * math.sqrt(2.0)).clamp_(-2.0, 2.0)
    t.copy_(z * std)


@torch.no_grad()
def init_weights(model: TaskModel, generator: torch.Generator):
    """The JAX package's initialization of a fresh model, in place: conv
    kernels flax's ``lecun_normal`` (std ``sqrt(1 / fan_in) / 0.8796...``,
    truncated at 2 std, ``fan_in = k * k * c_in / groups``; a transposed
    conv's ``k * k * c_in``, its kernel drawn in flax's layout), conv biases 0,
    BatchNorm scale 1, bias 0, running mean 0 and variance 1; then the head
    priors of JAX ``BaseModel.init``: each class bias ``log(5 / nc / (640 /
    stride)^2)``, and on the polar head each ray bias 1 (the detect head's
    box bias keeps its 0; the pose and proto-mask heads' priors go to their
    ``detect`` child, their keypoint and coefficient biases keep their 0;
    the classify head has no priors, its ``linear`` drawn as a conv with
    ``fan_in`` its input width and its bias 0, as flax's ``Dense``). The
    draws come from ``generator`` (a CPU ``torch.Generator``), not JAX's.

    RT-DETR (``_init_rtdetr``): every Dense and attention kernel is drawn
    as a conv's (the attention's DenseGeneral with ``fan_in`` its input
    width), LayerNorm scale 1 and bias 0, the ``nn.Embed`` table flax's
    untruncated normal of std ``sqrt(1 / hd)``; then the head's own priors
    in place of the anchor heads'."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            w = torch.empty(m.weight.shape)
            _trunc_normal_(w, math.sqrt(1.0 / m.weight[0].numel()) / TRUNC_NORMAL_STD, generator)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.ConvTranspose2d):  # (in, out, kh, kw), flax's (kh, kw, in, out)
            ci, co, kh, kw = m.weight.shape
            w = torch.empty(kh, kw, ci, co)
            _trunc_normal_(w, math.sqrt(1.0 / (kh * kw * ci)) / TRUNC_NORMAL_STD, generator)
            m.weight.copy_(w.permute(2, 3, 0, 1).flip(2, 3))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            m.reset_parameters()
        elif isinstance(m, tr_mod.DenseGeneral):
            fan_in = math.prod(m.in_shape)
            w = torch.empty(fan_in, math.prod(m.out_shape))
            _trunc_normal_(w, math.sqrt(1.0 / fan_in) / TRUNC_NORMAL_STD, generator)
            m.kernel.copy_(w.reshape(m.kernel.shape))
            m.bias.zero_()
        elif isinstance(m, tr_mod.Embed):
            m.embedding.copy_(torch.randn(m.embedding.shape, generator=generator)
                              * math.sqrt(1.0 / m.embedding.shape[1]))
    if model.task == "rtdetr":
        _init_rtdetr(model.model[-1])
        return model
    if model.task == "classify":
        return model
    head = model.model[-1]
    head = getattr(head, "detect", head)
    for i, s in enumerate(model.strides):
        head.cv3[i][2].bias.fill_(math.log(5 / model.nc / (640 / s) ** 2))
        if model.task == "segment":
            head.cv2[i][2].bias.fill_(1.0)
    return model


def _init_rtdetr(head: head_mod.RTDETRDecoder):
    """The RT-DETR head's priors (JAX ``RTDETRDecoder`` and its modules'
    initializers): each score head's bias ``-log((1 - 0.01) / 0.01)``, the
    last layer of every bbox MLP zeroed, and in each ``MSDeformAttn`` the
    ``sampling_offsets`` kernel zeroed with its bias the directional grid
    and ``attention_weights`` zeroed. (JAX's anchor-head bias pass leaves an
    empty ``detect`` subtree here; ``utils/checkpoint.py`` restores it.)"""
    prior = -math.log((1 - 0.01) / 0.01)
    for i in range(head.ndl):
        getattr(head, f"dec_score_head{i}").bias.fill_(prior)
        getattr(head, f"dec_bbox_head{i}").layers2.weight.zero_()
        attn = getattr(head, f"dec_layer{i}").cross_attn
        attn.sampling_offsets.weight.zero_()
        attn.sampling_offsets.bias.copy_(
            tr_mod.offset_bias(attn.n_heads, attn.n_levels, attn.n_points))
        attn.attention_weights.weight.zero_()
        attn.attention_weights.bias.zero_()
    head.enc_score_head.bias.fill_(prior)
    head.enc_bbox_head.layers2.weight.zero_()
