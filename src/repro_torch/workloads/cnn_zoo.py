"""The paper's benchmark DNNs (Table 2) as layer graphs.

Light:  SqueezeNet, YOLO-Lite, Keyword Spotting (DS-CNN)
Heavy:  AlexNet, InceptionV3, ResNet50, YOLO-v2
Mixed:  Light + Heavy

Branchy graphs (Inception, fire modules, residual blocks) are
topologically linearized into single-predecessor chains — the paper
schedules at layer granularity with chain dependencies (see DESIGN.md
"Assumptions changed").  Channel/shape configurations follow the
original publications.
"""
from __future__ import annotations

from repro_torch.costmodel.accelerators import MASConfig, DEFAULT_MAS
from repro_torch.costmodel.fleets import get_fleet
from repro_torch.costmodel.layers import LayerSpec, conv2d, dwconv2d, fc, pool
from repro_torch.costmodel.registry import Registry


def squeezenet() -> list[LayerSpec]:
    """SqueezeNet v1.0, 224x224x3 (Iandola et al. 2016)."""
    ls: list[LayerSpec] = [conv2d("conv1", 224, 224, 3, 96, 7, 2)]
    ls.append(pool("pool1", 111, 111, 96, 3, 2))
    h = 55
    fires = [  # (squeeze, expand1x1, expand3x3)
        (16, 64, 64), (16, 64, 64), (32, 128, 128),       # fire2-4
        (32, 128, 128), (48, 192, 192), (48, 192, 192),   # fire5-7
        (64, 256, 256), (64, 256, 256),                   # fire8-9
    ]
    cin = 96
    for i, (s, e1, e3) in enumerate(fires, start=2):
        ls.append(conv2d(f"fire{i}_squeeze", h, h, cin, s, 1))
        ls.append(conv2d(f"fire{i}_exp1", h, h, s, e1, 1))
        ls.append(conv2d(f"fire{i}_exp3", h, h, s, e3, 3))
        cin = e1 + e3
        if i in (4, 8):  # maxpools after fire4 and fire8
            ls.append(pool(f"pool{i}", h, h, cin, 3, 2))
            h = h // 2
    ls.append(conv2d("conv10", h, h, cin, 1000, 1))
    ls.append(pool("avgpool", h, h, 1000, h, h))
    return ls


def yolo_lite() -> list[LayerSpec]:
    """YOLO-Lite (Huang et al. 2018): 7 convs, 224x224, no BN trickery."""
    ls = []
    h, cin = 224, 3
    for i, cout in enumerate([16, 32, 64, 128, 128, 256], start=1):
        ls.append(conv2d(f"conv{i}", h, h, cin, cout, 3))
        ls.append(pool(f"pool{i}", h, h, cout, 2, 2))
        h, cin = h // 2, cout
    ls.append(conv2d("conv7", h, h, cin, 125, 1))
    return ls


def keyword_spotting() -> list[LayerSpec]:
    """DS-CNN keyword spotting (Zhang et al. 2017) on 49x10 MFCC."""
    ls = [conv2d("conv1", 49, 10, 1, 64, 10, 2)]
    h, w = 25, 5
    for i in range(4):
        ls.append(dwconv2d(f"dw{i+1}", h, w, 64, 3))
        ls.append(conv2d(f"pw{i+1}", h, w, 64, 64, 1))
    ls.append(pool("avgpool", h, w, 64, h, h))
    ls.append(fc("fc", 64, 12))
    return ls


def alexnet() -> list[LayerSpec]:
    """AlexNet (Krizhevsky 2012), 227x227x3."""
    return [
        conv2d("conv1", 227, 227, 3, 96, 11, 4),
        pool("pool1", 55, 55, 96, 3, 2),
        conv2d("conv2", 27, 27, 96, 256, 5),
        pool("pool2", 27, 27, 256, 3, 2),
        conv2d("conv3", 13, 13, 256, 384, 3),
        conv2d("conv4", 13, 13, 384, 384, 3),
        conv2d("conv5", 13, 13, 384, 256, 3),
        pool("pool5", 13, 13, 256, 3, 2),
        fc("fc6", 256 * 6 * 6, 4096),
        fc("fc7", 4096, 4096),
        fc("fc8", 4096, 1000),
    ]


def _inception_block(ls, name, h, cin, b1, b3r, b3, b5r, b5, bp):
    """InceptionV3-style block linearized: 1x1 | 1x1-3x3 | 1x1-3x3-3x3 | pool-1x1."""
    ls.append(conv2d(f"{name}_1x1", h, h, cin, b1, 1))
    ls.append(conv2d(f"{name}_3x3r", h, h, cin, b3r, 1))
    ls.append(conv2d(f"{name}_3x3", h, h, b3r, b3, 3))
    ls.append(conv2d(f"{name}_d3x3r", h, h, cin, b5r, 1))
    ls.append(conv2d(f"{name}_d3x3a", h, h, b5r, b5, 3))
    ls.append(conv2d(f"{name}_d3x3b", h, h, b5, b5, 3))
    ls.append(pool(f"{name}_pool", h, h, cin, 3, 1))
    ls.append(conv2d(f"{name}_poolproj", h, h, cin, bp, 1))
    return b1 + b3 + b5 + bp


def inception_v3() -> list[LayerSpec]:
    """InceptionV3 (Szegedy 2016), 299x299x3; linearized mixed blocks."""
    ls = [
        conv2d("stem1", 299, 299, 3, 32, 3, 2),
        conv2d("stem2", 149, 149, 32, 32, 3),
        conv2d("stem3", 147, 147, 32, 64, 3),
        pool("stem_pool1", 147, 147, 64, 3, 2),
        conv2d("stem4", 73, 73, 64, 80, 1),
        conv2d("stem5", 73, 73, 80, 192, 3),
        pool("stem_pool2", 71, 71, 192, 3, 2),
    ]
    cin = 192
    for i, bp in enumerate([32, 64, 64]):  # mixed 5b-5d @35x35
        cin = _inception_block(ls, f"mx5{chr(98 + i)}", 35, cin, 64, 48, 64, 64, 96, bp)
    ls.append(conv2d("red6a_3x3", 35, 35, cin, 384, 3, 2))  # grid reduction
    cin = 384 + cin
    for i, c7 in enumerate([128, 160, 160, 192]):  # mixed 6b-6e @17x17 (7x7 fact.)
        name = f"mx6{chr(98 + i)}"
        ls.append(conv2d(f"{name}_1x1", 17, 17, cin, 192, 1))
        ls.append(conv2d(f"{name}_7r", 17, 17, cin, c7, 1))
        ls.append(conv2d(f"{name}_1x7", 17, 17, c7, c7, 7))  # factorized approx
        ls.append(conv2d(f"{name}_7x1", 17, 17, c7, 192, 7))
        ls.append(pool(f"{name}_pool", 17, 17, cin, 3, 1))
        ls.append(conv2d(f"{name}_poolproj", 17, 17, cin, 192, 1))
        cin = 192 * 4
    ls.append(conv2d("red7a_3x3", 17, 17, cin, 320, 3, 2))
    cin = 320 + cin
    for i in range(2):  # mixed 7b-7c @8x8
        name = f"mx7{chr(98 + i)}"
        ls.append(conv2d(f"{name}_1x1", 8, 8, cin, 320, 1))
        ls.append(conv2d(f"{name}_3r", 8, 8, cin, 384, 1))
        ls.append(conv2d(f"{name}_3a", 8, 8, 384, 384, 3))
        ls.append(conv2d(f"{name}_3b", 8, 8, 384, 448, 3))
        ls.append(pool(f"{name}_pool", 8, 8, cin, 3, 1))
        ls.append(conv2d(f"{name}_poolproj", 8, 8, cin, 192, 1))
        cin = 320 + 384 + 448 + 192
    ls.append(pool("avgpool", 8, 8, cin, 8, 8))
    ls.append(fc("fc", cin, 1000))
    return ls


def resnet50() -> list[LayerSpec]:
    """ResNet-50 (He 2015), 224x224x3; bottlenecks linearized."""
    ls = [conv2d("conv1", 224, 224, 3, 64, 7, 2),
          pool("pool1", 112, 112, 64, 3, 2)]
    h, cin = 56, 64
    stages = [(64, 256, 3), (128, 512, 4), (256, 1024, 6), (512, 2048, 3)]
    for si, (mid, cout, blocks) in enumerate(stages, start=2):
        for b in range(blocks):
            stride = 2 if (b == 0 and si > 2) else 1
            ls.append(conv2d(f"s{si}b{b}_1x1a", h, h, cin, mid, 1, stride))
            hh = h // stride if stride == 2 else h
            ls.append(conv2d(f"s{si}b{b}_3x3", hh, hh, mid, mid, 3))
            ls.append(conv2d(f"s{si}b{b}_1x1b", hh, hh, mid, cout, 1))
            if b == 0:
                ls.append(conv2d(f"s{si}b{b}_proj", h, h, cin, cout, 1, stride))
            h, cin = hh, cout
    ls.append(pool("avgpool", 7, 7, 2048, 7, 7))
    ls.append(fc("fc", 2048, 1000))
    return ls


def yolo_v2() -> list[LayerSpec]:
    """YOLOv2 / Darknet-19 backbone + head (Redmon 2016), 416x416x3."""
    ls = []
    h, cin = 416, 3
    plan = [  # (cout, k, pool_after)
        (32, 3, True), (64, 3, True),
        (128, 3, False), (64, 1, False), (128, 3, True),
        (256, 3, False), (128, 1, False), (256, 3, True),
        (512, 3, False), (256, 1, False), (512, 3, False),
        (256, 1, False), (512, 3, True),
        (1024, 3, False), (512, 1, False), (1024, 3, False),
        (512, 1, False), (1024, 3, False),
    ]
    for i, (cout, k, p) in enumerate(plan, start=1):
        ls.append(conv2d(f"conv{i}", h, h, cin, cout, k))
        cin = cout
        if p:
            ls.append(pool(f"pool{i}", h, h, cout, 2, 2))
            h //= 2
    ls.append(conv2d("conv19", h, h, 1024, 1024, 3))
    ls.append(conv2d("conv20", h, h, 1024, 1024, 3))
    ls.append(conv2d("conv21", h, h, 1024, 1024, 3))
    ls.append(conv2d("head", h, h, 1024, 425, 1))
    return ls


LIGHT_MODELS = {"squeezenet": squeezenet, "yolo_lite": yolo_lite,
                "keyword_spotting": keyword_spotting}
HEAVY_MODELS = {"alexnet": alexnet, "inception_v3": inception_v3,
                "resnet50": resnet50, "yolo_v2": yolo_v2}
MIXED_MODELS = {**LIGHT_MODELS, **HEAVY_MODELS}
WORKLOADS = {"light": LIGHT_MODELS, "heavy": HEAVY_MODELS, "mixed": MIXED_MODELS}


def build_registry(workload: str = "mixed",
                   mas: MASConfig | str = DEFAULT_MAS) -> Registry:
    """Characterize a workload on a MAS (``mas`` may be a fleet preset
    name — see ``repro.costmodel.fleets``): the registration phase,
    re-run per fleet so the ``c[i,s,m]`` / ``b[i,s,m]`` tables match
    the platform the scheduler targets."""
    reg = Registry(get_fleet(mas))
    for name, fn in WORKLOADS[workload].items():
        reg.register(name, fn())
    return reg
