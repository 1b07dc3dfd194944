"""CNNs from the paper's evaluation (VGG16, ResNet18, SqueezeNet).

Counterpart of ``repro.models.cnn``: the full ImageNet-scale definitions
with the reference's ``scale``/``img_size`` knobs, as plain functions over
a param dict of dicts and lists, each taking the same ``wt=`` hook (QAT
fake-quant).

The params keep the reference's layouts: convs are HWIO and fc weights
(in, out). The protection code works on 8-byte blocks of each flattened
leaf and picks the same-shape or flat-padded layout from the last dim, so
another storage layout would put other weights in each block, and WOT, the
encoded bytes and every fault outcome would differ. A conv permutes its
weight to OIHW at use.

The model functions take NHWC images, as the reference's do, and run
NCHW inside (``conv``, ``maxpool``, ``batchnorm`` and ``avgpool_global``
take NCHW); VGG16 permutes back to NHWC before it flattens into ``fc1``.
``padding="SAME"`` is XLA's: the total ``max((ceil(n/s) - 1)*s + k - n,
0)`` with the smaller half before, so a stride-2 conv at an even size pads
one more after than before. ``batchnorm`` normalizes with the stored
``mean``/``var`` unless ``training=True`` and never updates them.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch import device as device_mod

Identity = lambda w: w  # noqa: E731


def _same_pad(n: int, k: int, s: int) -> tuple:
    """XLA's SAME padding of one spatial dim -> (before, after)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv(p, x, *, stride=1, padding="SAME", wt=Identity):
    """NCHW ``x`` through the HWIO conv ``p["w"]`` (+ ``p["b"]``);
    ``padding`` is "SAME" or "VALID"."""
    w = wt(p["w"]).to(x.dtype)
    kh, kw = w.shape[0], w.shape[1]
    if padding == "SAME":
        top, bottom = _same_pad(x.shape[2], kh, stride)
        left, right = _same_pad(x.shape[3], kw, stride)
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
    elif padding != "VALID":
        raise ValueError(f"padding {padding!r}; one of ('SAME', 'VALID')")
    y = F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)
    return y + p["b"].to(x.dtype)[:, None, None] if "b" in p else y


def maxpool(x, k=2, s=2):
    """VALID max pooling of NCHW ``x``."""
    return F.max_pool2d(x, k, s)


def avgpool_global(x):
    return x.mean(dim=(2, 3))


def _generator(seed, dev) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=dev).manual_seed(int(seed))


def _normal(gen, shape, std, dev):
    return torch.randn(shape, generator=gen, device=dev) * std


def _conv_init(gen, kh, kw, cin, cout, dev, bias=True):
    p = {"w": _normal(gen, (kh, kw, cin, cout),
                      (2.0 / (kh * kw * cin)) ** 0.5, dev)}
    if bias:
        p["b"] = torch.zeros((cout,), device=dev)
    return p


# ---------------------------------------------------------------- VGG16 ----

_VGG16_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
               512, 512, 512, "M", 512, 512, 512, "M"]


def init_vgg16(seed=0, *, n_classes=1000, scale=1.0, img_size=224,
               device=None):
    """VGG16 params drawn from ``seed`` (an int or a ``torch.Generator``)."""
    dev = device_mod.resolve(device)
    gen = _generator(seed, dev)
    params, cin = {"convs": []}, 3
    for item in _VGG16_PLAN:
        if item == "M":
            continue
        cout = max(8, int(item * scale))
        params["convs"].append(_conv_init(gen, 3, 3, cin, cout, dev))
        cin = cout
    spatial = img_size // 32
    fc1 = max(32, int(4096 * scale))
    zeros = lambda n: torch.zeros((n,), device=dev)  # noqa: E731
    params["fc1"] = {"w": _normal(gen, (cin * spatial * spatial, fc1), 0.01,
                                  dev), "b": zeros(fc1)}
    params["fc2"] = {"w": _normal(gen, (fc1, fc1), 0.01, dev), "b": zeros(fc1)}
    params["fc3"] = {"w": _normal(gen, (fc1, n_classes), 0.01, dev),
                     "b": zeros(n_classes)}
    return params


def _fc(p, x, wt):
    return x @ wt(p["w"]).to(x.dtype) + p["b"]


def vgg16(params, x, wt=Identity):
    x = x.permute(0, 3, 1, 2)
    ci = 0
    for item in _VGG16_PLAN:
        if item == "M":
            x = maxpool(x)
        else:
            x = F.relu(conv(params["convs"][ci], x, wt=wt))
            ci += 1
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # flatten NHWC
    x = F.relu(_fc(params["fc1"], x, wt))
    x = F.relu(_fc(params["fc2"], x, wt))
    return _fc(params["fc3"], x, wt)


# -------------------------------------------------------------- ResNet18 ---


def _bn_init(c, dev):
    return {"scale": torch.ones((c,), device=dev),
            "bias": torch.zeros((c,), device=dev),
            "mean": torch.zeros((c,), device=dev),
            "var": torch.ones((c,), device=dev)}


def batchnorm(p, x, training=False, eps=1e-5):
    """NCHW batch norm: batch statistics with ``training``, else the stored
    ``mean``/``var`` (never updated)."""
    if training:
        mu = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
    else:
        mu, var = p["mean"], p["var"]
    inv = torch.rsqrt(var + eps) * p["scale"]
    return (x - mu[:, None, None]) * inv[:, None, None] + \
        p["bias"][:, None, None]


def init_resnet18(seed=0, *, n_classes=1000, scale=1.0, img_size=224,
                  device=None):
    """ResNet18 params drawn from ``seed`` (an int or a
    ``torch.Generator``)."""
    dev = device_mod.resolve(device)
    gen = _generator(seed, dev)
    widths = [max(8, int(w * scale)) for w in (64, 128, 256, 512)]
    p = {"stem": _conv_init(gen, 7, 7, 3, widths[0], dev, bias=False),
         "stem_bn": _bn_init(widths[0], dev), "stages": []}
    cin = widths[0]
    for si, w in enumerate(widths):
        stage = []
        for bi in range(2):
            stride = 2 if (si > 0 and bi == 0) else 1
            blk = {"c1": _conv_init(gen, 3, 3, cin, w, dev, bias=False),
                   "bn1": _bn_init(w, dev),
                   "c2": _conv_init(gen, 3, 3, w, w, dev, bias=False),
                   "bn2": _bn_init(w, dev)}
            if stride != 1 or cin != w:
                blk["proj"] = _conv_init(gen, 1, 1, cin, w, dev, bias=False)
                blk["proj_bn"] = _bn_init(w, dev)
            stage.append(blk)
            cin = w
        p["stages"].append(stage)
    p["fc"] = {"w": _normal(gen, (cin, n_classes), 0.01, dev),
               "b": torch.zeros((n_classes,), device=dev)}
    return p


def resnet18(p, x, wt=Identity, training=False):
    x = x.permute(0, 3, 1, 2)
    x = F.relu(batchnorm(p["stem_bn"], conv(p["stem"], x, stride=2, wt=wt),
                         training))
    x = maxpool(x, 3, 2)
    for si, stage in enumerate(p["stages"]):
        for bi, blk in enumerate(stage):
            stride = 2 if (si > 0 and bi == 0) else 1
            idn = x
            y = F.relu(batchnorm(blk["bn1"],
                                 conv(blk["c1"], x, stride=stride, wt=wt),
                                 training))
            y = batchnorm(blk["bn2"], conv(blk["c2"], y, wt=wt), training)
            if "proj" in blk:
                idn = batchnorm(blk["proj_bn"],
                                conv(blk["proj"], x, stride=stride, wt=wt),
                                training)
            x = F.relu(y + idn)
    x = avgpool_global(x)
    return _fc(p["fc"], x, wt)


# ------------------------------------------------------------ SqueezeNet ---


def _fire_init(gen, cin, squeeze, expand, dev):
    return {"squeeze": _conv_init(gen, 1, 1, cin, squeeze, dev),
            "e1": _conv_init(gen, 1, 1, squeeze, expand, dev),
            "e3": _conv_init(gen, 3, 3, squeeze, expand, dev)}


def fire(p, x, wt=Identity):
    s = F.relu(conv(p["squeeze"], x, wt=wt))
    return torch.cat([F.relu(conv(p["e1"], s, wt=wt)),
                      F.relu(conv(p["e3"], s, wt=wt))], dim=1)


_FIRE_PLAN = [(16, 64), (16, 64), (32, 128), "M", (32, 128), (48, 192),
              (48, 192), (64, 256), "M", (64, 256)]


def init_squeezenet(seed=0, *, n_classes=1000, scale=1.0, img_size=224,
                    device=None):
    """SqueezeNet params drawn from ``seed`` (an int or a
    ``torch.Generator``)."""
    dev = device_mod.resolve(device)
    gen = _generator(seed, dev)
    sc = lambda c: max(4, int(c * scale))  # noqa: E731
    p = {"stem": _conv_init(gen, 3, 3, 3, sc(64), dev), "fires": []}
    cin = sc(64)
    for item in _FIRE_PLAN:
        if item == "M":
            continue
        sq, ex = item
        p["fires"].append(_fire_init(gen, cin, sc(sq), sc(ex), dev))
        cin = 2 * sc(ex)
    p["head"] = _conv_init(gen, 1, 1, cin, n_classes, dev)
    return p


def squeezenet(p, x, wt=Identity):
    x = x.permute(0, 3, 1, 2)
    x = F.relu(conv(p["stem"], x, stride=2, wt=wt))
    x = maxpool(x, 3, 2)
    fi = 0
    for item in _FIRE_PLAN:
        if item == "M":
            x = maxpool(x, 3, 2)
        else:
            x = fire(p["fires"][fi], x, wt=wt)
            fi += 1
    x = conv(p["head"], x, wt=wt)
    return avgpool_global(x)


CNNS: dict[str, tuple[Callable, Callable]] = {
    "vgg16": (init_vgg16, vgg16),
    "resnet18": (init_resnet18, resnet18),
    "squeezenet": (init_squeezenet, squeezenet),
}
