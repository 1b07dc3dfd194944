"""The paper's CNN experiment: pretraining, WOT fine-tuning and Table 2.

Counterpart of ``repro.training.cnn_experiments``. It mirrors the paper's
method: start from a *trained* f32 model (paper: ImageNet-pretrained;
here: Adam on the synthetic task of ``data.synthetic.image_batch``), then
fine-tune with WOT = QAT + throttling under SGD with momentum (paper
§5.2). On ``"cuda"`` the throttle is the ``quantize_throttle`` kernel with
its in-place write-back, and the campaigns decode through the codec
kernels.

The entry points take ``device=`` (default ``"cuda"``; without a GPU they
raise unless the caller asks for ``"cpu"``); the functions that take a
trained tree run on its device. The route (``backend``) defaults to the
kernels on the card and to the plain versions on the CPU. The two
packages cannot share random streams, so a model the port trains is its
own: the tests hold one step of each optimizer to the reference from
identical params.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import protection, tree
from repro_torch.core import quant, wot
from repro_torch.data import synthetic
from repro_torch.models import cnn
from repro_torch.protection import campaign

from . import optim, train

IMG_NORM = 3.0  # images have pixel std ~1.8; normalize into unit-ish range


def _norm(x):
    return x / IMG_NORM


def _device_of(params) -> torch.device:
    return next(iter(tree.leaves_with_path(params)))[1].device


def _batch(b: dict, dev) -> dict:
    return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}


def pretrain(name: str, *, steps=80, lr=1e-3, scale=0.25, img=32,
             n_classes=4, seed=0, device=None):
    """Phase 1: f32 Adam pretraining (stands in for ImageNet weights) ->
    ``(params, fwd, templates)``. The params are drawn from ``seed`` by
    the model's ``init_*`` on ``device``."""
    dev = device_mod.resolve(device)
    init, fwd = cnn.CNNS[name]
    params = init(seed, n_classes=n_classes, scale=scale, img_size=img,
                  device=dev)

    def loss_fn(p, batch):
        lg = fwd(p, _norm(batch["images"])).to(torch.float32)
        tgt = lg.gather(-1, batch["labels"].long()[:, None])[:, 0]
        return (torch.logsumexp(lg, dim=-1) - tgt).mean()

    st = optim.adam_init(params)
    tmpl = None
    for s in range(steps):
        b, tmpl = synthetic.image_batch(n_classes, 64, img, seed=seed, step=s,
                                        templates=tmpl)
        ws = [w.detach().requires_grad_()
              for _, w in tree.leaves_with_path(params)]
        loss = loss_fn(tree.unflatten_like(params, ws), _batch(b, dev))
        grads = torch.autograd.grad(loss, ws)
        with torch.no_grad():
            params, st = optim.adam_update(
                params, tree.unflatten_like(params, grads), st, lr=lr)
    return params, fwd, tmpl


def wot_finetune(params, fwd, tmpl, *, steps=40, lr=1e-3, n_classes=4,
                 img=32, seed=0, throttle=True, track=False, backend=None):
    """Phase 2: QATT (paper §4.1): QAT forward and backward, SGD with
    momentum, then the WOT throttle of every protected weight (on
    ``backend``, default the device's route). With ``track=True`` also
    returns the Fig 3/4 curve ``[(step, large values before the throttle,
    accuracy before, accuracy after), ...]`` (accuracies every 10 steps).
    -> ``(params, templates, curve)``."""
    dev = _device_of(params)
    be = device_mod.default_backend(dev) if backend is None else backend
    step, _ = train.make_cnn_train_step(
        lambda p, x, wt: fwd(p, _norm(x), wt=wt), qat=True,
        wot_throttle=False, lr=lr, backend=be)  # throttled here, for track
    opt = optim.sgd_init(params)
    curve = []
    for s in range(steps):
        b, tmpl = synthetic.image_batch(n_classes, 64, img, seed=seed,
                                        step=1000 + s, templates=tmpl)
        params, opt, _ = step(params, opt, _batch(b, dev))
        if track:
            pre = large_count(params)
            a_pre = accuracy(params, fwd, tmpl, quantized=True,
                             n_classes=n_classes, img=img) \
                if s % 10 == 0 else None
        if throttle:
            with torch.no_grad():
                params = wot.throttle_tree(params, backend=be)
        if track:
            a_post = accuracy(params, fwd, tmpl, quantized=True,
                              n_classes=n_classes, img=img) \
                if s % 10 == 0 else None
            curve.append((s, pre, a_pre, a_post))
    return params, tmpl, curve


def train_cnn_wot(name: str, *, pre_steps=80, wot_steps=40, scale=0.25,
                  img=32, n_classes=4, seed=0, device=None, backend=None):
    """The paper's whole pipeline -> ``(params, fwd, templates)``."""
    params, fwd, tmpl = pretrain(name, steps=pre_steps, scale=scale, img=img,
                                 n_classes=n_classes, seed=seed,
                                 device=device)
    params, tmpl, _ = wot_finetune(params, fwd, tmpl, steps=wot_steps,
                                   n_classes=n_classes, img=img, seed=seed,
                                   backend=backend)
    return params, fwd, tmpl


@torch.no_grad()
def accuracy(params, fwd, tmpl, *, quantized=False, n_classes=4, img=32,
             batch=256, seed=777):
    """Top-1 accuracy on the fixed eval batch (``quantized``: through the
    QAT fake-quant of every weight)."""
    b, _ = synthetic.image_batch(n_classes, batch, img, seed=seed, step=0,
                                 templates=tmpl)
    dev = _device_of(params)
    wt = train.qat_wt if quantized else (lambda w: w)
    lg = fwd(params, _norm(torch.as_tensor(b["images"], device=dev)), wt=wt)
    return float(np.mean(lg.argmax(-1).cpu().numpy() == b["labels"]))


@torch.no_grad()
def large_count(params) -> int:
    """Values outside [-64, 63] in positions 0..6 of the blocks of every
    quantized leaf of >= 2 dims (paper Fig. 3; 0 after WOT)."""
    total = 0
    for _, leaf in tree.leaves_with_path(params):
        if leaf.ndim >= 2:
            q, _ = quant.quantize(leaf)
            total += int(wot.count_large_in_protected(q.reshape(-1)))
    return total


def eval_policy(scheme_name, *, backend="torch") -> protection.ProtectionPolicy:
    """The paper's evaluation protects every >= 2-D tensor (conv + fc)."""
    return protection.ProtectionPolicy(
        default_scheme=scheme_name,
        predicate=lambda path, leaf: getattr(leaf, "ndim", 0) >= 2,
        backend=backend)


def run_scheme_campaign(params, fwd, tmpl, scheme_name, *, rates, trials,
                        key=None, batch="vmap", n_classes=4, img=32,
                        eval_batch=256, policy=None, backend=None,
                        device=None):
    """One Table-2 column: encode once under the scheme's eval policy (on
    ``backend``, default the device's route), then sweep the (trial x
    rate) grid (:func:`repro_torch.protection.run_campaign`). ``policy``
    overrides the scheme-derived policy."""
    dev = device_mod.resolve(device)
    if policy is None:
        policy = eval_policy(scheme_name, backend=backend or
                             device_mod.default_backend(dev))
    return campaign.run_campaign(
        params, lambda p, x: fwd(p, _norm(x)), tmpl, policy, rates=rates,
        trials=trials, key=key, batch=batch, n_classes=n_classes, img=img,
        eval_batch=eval_batch, device=dev)


@torch.no_grad()
def eval_with_scheme(params, fwd, tmpl, scheme_name, rate, seed, *,
                     n_classes=4, img=32):
    """Host-path oracle for one (scheme, rate, trial) cell: quantize and
    throttle, encode, NumPy injection, decode, accuracy (on the params'
    device, the plain route). -> ``(accuracy, space_overhead)``."""
    policy = eval_policy(scheme_name)
    enc = policy.encode_tree(params)
    if rate:
        enc = protection.inject_tree(enc, rate, seed)
    faulty = protection.decode_tree(enc, torch.float32)
    b, _ = synthetic.image_batch(n_classes, 256, img, seed=777, step=0,
                                 templates=tmpl)
    lg = cnn_forward_cached(faulty, fwd, b)
    acc = float(np.mean(lg.argmax(-1).cpu().numpy() == b["labels"]))
    return acc, protection.space_overhead(enc)


@torch.no_grad()
def cnn_forward_cached(params, fwd, batch):
    dev = _device_of(params)
    return fwd(params, _norm(torch.as_tensor(batch["images"], device=dev)))
