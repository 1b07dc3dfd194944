"""SGD with momentum, the paper's WOT optimizer (§5.2: lr 1e-4, momentum
0.9, weight decay 1e-4 through the Frobenius regularizer), and Adam for the
CNNs' pretraining.

Counterpart of ``SgdState``, ``sgd_init``, ``sgd_update``, ``AdamState``,
``adam_init`` and ``adam_update`` of ``repro.training.optim``, as plain
functions on nested dicts/lists of tensors, in the reference's op order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import tree


class SgdState(NamedTuple):
    momentum: dict


def sgd_init(params) -> SgdState:
    return SgdState(tree.map_with_path(lambda _, w: torch.zeros_like(w),
                                       params))


def sgd_update(params, grads, state: SgdState, *, lr, mu=0.9, wd=1e-4):
    """Paper-faithful: ``g += 2*wd*w``, ``m = mu*m + g``, ``w -= lr*m``.
    Returns new ``(params, SgdState)``."""
    def mom(path, w):
        g = tree.get_path(grads, path) + 2.0 * wd * w
        return mu * tree.get_path(state.momentum, path) + g

    new_m = tree.map_with_path(mom, params)
    new_p = tree.map_with_path(
        lambda path, w: w - lr * tree.get_path(new_m, path), params)
    return new_p, SgdState(new_m)


class AdamState(NamedTuple):
    mu: object
    nu: object
    count: torch.Tensor


def adam_init(params) -> AdamState:
    zeros = lambda: tree.map_with_path(  # noqa: E731
        lambda _, w: torch.zeros_like(w), params)
    dev = next(iter(tree.leaves_with_path(params)))[1].device
    return AdamState(zeros(), zeros(),
                     torch.zeros((), dtype=torch.int32, device=dev))


def adam_update(params, grads, state: AdamState, *, lr, b1=0.9, b2=0.95,
                eps=1e-8, wd=0.0):
    """Adam with the reference's defaults; the bias corrections are taken in
    f32 from the int32 step count. Returns new ``(params, AdamState)``."""
    c = state.count + 1
    cf = c.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=cf.device)
    bc1 = one - torch.pow(torch.full_like(cf, b1), cf)
    bc2 = one - torch.pow(torch.full_like(cf, b2), cf)
    mu = tree.map_with_path(
        lambda path, g: b1 * tree.get_path(state.mu, path) + (1 - b1) * g,
        grads)
    nu = tree.map_with_path(
        lambda path, g: b2 * tree.get_path(state.nu, path)
        + (1 - b2) * torch.square(g), grads)

    def upd(path, w):
        step = (tree.get_path(mu, path) / bc1) / (
            torch.sqrt(tree.get_path(nu, path) / bc2) + eps)
        return w - lr * (step + wd * w)

    return tree.map_with_path(upd, params), AdamState(mu, nu, c)

