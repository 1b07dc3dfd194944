"""SGD with momentum, the paper's WOT optimizer (§5.2: lr 1e-4, momentum
0.9, weight decay 1e-4 through the Frobenius regularizer).

Counterpart of ``SgdState``, ``sgd_init`` and ``sgd_update`` of
``repro.training.optim``, as plain functions on nested dicts of tensors.
AdamW is not ported yet.
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
    new_m: dict = {}

    def upd(path, w):
        g = tree.get_path(grads, path) + 2.0 * wd * w
        m = mu * tree.get_path(state.momentum, path) + g
        tree.set_path(new_m, path, m)
        return w - lr * m

    new_p = tree.map_with_path(upd, params)
    return new_p, SgdState(new_m)

