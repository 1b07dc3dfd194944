"""ADMM-based WOT training (paper §4.1, the evaluated-and-rejected variant).

Counterpart of ``repro.training.admm``. The paper formulates the WOT
constraint through ADMM (Eqs. 5-9) and alternates

  1. W-step: SGD on f(W) + lambda ||W||_F^2 + gamma ||W - Z + U||_F^2
     (the penalty over every leaf);
  2. Z-step: project W + U onto the constraint set S (clamp positions
     0..6 of every block), four throttle passes;
  3. U-step: U += W - Z,

and reports that it fails to drive the large-value count to zero and
needs a lossy final hard clamp (:func:`finalize`, eight passes).
``benchmarks/wot_admm_compare.py`` reproduces that comparison. The
projection runs on the route ``backend`` picks (``"cuda"``: the
``quantize_throttle`` kernel on every protected leaf, each pass).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import tree
from repro_torch.core import wot

from . import optim


class AdmmState(NamedTuple):
    opt: optim.SgdState
    z: dict
    u: dict


def _project(params, iters: int = 4, *, backend="torch"):
    """Projection onto S in the float domain. Clamping can shrink a
    tensor's max and hence its quantization scale, re-exposing values at
    the new scale: ``iters`` throttle passes approach the fixed point (4
    suffice at f32, as in the reference)."""
    for _ in range(iters):
        params = wot.throttle_tree(params, backend=backend)
    return params


def admm_init(params) -> AdmmState:
    return AdmmState(optim.sgd_init(params),
                     tree.map_with_path(lambda _, w: w.clone(), params),
                     tree.map_with_path(lambda _, w: torch.zeros_like(w),
                                        params))


def make_admm_step(forward_loss, *, lr=1e-3, mu=0.9, wd=1e-4, gamma=1e-3,
                   backend="torch"):
    """``forward_loss(params, batch) -> scalar`` (the QAT loss). Returns
    ``admm_step(params, state, batch) -> (params, state, loss)``: new
    tensors, ``loss`` the augmented loss before the update."""

    def aug_loss(params, z, u, batch):
        base = forward_loss(params, batch)
        pen = 0.0
        for (_, w), (_, z_), (_, u_) in zip(
                tree.leaves_with_path(params), tree.leaves_with_path(z),
                tree.leaves_with_path(u)):
            pen = pen + torch.sum(torch.square(w - z_ + u_))
        return base + gamma * pen

    def admm_step(params, state: AdmmState, batch):
        ws = [w.detach().requires_grad_()
              for _, w in tree.leaves_with_path(params)]
        loss = aug_loss(tree.unflatten_like(params, ws), state.z, state.u,
                        batch)
        grads = torch.autograd.grad(loss, ws, allow_unused=True)
        with torch.no_grad():
            grads = tree.unflatten_like(params, [
                torch.zeros_like(w) if g is None else g
                for w, g in zip(ws, grads)])
            params, opt = optim.sgd_update(params, grads, state.opt, lr=lr,
                                           mu=mu, wd=wd)
            # Z-step: project W + U onto S
            wu = tree.map_with_path(
                lambda path, w: w + tree.get_path(state.u, path), params)
            z = _project(wu, backend=backend)
            # U-step
            u = tree.map_with_path(
                lambda path, u_: u_ + tree.get_path(params, path)
                - tree.get_path(z, path), state.u)
        return params, AdmmState(opt, z, u), loss.detach()

    return admm_step


@torch.no_grad()
def finalize(params, *, backend="torch"):
    """Paper: after ADMM training the constraint still is not met; the
    large values left in protected positions are hard-clamped (lossy)."""
    return _project(params, iters=8, backend=backend)
