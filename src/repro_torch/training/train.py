"""The QATT training step (paper §4.1): QAT forward and backward over
fake-quantized weights with f32 masters, gradient accumulation folded into
SGD momentum, then WOT throttling of the masters.

Counterpart of ``qat_wt``, ``qat_wt_bf16``, ``_split_micro``,
``make_train_step`` and ``make_cnn_train_step`` of
``repro.training.train``. The throttle runs on the route ``backend`` picks
(``"cuda"``: the ``quantize_throttle`` kernel on every protected leaf
after every update).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import tree
from repro_torch.core import quant, wot
from repro_torch.distributed import local
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.config import ArchConfig
from repro_torch.protection.backends import get_backend

from . import optim


def qat_wt(w):
    """Weight transform of the QAT forward: fake-quant every >= 2-D float
    tensor (inside a ``fake_quant`` profiler range)."""
    if w.ndim >= 2 and w.is_floating_point():
        with torch.profiler.record_function("fake_quant"):
            return quant.fake_quant(w)
    return w


def qat_wt_bf16(w):
    """Fake-quant in f32, then a bf16 cast before use (both inside a
    ``fake_quant`` profiler range)."""
    if w.ndim >= 2 and w.is_floating_point():
        with torch.profiler.record_function("fake_quant"):
            return quant.fake_quant(w).to(torch.bfloat16)
    return w


def _split_micro(batch: dict, n_micro: int) -> list:
    """Split every (B, ...) array of ``batch`` into ``n_micro`` contiguous
    row blocks -> list of ``n_micro`` batches. A batch sharded over 'data'
    splits each rank's rows where they lie (``distributed.local``)."""
    out = [dict() for _ in range(n_micro)]
    for k, x in batch.items():
        if x.shape[0] % n_micro:
            raise ValueError(f"batch {x.shape[0]} is not a multiple of "
                             f"{n_micro} microbatches")
        parts = (local.split_rows(x, n_micro) if local.is_dtensor(x)
                 else x.split(x.shape[0] // n_micro))
        for i, part in enumerate(parts):
            out[i][k] = part
    return out


def make_train_step(cfg: ArchConfig, *, qat: bool = True,
                    wot_throttle: bool = True, lr: float = 1e-4,
                    mu: float = 0.9, wd: float = 1e-4, chunk: int = 2048,
                    bf16_weights: bool = True,
                    loss_fn: Optional[Callable] = None, backend="torch"):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    loss)``.

    The step updates the tensors of ``params`` and of the momentum IN PLACE
    (the reference returns new arrays) and returns them. Each microbatch's
    gradients are folded into the momentum and freed at once, so the peak
    holds the masters, the momentum and one set of gradients. The fused
    momentum keeps the reference's op order: ``m = mu*m``; per microbatch
    ``m += g * (1/n)``; ``m += 2*wd*w``; ``w -= lr*m``; then the throttle.
    The optimizer, the throttle and the forward's fake-quant run inside
    ``record_function`` ranges named ``sgd_momentum``, ``wot_throttle``
    and ``fake_quant``, so a profile of a step can split its device time.
    The throttle writes the moved masters back in place
    (:func:`wot.throttle_tensor_`).
    """
    wt = (qat_wt_bf16 if bf16_weights else qat_wt) if qat else L.Identity
    lfn = loss_fn or (lambda p, b: lm.loss_fn(cfg, p, b, wt=wt, chunk=chunk))
    be = get_backend(backend)

    def train_step(params, opt_state, batch):
        leaves = list(tree.leaves_with_path(params))
        moms = [tree.get_path(opt_state.momentum, path) for path, _ in leaves]
        inv = 1.0 / cfg.microbatch
        with torch.profiler.record_function("sgd_momentum"), \
                torch.no_grad():
            for m in moms:
                m.mul_(mu)
        loss_sum = 0.0
        for mb in _split_micro(batch, cfg.microbatch):
            ps = [w.detach().requires_grad_() for _, w in leaves]
            ptree: dict = {}
            for (path, _), p in zip(leaves, ps):
                tree.set_path(ptree, path, p)
            loss = lfn(ptree, mb)
            loss.backward()
            with torch.profiler.record_function("sgd_momentum"), \
                    torch.no_grad():
                for m, p in zip(moms, ps):
                    if p.grad is not None:   # None: the loss ignores p
                        m += local.like(p.grad, m).to(m.dtype) * inv
                    p.grad = None
            loss_sum = loss_sum + loss.detach()
            del ps, ptree, loss
        with torch.profiler.record_function("sgd_momentum"), \
                torch.no_grad():
            for (_, w), m in zip(leaves, moms):
                m += (2.0 * wd) * w
                w -= lr * m.to(w.dtype)
        if wot_throttle:   # wot.throttle_tree, leaf by leaf in place
            with torch.profiler.record_function("wot_throttle"), \
                    torch.no_grad():
                for path, w in leaves:
                    if wot.is_protected_weight(path, w):
                        wot.throttle_tensor_(w, backend=be)
        return params, opt_state, loss_sum * inv

    return train_step


def make_cnn_train_step(cfg_forward: Callable, *, qat: bool = True,
                        wot_throttle: bool = True, lr: float = 1e-4,
                        mu: float = 0.9, wd: float = 1e-4, backend="torch"):
    """QATT for the paper's CNNs: ``cfg_forward(params, images, wt) ->
    logits``. Returns ``(train_step, eval_step)``:
    ``train_step(params, opt_state, batch) -> (params, opt_state, loss)``
    (new tensors, the reference's ``sgd_update`` then, with
    ``wot_throttle``, ``wot.throttle_tree`` on ``backend``) and
    ``eval_step(params, batch) -> accuracy``. ``batch`` holds tensors:
    ``images`` and int ``labels``. Every leaf takes a gradient (batch-norm
    statistics too, as in the reference, whose ``batchnorm`` reads them)."""
    wt = qat_wt if qat else L.Identity
    be = get_backend(backend)

    def loss_fn(params, batch):
        logits = cfg_forward(params, batch["images"], wt).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, batch["labels"].long()[:, None])[:, 0]
        return (lse - tgt).mean()

    def train_step(params, opt_state, batch):
        ws = [w.detach().requires_grad_()
              for _, w in tree.leaves_with_path(params)]
        loss = loss_fn(tree.unflatten_like(params, ws), batch)
        grads = torch.autograd.grad(loss, ws, allow_unused=True)
        with torch.no_grad():
            grads = tree.unflatten_like(params, [
                torch.zeros_like(w) if g is None else g
                for w, g in zip(ws, grads)])
            params, opt_state = optim.sgd_update(params, grads, opt_state,
                                                 lr=lr, mu=mu, wd=wd)
            if wot_throttle:
                params = wot.throttle_tree(params, backend=be)
        return params, opt_state, loss.detach()

    @torch.no_grad()
    def eval_step(params, batch):
        logits = cfg_forward(params, batch["images"], wt)
        return (logits.argmax(-1) == batch["labels"]).to(
            torch.float32).mean()

    return train_step, eval_step
