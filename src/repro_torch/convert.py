"""Carry parameters and encoded trees across from NumPy into the port.

The JAX reference and the port cannot share random streams, so a test that
holds one against the other draws its inputs once and hands both packages
the same arrays. This module turns such arrays into the port's objects:

* :func:`params_from_numpy` — a nested dict/list of NumPy arrays (e.g. the
  reference's ``lm.init_params`` or ``cnn.init_*`` through ``np.asarray``)
  into tensors, lists kept in their order;
* :func:`protected_from_numpy` — an encoded tree whose protected leaves are
  exported as dicts ``{"enc", "checks", "scale", "scheme_id",
  "orig_shape"}`` into the port's ``ProtectedTensor`` leaves;
* :func:`sgd_state_from_numpy` — the SGD momentum tree into an
  ``optim.SgdState``, so both packages can start training from the same
  ``(params, opt_state)``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.protection.tensor import ProtectedTensor

_EXPORT_KEYS = {"enc", "checks", "scale", "scheme_id", "orig_shape"}


def _tensor(a, dev):
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def params_from_numpy(tree, *, device=None):
    """Nested dict/list of arrays -> the same dicts/lists of tensors on
    ``device``."""
    dev = device_mod.resolve(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_from_numpy(v, device=dev) for v in tree]
    return _tensor(tree, dev)


def protected_from_numpy(tree, *, device=None):
    """Encoded tree with exported protected leaves -> tree with
    ``ProtectedTensor`` leaves (other leaves become tensors)."""
    dev = device_mod.resolve(device)
    if isinstance(tree, dict) and set(tree) == _EXPORT_KEYS:
        return ProtectedTensor(
            enc=_tensor(tree["enc"], dev),
            checks=None if tree["checks"] is None else _tensor(tree["checks"],
                                                               dev),
            scale=_tensor(np.asarray(tree["scale"], np.float32), dev),
            scheme_id=str(tree["scheme_id"]),
            orig_shape=tuple(int(s) for s in tree["orig_shape"]))
    if isinstance(tree, dict):
        return {k: protected_from_numpy(v, device=dev) for k, v in tree.items()}
    return _tensor(tree, dev)


def sgd_state_from_numpy(momentum, *, device=None):
    """Nested dict of momentum arrays -> ``optim.SgdState`` on ``device``."""
    from repro_torch.training.optim import SgdState
    return SgdState(params_from_numpy(momentum, device=device))
