"""Fault-tolerant checkpointing of training state.

Counterpart of ``repro.training.checkpoint``, in its on-disk format, so a
checkpoint written by either package restores in the other:

* atomic saves (a ``.tmp`` directory, then a rename), keep-last-k
  rotation, one ``step_{step:08d}`` directory per step holding
  ``arrays.npz`` (``leaf_{i}``, and ``leaf_{i}_checks`` for a scheme with
  out-of-place check bytes) and ``meta.json`` (``step``, ``protected``,
  ``n_leaves``, ``scheme``, ``treedef``, and one ``leaf_{i}`` record each);
* ``protected=True`` stores every protected weight as int8 + the scheme's
  ECC (the paper's in-place (64,57,1) format by default): the checkpoint
  itself is memory-fault-protected, and 4x smaller than f32. The leaf
  goes through the reference's exact sequence (a Python-float scale,
  rounding half to even, a clip to +-127, ``wot.throttle_q``, the host
  scheme's encode), so its bytes equal the reference's. Which leaves are protected
  is ``wot.is_protected_weight`` over the tree's paths, where a
  NamedTuple's field reads as ``""`` as in the reference: in a ``(params,
  SgdState)`` checkpoint the momentum of every protected weight is
  quantized too;
* ``restore(..., device=)`` puts the leaves on the device the current job
  uses; with ``shardings=`` (specs or placements, and the ``mesh``) it
  places them as DTensors on the current mesh, whatever mesh saved them
  (the reference's elastic re-meshing), each rank copying only its own
  chunks to the device.

``treedef`` is free text that neither package reads: leaves are matched by
their index in ``jax.tree_util`` order (``repro_torch.tree``). On a CUDA
device the codec of a protected leaf runs on the card (the kernel route,
byte-equal to the host's); the quantization runs on the host.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import protection, tree
from repro_torch.core import quant, wot
from repro_torch.protection.host import BLOCK


def _numpy(leaf) -> np.ndarray:
    """A leaf as a host array (a CPU tensor's shares its storage)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _host_copy(leaf) -> np.ndarray:
    """A leaf copied to host memory: a snapshot that later in-place
    updates of the leaf do not reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _protect(path, a: np.ndarray) -> bool:
    """``wot.is_protected_weight`` of a host array (as a torch dtype)."""
    if a.dtype.kind != "f":
        return False
    return wot.is_protected_weight(
        path, protection.ShapeDtype(a.shape, torch.from_numpy(
            np.empty(0, a.dtype)).dtype))


def _quantize(a: np.ndarray) -> tuple:
    """The reference's quantization of a protected leaf: a Python-float
    scale ``max|a| / 127``, ``round(a / scale)`` half to even, a clip to
    +-127, ``wot.throttle_q`` -> ``(scale, flat int8)``. It runs in torch
    on the host's cores: dividing by the scale as a tensor of ``a``'s
    dtype is the true division NumPy does for ``a / scale`` (the Python
    float taken in ``a``'s dtype), so the integers are the reference's."""
    t = torch.from_numpy(a)
    scale = float(t.abs().max()) / quant.QMAX or 1e-12
    q = torch.round(t / torch.tensor(scale, dtype=t.dtype))
    q = q.clamp_(-127, 127).to(torch.int8)
    return scale, wot.throttle_q(q.reshape(-1)).numpy()


def save(path: str, state, *, step: int, protected: bool = False,
         scheme: str = "in-place", keep: int = 3, device=None) -> str:
    """Atomic save of a tree (dicts, lists, tuples and NamedTuples of
    tensors or arrays). ``device``: where the codec of the protected
    leaves runs (default ``"cuda"``). Returns the final checkpoint dir."""
    dev = device_mod.resolve(device)
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    flat = list(tree.leaves_with_path(state))
    host_scheme = protection.get_host_scheme(scheme)
    meta = {"step": step, "protected": protected, "n_leaves": len(flat),
            "scheme": host_scheme.scheme_id,
            "treedef": f"repro_torch.tree of {len(flat)} leaves"}
    arrays = {}
    for i, (leaf_path, leaf) in enumerate(flat):
        a = _numpy(leaf)
        if protected and _protect(leaf_path, a):
            scale, q = _quantize(a)
            stored = host_scheme.encode(q, device=dev)
            arrays[f"leaf_{i}"] = stored.data
            if stored.checks is not None:
                arrays[f"leaf_{i}_checks"] = stored.checks
            meta[f"leaf_{i}"] = {"protected": True, "shape": list(a.shape),
                                 "dtype": str(a.dtype), "scale": scale,
                                 "n": int(stored.n_weights)}
        else:
            arrays[f"leaf_{i}"] = a
            meta[f"leaf_{i}"] = {"protected": False}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _rotate(path, keep)
    return final


def _steps(path: str) -> list:
    return sorted(d for d in os.listdir(path)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def _rotate(path: str, keep: int):
    for d in _steps(path)[:-keep]:
        shutil.rmtree(os.path.join(path, d))


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    ckpts = _steps(path)
    return int(ckpts[-1].split("_")[1]) if ckpts else None


def restore(path: str, tree_like, *, step: Optional[int] = None,
            device=None, shardings=None, mesh=None):
    """Restore into the structure of ``tree_like``, every leaf a tensor on
    ``device`` (default ``"cuda"``; a protected leaf is decoded there and
    dequantized as ``q (f32) * scale``, as the reference does in NumPy).

    ``shardings``: a tree of ``distributed.sharding.P`` specs (or DTensor
    placements) shaped as ``tree_like`` (a spec may stand for a subtree),
    with the ``mesh`` to place them on: every rank reads the checkpoint
    leaf by leaf on the host and copies only its own chunk of each to
    ``device``, a DTensor holding the same values as the unsharded restore
    (elastic re-meshing: the saving job's mesh does not matter). A
    protected leaf's chunk of whole 8-byte blocks is decoded on ``device``
    alone; a chunk that would cut a block is decoded on the host from the
    whole leaf. A rank's device holds its own chunks, and one chunk's
    codec buffers at a time. -> ``(tree, step)``."""
    if shardings is not None and mesh is None:
        raise ValueError("restore(shardings=...) needs the mesh to place "
                         "the leaves on")
    dev = device_mod.resolve(device)
    step, n, read = _reader(path, tree_like, step)
    if shardings is None:
        return tree.unflatten_like(tree_like,
                                   [read(i, dev) for i in range(n)]), step
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding as sh
    out = []
    for i, (p, _) in enumerate(tree.leaves_with_path(tree_like)):
        spec = sh.spec_at(shardings, p)
        pls = sh.to_placements(spec, mesh) if isinstance(spec, sh.P) else spec
        part, shape = read(i, dev, (mesh, pls))
        out.append(DTensor.from_local(part, mesh, pls,
                                      shape=torch.Size(shape),
                                      stride=_contiguous(shape)))
    return tree.unflatten_like(tree_like, out), step


def _contiguous(shape) -> tuple:
    out, acc = [], 1
    for s in reversed(tuple(shape)):
        out.append(acc)
        acc *= s
    return tuple(reversed(out))


def _block_chunks(shape, mesh, placements) -> bool:
    """True when every rank's chunk of a leaf of ``shape`` holds whole
    8-byte blocks: the last dim a block multiple, and each split of it
    (``torch.chunk``'s, nested major first) too."""
    if not shape or shape[-1] % BLOCK:
        return False
    size = shape[-1]
    for i, pl in enumerate(placements):
        if pl.is_shard(len(shape) - 1):
            size = -(-size // mesh.size(i))
            if size % BLOCK:
                return False
    return True


def _reader(path: str, tree_like, step: Optional[int]) -> tuple:
    """-> (step, number of leaves, ``read``). ``read(i, device)`` is leaf
    ``i`` as a tensor on ``device``, a protected leaf decoded there;
    ``read(i, device, (mesh, placements))`` is ``(this rank's chunk on
    device, the leaf's shape)``: a protected leaf's chunk of whole blocks
    decoded there alone, any other chunk cut from the leaf read (and
    decoded) on the host."""
    step = step if step is not None else latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    data = np.load(os.path.join(d, "arrays.npz"))
    host_scheme = protection.get_host_scheme(meta.get("scheme", "in-place"))
    n = len(list(tree.leaves_with_path(tree_like)))
    if n != meta["n_leaves"]:
        raise ValueError(f"{path} step {step} holds {meta['n_leaves']} "
                         f"leaves, the tree to restore into {n}")

    def read(i: int, dev, chunk=None):
        from repro_torch.distributed import local
        lm_ = meta[f"leaf_{i}"]
        if chunk is not None and not (lm_["protected"] and _block_chunks(
                tuple(lm_["shape"]), *chunk)):
            whole = read(i, torch.device("cpu"))
            return (local.shard_slice(whole, *chunk).to(dev, copy=True)
                    .contiguous(), tuple(whole.shape))
        a = data[f"leaf_{i}"]
        if not lm_["protected"]:
            return torch.from_numpy(a).to(dev)
        checks = (data[f"leaf_{i}_checks"]
                  if f"leaf_{i}_checks" in data.files else None)
        shape = tuple(lm_["shape"])
        dtype = torch.from_numpy(np.empty(0, lm_["dtype"])).dtype
        if chunk is not None:   # this rank's blocks only
            img = local.shard_slice(torch.from_numpy(a).view(shape), *chunk)
            if checks is not None:
                checks = local.shard_slice(torch.from_numpy(checks).view(
                    *shape[:-1], -1), *chunk).contiguous().numpy().ravel()
            a, shape = img.contiguous().numpy().ravel(), tuple(img.shape)
        if a.size:
            q = host_scheme.decode(protection.Stored(
                a, checks, a.size if chunk else lm_["n"]), device=dev)
        else:   # an uneven split's empty chunk: nothing to launch
            q = np.empty(0, np.int8)
        q = q.reshape(shape)
        scale = torch.tensor(np.float32(lm_["scale"]), device=dev)
        w = (torch.from_numpy(q).to(dev).to(torch.float32) * scale).to(dtype)
        return w if chunk is None else (w, tuple(lm_["shape"]))
    return step, n, read


class AsyncCheckpointer:
    """Background-thread checkpointer: training never blocks on I/O.

    ``save`` copies every leaf to host memory before its thread starts:
    the port's train step updates the masters and the momentum in place,
    so the thread must not read the live tensors. A save that failed in
    its thread raises from the next ``wait`` (or ``save``). ``device``:
    as in :func:`save` (default ``"cuda"``)."""

    def __init__(self, path: str, *, protected: bool = False, keep: int = 3,
                 device=None):
        self.path, self.protected, self.keep = path, protected, keep
        self.device = device_mod.resolve(device)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, state, step: int):
        self.wait()
        host_tree = tree.map_with_path(lambda _, x: _host_copy(x), state)

        def run():
            try:
                save(self.path, host_tree, step=step,
                     protected=self.protected, keep=self.keep,
                     device=self.device)
            except BaseException as e:  # re-raised by wait()
                self._error = e
        self._thread = threading.Thread(target=run)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
