"""Shard-local execution: how a kernel runs on a sharded path, and the
collectives that keep a sharded result equal to the unsharded one.

The sharded cells place every leaf as a DTensor by its spec, and the aten
ops between the weights propagate their placements (DTensor takes GSPMD's
role). A kernel bound by ``ctypes`` cannot take a DTensor: it reads
``data_ptr()``. So each point where the model reaches a kernel, or the
codec's plain version, runs on the local shard through
``to_local()`` / ``DTensor.from_local`` here, and declares the placements
its parallel rule implies:

* a protected weight (:func:`sharded_matmul`) gathers its *encoded* image
  over every axis but 'model' (FSDP moves the int8 bytes, plus any
  checks), then decodes at use on the local shard: a column-parallel
  image (sharded on its last dim) gives an output sharded on the last dim;
  a row-parallel one (sharded on its first dim) takes the input sharded on
  its last dim and gives a ``Partial`` output that the next op's
  all-reduce sums. The image is never gathered whole before a kernel;
* a whole-leaf decode (:func:`decode_leaf_with_flags`) decodes each shard
  where it lies;
* the paged KV cache's write and attention (:func:`paged_local`) run on
  each data rank's pages, and the dense caches take their writes where
  the slot lies (:func:`put_rows`).

Where a statistic taken over a local shard would differ from the global
one, a collective joins the shards: the (corrected, DUE) counts are summed
so that every block counts once (:func:`count_once`), and the QATT
throttle's absmax is an all-reduce MAX (``kernels.quant_throttle``).
"""
from __future__ import annotations

import math

import torch

BLOCK = 8


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _rep():
    from torch.distributed.tensor import Replicate
    return Replicate()


def _coord(mesh) -> list:
    return list(mesh.get_coordinate())


def _is_shard(pl, dim=None) -> bool:
    from torch.distributed.tensor import Shard
    return isinstance(pl, Shard) and (dim is None or pl.dim == dim)


def owner(mesh, placements) -> bool:
    """True on the one rank of each group of replicas: coordinate 0 along
    every mesh dimension the value is not sharded on."""
    return all(c == 0 for c, pl in zip(_coord(mesh), placements)
               if not _is_shard(pl))


def all_reduce(x: torch.Tensor, op: str, mesh) -> torch.Tensor:
    """One all-reduce ("sum" | "max") of a local tensor over every rank of
    ``mesh`` (its dimensions flattened into one group, built once per
    mesh)."""
    import torch.distributed._functional_collectives as funcol
    if mesh.ndim > 1:
        flat = getattr(mesh, "_all_ranks", None)
        if flat is None:   # a real (not fake) mesh tensor is read here
            from torch._subclasses.fake_tensor import unset_fake_temporarily
            with unset_fake_temporarily():
                flat = mesh._flatten()
            mesh._all_ranks = flat
        mesh = flat
    return funcol.all_reduce(x, op, mesh)


def count_once(counts: torch.Tensor, mesh, placements) -> torch.Tensor:
    """Counts taken on the local shard of a value placed by ``placements``
    -> the global counts on every rank (a plain tensor): summed over the
    shards, each replica counted once (one all-reduce over the mesh)."""
    c = counts if owner(mesh, placements) else torch.zeros_like(counts)
    return all_reduce(c, "sum", mesh)


def shard_slice(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's chunk of a whole tensor ``t`` under ``placements``
    (DTensor's ``Shard`` split, ``torch.chunk``'s: chunks of the size
    rounded up, the last ones short or empty; several axes on one dim split
    it major first)."""
    coord = _coord(mesh)
    for i, pl in enumerate(placements):
        if _is_shard(pl):
            size = t.shape[pl.dim]
            n = -(-size // mesh.size(i))
            start = min(coord[i] * n, size)
            t = t.narrow(pl.dim, start, min(n, size - start))
    return t


def shard_offset(mesh, placements, dim: int, local_size: int) -> int:
    """The global index of this rank's first element along ``dim``."""
    coord, k = _coord(mesh), 0
    for i, pl in enumerate(placements):
        if _is_shard(pl, dim):
            k = k * mesh.size(i) + coord[i]
    return k * local_size


def as_dtensor(x, mesh):
    """A plain tensor on a sharded path -> a DTensor replicated over
    ``mesh``; a DTensor as it is."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [_rep()] * mesh.ndim)


def _model_dim(mesh):
    names = tuple(mesh.mesh_dim_names or ())
    return names.index("model") if "model" in names else None


# ---------------------------------------------------------------------------
# protected weights
# ---------------------------------------------------------------------------


def _gathered(pt) -> tuple:
    """The placements a protected image is decoded under: sharded only
    along 'model' (FSDP gathers the encoded bytes over the other axes), and
    only where every local shard keeps whole 8-byte blocks (a last dim
    split off the block grid is gathered too). A flat-padded image keeps
    its 1-D placements: its specs shard whole blocks only."""
    enc = pt.enc
    mesh = enc.device_mesh
    if pt.is_flat:
        return tuple(enc.placements)
    mdim = _model_dim(mesh)
    if mdim is not None and mesh.size(mdim) == 1:
        mdim = None    # one model shard: the image is whole on every rank
    out = []
    for i, pl in enumerate(enc.placements):
        keep = i == mdim and _is_shard(pl)
        if keep and pl.dim == enc.ndim - 1:
            keep = (enc.shape[-1] // mesh.size(i)) % BLOCK == 0
        out.append(pl if keep else _rep())
    return tuple(out)


def local_image(pt, placements):
    """A ProtectedTensor whose ``enc`` is a DTensor -> the local
    ProtectedTensor under ``placements`` (its enc redistributed there, the
    replicated checks cut to the same blocks, the replicated scale) and
    its local ``orig_shape``."""
    import dataclasses
    enc = pt.enc
    mesh = enc.device_mesh
    enc_l = enc.redistribute(mesh, placements).to_local()
    checks = pt.checks
    if checks is not None:
        checks = checks.to_local() if is_dtensor(checks) else checks
        checks = shard_slice(checks, mesh, placements)
    scale = pt.scale.to_local() if is_dtensor(pt.scale) else pt.scale
    orig = tuple(enc_l.shape) if not pt.is_flat else tuple(pt.orig_shape)
    return dataclasses.replace(pt, enc=enc_l, checks=checks, scale=scale,
                               orig_shape=orig)


def decode_leaf_with_flags(pt, dtype, backend):
    """:func:`protection.policy.decode_leaf_with_flags` of a sharded image:
    each shard decodes where it lies (the kernel on a CUDA shard) -> (a
    DTensor weight placed as the image, global corrected, global DUE)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.protection import policy
    enc = pt.enc
    mesh, pls = enc.device_mesh, tuple(enc.placements)
    loc = local_image(pt, pls)
    q, corrected, due = policy.get_scheme(pt.scheme_id).decode_with_flags(
        loc.enc, loc.checks, policy.get_backend(backend))
    flags = count_once(torch.stack([torch.as_tensor(corrected),
                                    torch.as_tensor(due)]).to(torch.int32),
                       mesh, pls)
    w_l = (q.to(torch.float32) * loc.scale).to(dtype)
    w = DTensor.from_local(w_l, mesh, pls, shape=enc.shape,
                           stride=enc.stride())
    if pt.is_flat:
        w = w.redistribute(mesh, [_rep()] * mesh.ndim).to_local()
        w = w.reshape(-1)[: pt.n_weights].reshape(pt.orig_shape)
    return w, flags[0], flags[1]


def sharded_matmul(view, x):
    """``view.matmul(x)`` for a decode-at-use view over a sharded image.

    The image is gathered over every axis but 'model' (:func:`_gathered`),
    the view's kernel or inline decode runs on the local shard, and the
    output's placements follow the parallel rule: column-parallel (the
    image's last dim on 'model') -> output sharded on its last dim;
    row-parallel (the first dim) -> ``Partial`` over 'model'; replicated
    -> the input's placements. Counts are summed over the shards
    (:func:`count_once`). Calibration absmaxes are taken on the DTensor
    input, so they are global."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    from repro_torch.protection.fused import ProtectedWeight
    pt = view.pt
    mesh = pt.enc.device_mesh
    x = as_dtensor(x, mesh)
    pls = _gathered(pt)
    mdim = _model_dim(mesh)
    mpl = pls[mdim] if mdim is not None else _rep()
    col = _is_shard(mpl, pt.enc.ndim - 1)
    row = _is_shard(mpl, 0) and not col
    if (col or row) and (view.abft or (row and (view.act_quant is not None
                                                or view.clamp is not None))):
        raise NotImplementedError(
            "a guarded or int8 matmul over a model-sharded image needs its "
            "checksums, clamps or activation scales reduced across the "
            "shards; serve guarded leaves replicated over 'model'")
    last = x.ndim - 1
    x_pls = [_rep() if _is_shard(pl, last) else pl for pl in x.placements]
    if mdim is not None:
        x_pls[mdim] = Shard(last) if row else (_rep() if col else
                                               x_pls[mdim])
    x_l = x.redistribute(mesh, x_pls).to_local()
    if view._observe is not None:
        view._observe(x.to(torch.float32).abs().amax().full_tensor())
    loc = local_image(pt, pls)

    def record(corrected, due):
        f = count_once(torch.stack([torch.as_tensor(corrected),
                                    torch.as_tensor(due)]).to(torch.int32),
                       mesh, pls)
        view.record(f[0], f[1])

    local_view = ProtectedWeight(
        loc, view.backend, record=record, act_quant=view.act_quant,
        a_scale=view.a_scale, abft=view.abft, clamp=view.clamp,
        record_abft=view._record_abft, abft_per_slot=view.abft_per_slot)
    y_l = local_view.matmul(x_l)
    y_pls = list(x_pls)
    if mdim is not None:
        y_pls[mdim] = (Shard(y_l.ndim - 1) if col else
                       Partial() if row else x_pls[mdim])
    shape = (*x.shape[:-1], pt.orig_shape[-1])
    return DTensor.from_local(y_l, mesh, y_pls, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def per_head(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)`` -> (B, H, Sq, Dv) for attention over DTensors
    (B, H, S, D): each (batch row, head) is independent, so every rank
    attends the rows and heads it holds, the sequence gathered whole
    (the flash kernel, or the plain chunked loop, on local tensors). The
    gradients flow through ``to_local`` / ``from_local``."""
    from torch.distributed.tensor import DTensor
    mesh = next(t for t in (q, k, v) if is_dtensor(t)).device_mesh
    qd = as_dtensor(q, mesh)
    pls = [pl if _is_shard(pl, 0) or _is_shard(pl, 1) else _rep()
           for pl in qd.placements]
    ql, kl, vl = (as_dtensor(t, mesh).redistribute(mesh, pls).to_local()
                  for t in (q, k, v))
    o = fn(ql, kl, vl, **kw)
    shape = torch.Size((*qd.shape[:3], v.shape[-1]))
    return DTensor.from_local(o, mesh, pls, shape=shape,
                              stride=_contiguous_stride(shape))


def tp_operands(x, w):
    """The operands of ``x @ w`` for a sharded float weight ``w`` (K, N):
    the weight gathered over every axis but 'model' (FSDP: its gradient
    reduce-scatters back into the shards), the input laid out as the
    weight's parallel rule wants it over 'model': whole rows for a
    column-parallel weight (a sequence-parallel input is gathered first,
    as Megatron's SP does), rows split over K for a row-parallel one. The
    activations are never gathered over 'data'. -> (x, w)."""
    from torch.distributed.tensor import Shard
    mesh = w.device_mesh
    x = as_dtensor(x, mesh)
    mdim = _model_dim(mesh)
    if mdim is None or w.ndim != 2:
        return x, w
    w = w.redistribute(mesh, [pl if i == mdim else _rep()
                              for i, pl in enumerate(w.placements)])
    mpl = w.placements[mdim]
    last = x.ndim - 1
    pls = list(x.placements)
    if _is_shard(mpl, 1):
        pls[mdim] = _rep()
    elif _is_shard(mpl, 0):
        pls[mdim] = Shard(last)
    pls = [pl if i == mdim or not _is_shard(pl, last) else _rep()
           for i, pl in enumerate(pls)]
    return x.redistribute(mesh, pls), w


def _contiguous_stride(shape) -> tuple:
    out, acc = [], 1
    for s in reversed(tuple(shape)):
        out.append(acc)
        acc *= s
    return tuple(reversed(out))


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def cache_attention(q, k, v, length_mask, plain):
    """Single-token attention over a DTensor cache (B, H, S, D) whose slots
    may be split over 'model' (and rows over 'data'): each rank attends its
    own slots, and the partial softmaxes join across the slot shards (the
    max by an all-reduce MAX, the weighted values and the normalizers by
    all-reduce sums). With the slots whole on every rank this is
    ``plain(q, k, v, length_mask)`` on the local rows."""
    from torch.distributed.tensor import DTensor, Shard
    mesh = k.device_mesh
    kpls = tuple(k.placements)
    bpls = [pl if _is_shard(pl, 0) else _rep() for pl in kpls]
    qd = as_dtensor(q, mesh).redistribute(mesh, bpls).to_local()
    k_l = k.redistribute(mesh, [pl if _is_shard(pl, 0) or _is_shard(pl, 2)
                                else _rep() for pl in kpls])
    vd = v.redistribute(mesh, k_l.placements)
    mask = None
    if length_mask is not None:   # (B, S): rows and slots as the cache's
        mpls = [Shard(0) if _is_shard(pl, 0) else
                Shard(1) if _is_shard(pl, 2) else _rep()
                for pl in k_l.placements]
        mask = as_dtensor(length_mask, mesh).redistribute(mesh,
                                                          mpls).to_local()
    s_dims = [i for i, pl in enumerate(k_l.placements) if _is_shard(pl, 2)
              and mesh.size(i) > 1]
    k_l, v_l = k_l.to_local(), vd.to_local()
    if not s_dims:
        o = plain(qd, k_l, v_l, mask)
    else:
        scale = 1.0 / math.sqrt(qd.shape[-1])
        sc = torch.einsum("bhqd,bhkd->bhqk", qd, k_l).to(torch.float32) * scale
        if mask is not None:
            sc = torch.where(mask[:, None, None, :], sc, -1e30)
        m = sc.amax(dim=-1, keepdim=True)
        gm = m
        for i in s_dims:
            gm = _dim_reduce(gm, "max", mesh, i)
        p = torch.exp(sc - gm)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bhqk,bhkd->bhqd", p, v_l.to(torch.float32))
        for i in s_dims:
            o = _dim_reduce(o, "sum", mesh, i)
            l = _dim_reduce(l, "sum", mesh, i)
        o = (o / l).to(v_l.dtype)
    shape = torch.Size((q.shape[0], q.shape[1], q.shape[2], v.shape[-1]))
    return DTensor.from_local(o, mesh, bpls, shape=shape,
                              stride=_contiguous_stride(shape))


def _dim_reduce(x, op: str, mesh, dim: int):
    import torch.distributed._functional_collectives as funcol
    return funcol.all_reduce(x, op, (mesh, dim))


def splittable(t, n: int):
    """A DTensor whose last dim is about to split into ``n`` groups: where
    the shards of that dim outnumber what ``n`` divides into, the dim is
    gathered."""
    last = t.ndim - 1
    k = math.prod(t.device_mesh.size(i) for i, pl in enumerate(t.placements)
                  if _is_shard(pl, last))
    if k > 1 and n % k:
        return t.redistribute(t.device_mesh, [
            _rep() if _is_shard(pl, last) else pl for pl in t.placements])
    return t


class _Regrad(torch.autograd.Function):
    """Identity; its gradient is redistributed by ``rule(placements)``."""

    @staticmethod
    def forward(ctx, t, rule):
        ctx.rule = rule
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g):
            pls = tuple(ctx.rule(g.ndim, tuple(g.placements)))
            if pls != tuple(g.placements):
                g = g.redistribute(g.device_mesh, pls)
        return g, None


def _regrad(t, rule):
    if is_dtensor(t) and t.requires_grad:
        return _Regrad.apply(t, rule)
    return t


def grad_as_output(y):
    """A sharded projection's output whose gradient comes back split on the
    batch and the features only (a partial sum's gradient replicated, the
    middle dims whole): a weight gradient then never multiplies a (batch x
    sequence) product split two ways (DTensor's strided shards)."""
    return _regrad(y, lambda n, pls: [
        pl if _is_shard(pl, 0) or _is_shard(pl, n - 1) else _rep()
        for pl in pls])


def whole_grad(t, dim: int):
    """``t``, with its gradient gathered along ``dim`` on the way back (a
    backward view that splits that dim, e.g. GQA's repeat, cannot cut a
    shard)."""
    return _regrad(t, lambda n, pls: [_rep() if _is_shard(pl, dim) else pl
                                      for pl in pls])


def embed(emb, tokens, dtype):
    """``emb.to(dtype)[tokens]`` on a sharded path: the table gathered whole
    (its gradient reduce-scattered back into the table's shards), each
    rank looking up the tokens it holds; the table's gradient is partial
    over the mesh axes the tokens are split on (every rank adds its own
    tokens' rows)."""
    from torch.distributed.tensor import DTensor, Partial
    mesh = next(t for t in (emb, tokens) if is_dtensor(t)).device_mesh
    tok = as_dtensor(tokens, mesh)
    tpls = tuple(tok.placements)
    grad_pls = [Partial() if _is_shard(pl) else _rep() for pl in tpls]
    table = as_dtensor(emb, mesh).redistribute(mesh, [_rep()] * mesh.ndim)
    out = table.to_local(grad_placements=grad_pls).to(dtype)[tok.to_local()]
    shape = torch.Size((*tok.shape, emb.shape[-1]))
    return DTensor.from_local(out, mesh, tpls, shape=shape,
                              stride=_contiguous_stride(shape))


def take_last(x, idx):
    """``x.gather(-1, idx[..., None])[..., 0]`` for a DTensor whose last
    dim may be split over shards (vocab-parallel logits): each shard picks
    its own entries through a one-hot mask and the shards' sums join. Every
    other entry adds an exact zero, so the values are the gather's."""
    hot = torch.nn.functional.one_hot(idx.long(), x.shape[-1]).to(torch.bool)
    return torch.where(hot, x, torch.zeros((), dtype=x.dtype)).sum(-1)


def put_rows(buf, rows, slot, val) -> None:
    """``buf[rows, slot] = val`` for a dense cache buffer (B, S, ...) —
    in place. A DTensor buffer (batch over 'data', slots over 'model') is
    written shard by shard: each rank writes the rows it holds whose slot
    falls in its slot range (a masked write, no data-dependent shape)."""
    if not is_dtensor(buf):
        buf[rows, slot] = val
        return
    mesh, pls = buf.device_mesh, tuple(buf.placements)
    bl = buf.to_local()
    bpls = [pl if _is_shard(pl, 0) else _rep() for pl in pls]  # its rows
    val_l = as_dtensor(val, mesh).redistribute(mesh, bpls).to_local()
    slot_l = as_dtensor(slot, mesh).redistribute(mesh, bpls).to_local()
    s_l = bl.shape[1]
    lo = shard_offset(mesh, pls, 1, s_l)
    inside = (slot_l >= lo) & (slot_l < lo + s_l)
    ls = (slot_l - lo).clamp(0, s_l - 1)
    r = torch.arange(bl.shape[0], device=bl.device)
    keep = inside.reshape(-1, *([1] * (val_l.ndim - 1)))
    bl[r, ls] = torch.where(keep, val_l.to(bl.dtype), bl[r, ls])


def assign(dst, src) -> None:
    """``dst.copy_(src)`` where ``dst`` may be a DTensor state buffer: the
    source is laid out as the destination first."""
    if is_dtensor(dst):
        mesh = dst.device_mesh
        src = as_dtensor(src, mesh).redistribute(mesh, dst.placements)
        dst.to_local().copy_(src.to_local())
        return
    dst.copy_(src)


def paged_local(fn, lc: dict, q, k, v, pos, *, per_slot: bool):
    """The paged KV cache's write and attention on a sharded cache:
    ``fn(lc_local, q, k, v, pos) -> (o (B, H, 1, hd), flags)`` runs on each
    rank's pages.

    Pools are sharded over 'data' by whole pages and the identity page
    tables are batch-major, so when the batch is split the same way each
    data rank attends its own rows over its own pages (its table rows
    rebased to its first page). Otherwise the pools are gathered, every
    rank attends the whole batch, and each writes its own pages back.
    Flags are summed over the data ranks, once per replica; per-slot flags
    land in their global rows."""
    from torch.distributed.tensor import DTensor
    pool_keys = [k_ for k_ in ("k_pages", "k_checks", "k_scale", "v_pages",
                               "v_checks", "v_scale") if lc.get(k_) is not None]
    mesh = lc["k_pages"].device_mesh
    ppls = tuple(lc["k_pages"].placements)
    qd = as_dtensor(q, mesh)
    n_split = math.prod(mesh.size(i) for i, pl in enumerate(ppls)
                        if _is_shard(pl, 0))
    split = n_split > 1 and qd.shape[0] % n_split == 0
    if split:
        bpls = [pl if _is_shard(pl, 0) else _rep() for pl in ppls]
    else:
        bpls = [_rep()] * mesh.ndim
    loc = {}
    for key in pool_keys:
        loc[key] = (lc[key].to_local() if split else
                    lc[key].redistribute(mesh, bpls).to_local())
    table = lc["kv_table"]
    table = table.to_local() if is_dtensor(table) else table
    qs = [as_dtensor(t, mesh).redistribute(mesh, bpls).to_local()
          for t in (q, k, v, pos)]
    b_l = qs[0].shape[0]
    row0 = shard_offset(mesh, bpls, 0, b_l)
    page0 = shard_offset(mesh, ppls, 0, loc["k_pages"].shape[0]) if split \
        else 0
    loc["kv_table"] = table[row0:row0 + b_l] - page0
    o_l, flags = fn(loc, *qs)
    if not split:   # write each rank's own pages back into its shard
        for key in pool_keys:
            if any(_is_shard(pl) for pl in lc[key].placements):
                lc[key].to_local().copy_(
                    shard_slice(loc[key], mesh, lc[key].placements))
    if per_slot:
        full = torch.zeros((*flags.shape[:-1], qd.shape[0]),
                           dtype=flags.dtype, device=flags.device)
        full[..., row0:row0 + b_l] = flags
        flags = full
    flags = count_once(flags, mesh, bpls)
    o = DTensor.from_local(o_l, mesh, bpls,
                           shape=torch.Size((qd.shape[0], *o_l.shape[1:])),
                           stride=_contiguous_stride((qd.shape[0],
                                                      *o_l.shape[1:])))
    return o, flags


def like(x, ref):
    """``x`` laid out as ``ref`` (a DTensor's gradient, which may come back
    partial or otherwise placed, redistributed to its momentum's
    placements before an in-place update); plain tensors as they are."""
    if is_dtensor(ref) and is_dtensor(x) and x.placements != ref.placements:
        return x.redistribute(ref.device_mesh, ref.placements)
    return x


def split_rows(x, n: int) -> list:
    """A batch DTensor -> ``n`` microbatches of contiguous rows. Sharded
    over its rows, each rank splits the rows it holds (microbatch ``i`` is
    every rank's ``i``-th block: the same rows in all, grouped otherwise
    than the unsharded split, which sums the same gradients)."""
    from torch.distributed.tensor import DTensor
    pls = tuple(x.placements)
    if not any(_is_shard(pl, 0) for pl in pls):
        return list(x.split(x.shape[0] // n))
    x_l = x.to_local()
    if x_l.shape[0] % n:
        return list(x.redistribute(x.device_mesh, [
            _rep() if _is_shard(pl, 0) else pl for pl in pls]).split(
                x.shape[0] // n))
    shape = torch.Size((x.shape[0] // n, *x.shape[1:]))
    return [DTensor.from_local(part, x.device_mesh, pls, shape=shape,
                               stride=_contiguous_stride(shape))
            for part in x_l.split(x_l.shape[0] // n)]


# ---------------------------------------------------------------------------
# the QATT throttle
# ---------------------------------------------------------------------------


def amax_reducer(mesh):
    """An all-reduce MAX of an f32 scalar over ``mesh`` (the shards of one
    tensor) -> a function for ``quantize_throttle(amax_reduce=)``."""
    return lambda a: all_reduce(a, "max", mesh)


def throttle_(w, *, backend="torch", with_q=False):
    """``wot.throttle_tensor_`` of a sharded f32 master, in place. Blocks
    run along the last dim, so while it is a block multiple on every shard
    each shard throttles its own blocks, under the global scale (absmax
    pass, all-reduce MAX, quantize pass). Otherwise the master is gathered,
    throttled whole, and each rank keeps its shard. ``with_q`` returns the
    local q and the scale beside ``w``."""
    from repro_torch.protection.backends import get_backend
    mesh, pls = w.device_mesh, tuple(w.placements)
    last = w.ndim - 1
    w_l = w.to_local()
    aligned = w.shape[-1] % BLOCK == 0 and (
        not any(_is_shard(pl, last) for pl in pls)
        or w_l.shape[-1] % BLOCK == 0)
    be = get_backend(backend)
    if aligned:
        q, scale = be.quantize_throttle(w_l, write_back=True, with_q=with_q,
                                        amax_reduce=amax_reducer(mesh))
    else:
        full = w.redistribute(mesh, [_rep()] * mesh.ndim).to_local().clone()
        q, scale = be.quantize_throttle(full, write_back=True, with_q=with_q)
        w_l.copy_(shard_slice(full, mesh, pls))
        q = None if q is None else shard_slice(q, mesh, pls)
    return (w, q, scale) if with_q else w
