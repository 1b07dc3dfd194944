"""Spec parity of the port's sharding rules with the reference, with no
ranks: ``param_specs``, ``cache_specs`` and ``batch_specs`` of every arch
(smoke and full size), the plan's ``_drop_nondividing``, ``_flat_spec`` and
``spec_tree``, the placements of a spec, and each rank's local shard
against JAX's ``addressable_shards`` at the same mesh coordinate (the port
as each rank of a fake process group, the reference in an 8-host-device
subprocess).
"""
import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro import protection as jprotection
from repro.distributed import sharding as jsh
from repro.launch import specs as jspecs
from repro.models import lm as jlm
from repro.models.config import SHAPES as JSHAPES
from repro.protection import plan as jplan
from repro.serving import kvcache as jkvcache
from repro_torch import configs, protection
from repro_torch.distributed import sharding as sh
from repro_torch.launch import specs
from repro_torch.models import lm
from repro_torch.models.config import SHAPES
from repro_torch.protection import plan as tplan
from repro_torch.serving import kvcache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = tuple(configs.ARCH_IDS)
SIZES = {"data": 2, "model": 4}


def _cfgs(arch, full):
    return ((jconfigs.get(arch), configs.get(arch)) if full else
            (jconfigs.get_smoke(arch), configs.get_smoke(arch)))


def _jax_specs(tree_) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree_, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(s) for path, s in leaves}


def _port_specs(tree_) -> dict:
    out = {}

    def walk(prefix, node):
        if isinstance(node, sh.P):
            out["/".join(prefix)] = tuple(node)
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(prefix + (str(k),), node[k])
        else:
            for i, x in enumerate(node):
                walk(prefix + (str(i),), x)
    walk((), tree_)
    return out


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, full):
    jcfg, cfg = _cfgs(arch, full)
    jparams = jlm.param_specs(jcfg)
    params = lm.param_shapes(cfg)
    for fsdp in (True, False):
        want = _jax_specs(jsh.param_specs(jparams, fsdp=fsdp))
        got = _port_specs(sh.param_specs(params, fsdp=fsdp))
        assert got == want


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_reference(arch, full):
    """The arch's own cache (dense K/V, a hybrid's ring and RG-LRU states,
    mamba2's state cache, MLA's latent cache), and the paged pools where
    the family has them."""
    jcfg, cfg = _cfgs(arch, full)
    kvs = [None] + (["in-place", "parity-zero"]
                    if kvcache.supports_paged(cfg) else [])
    for kv in kvs:
        jcache = jax.eval_shape(lambda: jkvcache.init_cache(  # noqa: B023
            jcfg, 2, 64, kv_policy=kv))
        cache = kvcache.init_cache(cfg, 2, 64, kv_policy=kv, device="meta")
        want = _jax_specs(jsh.cache_specs(jcache))
        assert _port_specs(sh.cache_specs(cache)) == want, kv


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ["deepseek-7b", "paligemma-3b",
                                  "whisper-base"])
def test_batch_specs_equal_reference(arch, multi_pod):
    jcfg, cfg = _cfgs(arch, True)
    jb = jspecs.batch_struct(jcfg, JSHAPES["train_4k"])
    b = specs.batch_struct(cfg, SHAPES["train_4k"])
    assert _port_specs(sh.batch_specs(b, multi_pod=multi_pod)) == \
        _jax_specs(jsh.batch_specs(jb, multi_pod=multi_pod))


def _three_leaves():
    shapes = {"wq": (16, 64), "odd": (32, 18), "tiny": (3, 5)}
    j = {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in shapes.items()}
    t = {k: protection.ShapeDtype(s, torch.float32)
         for k, s in shapes.items()}
    return j, t


def test_drop_nondividing_and_flat_spec_equal_reference():
    for spec, shape in [(("data", "model"), (16, 64)),
                        (("data", "model"), (3, 64)),
                        ((("data", "model"),), (576,)),
                        ((None, "model"), (2, 6)), ((), (7,))]:
        assert tuple(tplan._drop_nondividing(sh.P(*spec), shape, SIZES)) == \
            tuple(jplan._drop_nondividing(JP(*spec), shape, SIZES))
    for n in (576, 64, 16, 8, 0):
        assert tuple(tplan._flat_spec(n, SIZES)) == \
            tuple(jplan._flat_spec(n, SIZES))
        assert tuple(tplan._flat_spec(n, None)) == \
            tuple(jplan._flat_spec(n, None))


def test_plan_spec_tree_equals_reference():
    """tests/test_distributed.py's three leaves on sizes {data 2, model
    4}: a same-shape image keeps the weight's spec, a flat-padded one of 72
    blocks gets P(("data", "model")), the 2-block one stays replicated."""
    jparams, tparams = _three_leaves()
    fn_j = lambda p, l: JP("data", "model")  # noqa: E731
    fn_t = lambda p, l: sh.P("data", "model")  # noqa: E731
    jmesh = SimpleNamespace(axis_names=("data", "model"),
                            devices=np.empty((2, 4)))
    jpol = jprotection.ProtectionPolicy(
        predicate=lambda p, l: getattr(l, "ndim", 0) >= 2)
    tpol = protection.ProtectionPolicy(
        predicate=lambda p, l: getattr(l, "ndim", 0) >= 2)
    jp = jpol.plan(jparams, mesh=jmesh, param_spec_fn=fn_j)
    tp = tpol.plan(tparams, mesh=SIZES, param_spec_fn=fn_t)
    jenc = jax.eval_shape(jp.encode_tree, jparams)
    tenc = specs.encoded_struct(tp, tparams)
    jst, tst = jp.spec_tree(jenc), tp.spec_tree(tenc)
    legacy_j = jprotection.spec_tree(jenc, fn_j, mesh=jmesh)
    legacy_t = protection.spec_tree(tenc, fn_t, mesh=SIZES)
    for k in jparams:
        for field in ("enc", "checks", "scale"):
            want = getattr(jst[k], field)
            got = getattr(tst[k], field)
            assert (None if got is None else tuple(got)) == \
                (None if want is None else tuple(want)), (k, field)
            lw, lg = getattr(legacy_j[k], field), getattr(legacy_t[k], field)
            assert (None if lg is None else tuple(lg)) == \
                (None if lw is None else tuple(lw)), (k, field)
        assert tp[k].flat_sharded == jp[k].flat_sharded, k
    assert tuple(tst["odd"].enc) == (("data", "model"),)
    assert tp.summary()["n_flat_sharded"] == \
        jp.summary()["n_flat_sharded"] == 1
    with pytest.raises(ValueError, match="no spec"):
        tpol.plan(tparams).spec_tree(tenc)


def test_placements_put_data_major():
    from torch.distributed.tensor import Replicate, Shard
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"))
    assert sh.to_placements(sh.P(("data", "model")), mesh) == (Shard(0),
                                                               Shard(0))
    assert sh.to_placements(sh.P("data", "model"), mesh) == (Shard(0),
                                                             Shard(1))
    assert sh.to_placements(sh.P(None, "model"), mesh) == (Replicate(),
                                                           Shard(1))
    assert sh.to_placements(sh.P(), mesh) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="orders the axes"):
        sh.to_placements(sh.P(("model", "data")), mesh)
    assert tuple(sh.P("data", None)) == tuple(JP("data", None))


def test_cells_bind_their_sharding_context(monkeypatch):
    """Building a cell leaves the caller's sharding context as it was; each
    call of the cell's step runs under the cell's own context (the train
    and prefill cells' dicts, none for decode) and restores the caller's
    after it, after an exception too."""
    from repro_torch.models import layers
    from repro_torch.models.config import ShapeConfig
    seen = []

    def fake(*args):
        seen.append(layers.SHARDING_CTX)
        if args == ("raise",):
            raise RuntimeError("inside the step")
        return "out"

    monkeypatch.setattr(specs.train, "make_train_step", lambda *a, **k: fake)
    monkeypatch.setattr(specs.protected, "make_serve_step",
                        lambda *a, **k: fake)
    monkeypatch.setattr(specs.protected, "make_prefill",
                        lambda *a, **k: fake)
    sizes = {"data": 2, "model": 4}
    qwen = configs.get_smoke("qwen1.5-4b")
    outer = {"dp": "outer"}
    layers.set_sharding_ctx(outer)
    try:
        train, *_ = specs.train_cell(configs.get_smoke("minitron-4b"),
                                     ShapeConfig("t", 32, 8, "train"), sizes,
                                     chunk=16)
        decode, *_ = specs.decode_cell(qwen, ShapeConfig("d", 64, 8,
                                                         "decode"), sizes)
        prefill, *_ = specs.prefill_cell(qwen, ShapeConfig("p", 64, 8,
                                                           "prefill"), sizes)
        assert layers.SHARDING_CTX is outer
        assert train() == decode() == prefill(None, None, None) == "out"
        assert layers.SHARDING_CTX is outer
        assert seen[0] == {"dp": "data", "model": "model", "sp": True,
                           "model_size": 4, "mesh": None}
        assert seen[1] is None
        assert seen[2]["sp"] is False and seen[2]["model_size"] == 4
        with pytest.raises(RuntimeError, match="inside the step"):
            train("raise")
        assert layers.SHARDING_CTX is outer
    finally:
        layers.set_sharding_ctx(None)


_JAX_SHARDS = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, jax, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
out = {}
for name, shape, spec in [("2d", (16, 64), P("data", "model")),
                          ("flat", (576,), P(("data", "model")))]:
    a = (np.arange(np.prod(shape)) * 7 % 251).astype(np.uint8).reshape(shape)
    x = jax.device_put(a, NamedSharding(mesh, spec))
    for s in x.addressable_shards:
        c = np.argwhere(mesh.devices == s.device)[0]
        out[f"{name}/{c[0]}/{c[1]}"] = np.asarray(s.data).tolist()
print(json.dumps(out))
"""


def test_local_shards_byte_equal_jax_shards():
    """A 2-D image on P(data, model) and a flat-padded one on P((data,
    model)) over 2x4: the port's rank at mesh coordinate (i, j) holds the
    bytes JAX puts on the device at (i, j)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_production_mesh
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX_SHARDS)],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])
    got = {}
    assert not dist.is_initialized()
    for rank in range(8):
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=8)
        try:
            mesh = make_production_mesh(shape=(2, 4), device="cpu")
            i, j = mesh.get_coordinate()
            for name, shape, spec in [("2d", (16, 64), sh.P("data", "model")),
                                      ("flat", (576,),
                                       sh.P(("data", "model")))]:
                a = (np.arange(np.prod(shape)) * 7 % 251).astype(
                    np.uint8).reshape(shape)
                d = sh.distribute(torch.from_numpy(a), spec, mesh)
                got[f"{name}/{i}/{j}"] = d.to_local().numpy().tolist()
        finally:
            dist.destroy_process_group()
    assert got == want


@pytest.mark.parametrize("scheme", ["in-place", "secded72"])
def test_sharded_restore_holds_each_ranks_chunk(tmp_path, scheme):
    """A protected checkpoint restored with ``shardings=`` onto 2x4, as each
    rank of a fake process group in turn: every rank's local chunk is that
    rank's chunk of the unsharded restore, for chunks of whole blocks
    (decoded alone), chunks that would cut a block or a leaf whose last
    dim is off the block grid (decoded whole on the host), and uneven
    splits (6 rows over 8 shards)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch import tree
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.training import checkpoint
    g = torch.Generator().manual_seed(5)
    state = {"layers": {"attn": {
        "wk": torch.randn(8, 64, generator=g),      # whole blocks
        "wo": torch.randn(16, 16, generator=g),     # 4 columns a shard
        "wq": torch.randn(16, 20, generator=g),     # off the block grid
        "wv": torch.randn(6, 64, generator=g)}},    # uneven rows
        "norm": torch.randn(16, generator=g)}       # unprotected
    specs = {"layers": {"attn": {"wk": sh.P("data", "model"),
                                 "wo": sh.P(None, "model"),
                                 "wq": sh.P("data", None),
                                 "wv": sh.P(("data", "model"), None)}},
             "norm": sh.P("model")}
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, state, step=1, protected=True, device="cpu",
                    scheme=scheme)
    whole, _ = checkpoint.restore(path, state, device="cpu")
    assert not dist.is_initialized()
    for rank in range(8):
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=8)
        try:
            mesh = make_production_mesh(shape=(2, 4), device="cpu")
            got, step = checkpoint.restore(path, state, device="cpu",
                                           shardings=specs, mesh=mesh)
            assert step == 1
            for p, w in tree.leaves_with_path(whole):
                d = tree.get_path(got, p)
                assert d.shape == w.shape
                assert d.placements == sh.to_placements(
                    tree.get_path(specs, p), mesh)
                torch.testing.assert_close(
                    d.to_local(), sh.distribute(w, d.placements,
                                                mesh).to_local(),
                    rtol=0, atol=0, msg=f"{tree.path_str(p)} rank {rank}")
        finally:
            dist.destroy_process_group()
