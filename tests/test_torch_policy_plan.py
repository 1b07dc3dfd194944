"""Mixed-scheme policies and plans of the port against the reference's.

For every preset of ``POLICY_PRESETS`` and every arch's smoke parameter
shapes, ``make_plan`` must decide every leaf as the reference's does:
scheme, reason, layout, image shape, pad, check and stored bytes, and
where the backend came from (the reference's "xla" / "pallas" read as
"torch" / "cuda"); so must policies with per-leaf regex rules (a scheme or
none), ``pad=False``, backend rules and an autotune table, whose lookups
and tile hints are held to the reference's from one dict. The encoded
images of ``encode_tree`` and of ``transcode_leaf`` are byte-equal,
``diff`` / ``with_leaves`` / ``migrate_step`` agree, and a mixed-scheme,
mixed-backend serve step matches the reference's XLA route (flags equal,
logits within ``F32_TOL``) and the port's homogeneous in-place step bit
for bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as P
from repro import configs as jconfigs
from repro import protection as jprotection
from repro.models import lm as jlm
from repro.protection import plan as jplan_mod
from repro.serving import protected as jprot
from repro_torch import configs as tconfigs
from repro_torch import convert, protection, tree
from repro_torch.models import lm as tlm
from repro_torch.protection import plan as plan_mod
from repro_torch.serving import kvcache as tkv
from repro_torch.serving import protected as tprot

F32_TOL = 1e-4
ROUTE = {"xla": "torch", "pallas": "cuda", "": ""}
FIELDS = ("scheme_id", "reason", "layout", "shape", "n_weights", "enc_shape",
          "pad_bytes", "check_bytes", "stored_bytes", "backend_src",
          "tiles", "int8_tiles", "tiles_src")
TABLE = {"schema": "bench_kernels/v3", "platform": "cpu", "entries": [
    {"shape": [64, 64], "best": "pallas", "tiles": [32, 64, 64],
     "int8_tiles": [32, 64, 0]},
    {"shape": [512, 512], "best": "xla", "tiles": [128, 128, 128]},
    {"shape": [16, 64], "best": "pallas"}]}
# custom policies beside the presets: (reference kwargs, port kwargs)
CUSTOM = {
    "rules-none-and-unaligned": dict(
        default_scheme="parity-zero",
        rules=[(r"(^|/)wo$", None), (r"attn/", "secded72"),
               (r"mixer|rg0", "none")], pad=False),
    "backend-rules-and-autotune": dict(
        default_scheme="in-place",
        rules=[(r"(^|/)(mlp|moe)(/|$)", "secded72")],
        backend_rules=[(r"(^|/)(wq|wk|wv)$", "pallas")]),
}


def _kwargs(kw, port):
    """A custom policy's kwargs for one package: the port reads the
    reference's route names as its own, and each gets its own table."""
    kw = dict(kw)
    if port:
        kw["backend_rules"] = [(p, ROUTE[b]) for p, b in
                               kw.get("backend_rules", ())]
    mod = protection if port else jprotection
    kw["autotune"] = mod.AutotuneTable.from_dict(TABLE)
    return kw


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    cfg = jconfigs.get_smoke(arch)
    return jax.eval_shape(lambda: jlm.init_params(cfg, jax.random.PRNGKey(0)))


def _plans(arch, name):
    """(reference plan, port plan) of one preset or custom policy."""
    tshapes = tlm.param_shapes(tconfigs.get_smoke(arch))
    if name in CUSTOM:
        jpol = jprotection.ProtectionPolicy(**_kwargs(CUSTOM[name], False))
        tpol = protection.ProtectionPolicy(**_kwargs(CUSTOM[name], True))
    else:
        jpol = jprotection.get_policy_preset(name)
        tpol = protection.get_policy_preset(name)
    return jpol.plan(_shapes(arch)), tpol.plan(tshapes)


def _assert_leaves_equal(jp, tp):
    assert list(tp.leaves) == list(jp.leaves)
    for path, jl in jp.leaves.items():
        tl = tp.leaves[path]
        for f in FIELDS:
            assert getattr(tl, f) == getattr(jl, f), (path, f)
        assert tl.backend == ROUTE[jl.backend], path


@pytest.mark.parametrize("name", sorted(protection.POLICY_PRESETS)
                         + sorted(CUSTOM))
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_make_plan_decides_every_leaf_as_the_reference(arch, name):
    jp, tp = _plans(arch, name)
    _assert_leaves_equal(jp, tp)
    js, ts = jp.summary(), tp.summary()
    for k in ("n_leaves", "n_protected", "protected_bytes",
              "unprotected_bytes", "weight_bytes", "pad_bytes",
              "check_bytes", "by_scheme", "n_flat_padded", "tiles_src"):
        assert ts[k] == js[k], k
    jc, tc = jp.coverage(), tp.coverage()
    assert tc.summary() == jc.summary()
    assert tc.unprotected_weight_bytes == jc.unprotected_weight_bytes


def test_autotune_lookups_equal_the_reference_from_one_dict():
    jt = jprotection.AutotuneTable.from_dict(TABLE)
    tt = protection.AutotuneTable.from_dict(TABLE)
    for shape in ((64, 64), (8, 512), (16, 64), (8, 128), (512, 520),
                  (4, 64, 64), (65536, 8192), (), (3, 5)):
        assert tt.lookup(shape) == (ROUTE[jt.lookup(shape)]
                                    if jt.lookup(shape) else None), shape
        assert tt.lookup_tiles_src(shape) == jt.lookup_tiles_src(shape)
        assert tt.lookup_tiles(shape) == jt.lookup_tiles(shape)
        assert tt.lookup_int8_tiles(shape) == jt.lookup_int8_tiles(shape)
    assert tt.to_dict() == jt.to_dict()
    assert protection.AutotuneTable.from_dict(tt.to_dict()).to_dict() == \
        jt.to_dict()
    for bad, match in (({"schema": "bogus/v9"}, "schema"),):
        with pytest.raises(ValueError, match=match):
            protection.AutotuneTable.from_dict(bad)
    with pytest.raises(ValueError, match="unknown best backend"):
        protection.AutotuneTable(entries=[{"shape": [8, 8], "best": "tpu"}])
    pol = protection.ProtectionPolicy(
        backend_rules=[("special", "torch")], autotune=tt)
    assert [(b.name, s) for b, s in (
        pol.resolve_backend("special/w", (16, 64)),
        pol.resolve_backend("blk/w", (16, 64)),
        pol.resolve_backend("blk/w", (4096, 8192)))] == [
        ("torch", "rule"), ("cuda", "autotune"), ("torch", "policy")]


@functools.lru_cache(maxsize=None)
def _reference_encoded(arch, name):
    params = P.reference_params(arch)
    jp, _ = _plans(arch, name)
    # eager: the jitted reference multiplies by f32(1/127) where its eager
    # encode (and the port) divides by 127, an ulp apart at times
    enc = jp.encode_tree(jax.tree.map(jnp.asarray, params))
    return params, P.export(enc)


def _assert_images_equal(tenc, exported):
    for path, leaf in tree.leaves_with_path(tenc):
        ref = tree.get_path(exported, path)
        if not protection.is_protected_tensor(leaf):
            continue
        assert leaf.scheme_id == ref["scheme_id"], path
        np.testing.assert_array_equal(leaf.enc.numpy(), ref["enc"])
        if ref["checks"] is None:
            assert leaf.checks is None, path
        else:
            np.testing.assert_array_equal(leaf.checks.numpy(), ref["checks"])
        np.testing.assert_array_equal(leaf.scale.numpy(), ref["scale"])


@pytest.mark.parametrize("name", ["attn-inplace-mlp-secded",
                                  "rules-none-and-unaligned"])
@pytest.mark.parametrize("arch", ["deepseek-7b", "deepseek-v2-236b",
                                  "whisper-base"])
def test_encode_tree_is_byte_equal(arch, name):
    params, exported = _reference_encoded(arch, name)
    _, tp = _plans(arch, name)
    tenc = tp.encode_tree(P.port_params(params))
    _assert_images_equal(tenc, exported)


def test_unthrottled_encode_is_byte_equal():
    """``throttle=False`` quantizes without the WOT clamp, as the
    reference's encode_leaf; in-place over it as the reference encodes
    it."""
    params = P.reference_params("deepseek-7b")
    for scheme in ("in-place", "secded72"):
        jpol = jprotection.ProtectionPolicy(default_scheme=scheme,
                                            throttle=False)
        tpol = protection.ProtectionPolicy(default_scheme=scheme,
                                           throttle=False)
        jenc = jpol.encode_tree(jax.tree.map(jnp.asarray, params))
        _assert_images_equal(tpol.encode_tree(P.port_params(params)),
                             P.export(jenc))


@pytest.mark.parametrize("to", ["secded72", "parity-zero", "faulty",
                                "in-place"])
@pytest.mark.parametrize("frm", ["in-place", "secded72"])
def test_transcode_leaf_is_byte_equal(frm, to):
    """From each scheme, with one flipped bit in the source image: the new
    image, the scale and the read flags equal the reference's, on both
    routes."""
    params = P.reference_params("deepseek-7b")
    w = params["layers"]["mlp"]["w_up"]
    jl = jprotection.ProtectionPolicy(default_scheme=frm).encode_leaf(
        jnp.asarray(w), frm)
    img = np.asarray(jl.enc).copy()
    img.reshape(-1)[17] ^= 0x04
    jl = jl.__class__(enc=jnp.asarray(img), checks=jl.checks, scale=jl.scale,
                      scheme_id=jl.scheme_id, orig_shape=jl.orig_shape)
    jnew, jcor, jdue = jplan_mod.transcode_leaf(jl, to)
    exp = P.export({"w": jl})["w"]
    tl = convert.protected_from_numpy({"w": exp}, device="cpu")["w"]
    for backend in ("torch", "cuda"):
        tnew, tcor, tdue = plan_mod.transcode_leaf(tl, to, backend=backend)
        _assert_images_equal({"w": tnew}, P.export({"w": jnew}))
        assert (int(tcor), int(tdue)) == (int(jcor), int(jdue)) == (1, 0)


def test_diff_with_leaves_and_migrate_step_equal_the_reference():
    arch = "deepseek-v2-236b"
    params, exported = _reference_encoded(arch, "all-in-place")
    jbase, tbase = _plans(arch, "all-in-place")
    jtgt, ttgt = _plans(arch, "attn-inplace-mlp-secded")
    jd, td = jbase.diff(jtgt), tbase.diff(ttgt)
    assert td.paths == jd.paths and td.summary() == jd.summary()
    assert [(e.path, e.from_scheme, e.to_scheme, e.stored_bytes_delta)
            for e in td.entries] == [
        (e.path, e.from_scheme, e.to_scheme, e.stored_bytes_delta)
        for e in jd.entries]
    with pytest.raises(ValueError, match="different trees"):
        tbase.diff(protection.ProtectionPolicy().plan(
            {"w": torch.zeros((8, 8))}))
    first = td.paths[:2]
    jenc = convert.protected_from_numpy(exported, device="cpu")
    tenc2, tmixed, trecs = tbase.migrate_step(jenc, ttgt, first)
    jref = jax.tree.map(jnp.asarray, params)
    jenc_ref = jbase.encode_tree(jref)
    jenc2, jmixed, jrecs = jbase.migrate_step(jenc_ref, jtgt, first)
    assert trecs == jrecs
    _assert_images_equal(tenc2, P.export(jenc2))
    assert tmixed.diff(ttgt).paths == jmixed.diff(jtgt).paths
    _assert_leaves_equal(jmixed, tmixed)
    jw = jbase.with_leaves({first[0]: jtgt.leaves[first[0]]})
    tw = tbase.with_leaves({first[0]: ttgt.leaves[first[0]]})
    _assert_leaves_equal(jw, tw)
    with pytest.raises(KeyError):
        tbase.with_leaves({"nope": ttgt.leaves[first[0]]})
    with pytest.raises(KeyError):
        tbase.migrate_step(jenc, ttgt, ["nope"])
    # the migrated tree decodes to the values of the unmigrated one
    a = tbase.decode_tree(jenc, torch.float32)
    b = tmixed.decode_tree(tenc2, torch.float32)
    for (path, x), (_, y) in zip(tree.leaves_with_path(a),
                                 tree.leaves_with_path(b)):
        assert torch.equal(x, y), path


def test_kv_policy_rides_the_plan():
    cfg = tconfigs.get_smoke("deepseek-7b")
    plan = protection.ProtectionPolicy().plan(tlm.param_shapes(cfg))
    kp = plan.with_kv_policy("parity-zero-fused")
    assert kp.kv_policy.scheme == "parity-zero" and kp.kv_policy.fused
    assert kp.summary()["kv_policy"] == {"scheme": "parity-zero",
                                         "fused": True,
                                         "attention_impl": "strip",
                                         "page_size": 16}
    assert kp.with_abft(True).kv_policy is kp.kv_policy
    enc = tlm.init_params(cfg, 0, device="cpu", leaf_fn=plan.encode_leaf)
    cache = tkv.init_cache(cfg, 2, 32, kv_policy="parity-zero",
                           device="cpu")
    _, _, flags = tprot.make_serve_step(cfg, plan=kp)(
        enc, cache, torch.zeros((2, 1), dtype=torch.long),
        torch.zeros((2,), dtype=torch.int32))
    assert "layers_kv" in flags


def test_mixed_scheme_mixed_backend_serve_step_matches_the_reference():
    """The port's counterpart of ``test_plan.py::test_serve_step_from_plan_
    mixed_scheme_mixed_backend`` (minitron-4b smoke): two schemes, the
    port mixing its "torch" and "cuda" routes per leaf, the reference
    given "xla" for every rule. Flags equal and logits within ``F32_TOL``
    of the reference's; bit-equal to the port's homogeneous in-place
    step."""
    arch = "minitron-4b"
    rules = [(r"(^|/)(wq|wk|wv)($|/)", "xla")]
    jpol = jprotection.get_policy_preset("attn-inplace-mlp-secded",
                                         backend_rules=rules)
    tpol = protection.get_policy_preset(
        "attn-inplace-mlp-secded",
        backend_rules=[(p, "cuda") for p, _ in rules])
    params = P.reference_params(arch)
    jp = jpol.plan(_shapes(arch))
    jenc = jp.encode_tree(jax.tree.map(jnp.asarray, params))
    cfg = jconfigs.get_smoke(arch)
    tok = P.seeded_tokens(cfg, (2, 1), 2)
    ref_logits, _, ref_flags = jax.jit(jprot.make_serve_step(
        cfg, plan=jp, with_flags=True, dtype=jnp.float32))(
        jenc, jlm.init_cache(cfg, 2, 32, dtype=jnp.float32),
        jnp.asarray(tok), jnp.zeros((2,), jnp.int32))
    tcfg = tconfigs.get_smoke(arch)
    tp = tpol.plan(tlm.param_shapes(tcfg))
    s = tp.summary()
    assert len(s["by_scheme"]) == 2 and s["by_backend"] == {
        "cuda": 3, "torch": len(tp.protected) - 3}
    tenc = tp.encode_tree(P.port_params(params))
    _assert_images_equal(tenc, P.export(jenc))

    def serve(plan, enc):
        cache = tkv.init_cache(tcfg, 2, 32, dtype=torch.float32,
                               device="cpu")
        return tprot.make_serve_step(tcfg, plan=plan, dtype=torch.float32)(
            enc, cache, torch.from_numpy(tok).long(),
            torch.zeros((2,), dtype=torch.int32))

    logits, _, flags = serve(tp, tenc)
    P.assert_flag_dict_equal({k: np.asarray(v) for k, v in ref_flags.items()},
                             {k: v.numpy() for k, v in flags.items()})
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=F32_TOL, atol=F32_TOL)
    home = protection.ProtectionPolicy().plan(tlm.param_shapes(tcfg))
    home_logits, _, _ = serve(home, home.encode_tree(P.port_params(params)))
    assert torch.equal(logits, home_logits)
