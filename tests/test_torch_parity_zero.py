"""The port's parity-zero and secded72 codecs, schemes and KV paths, and
the per-slot flags of both paged-attention kernels, against the reference.

Inputs are drawn once with NumPy and handed to both packages. Integers
(encoded bytes, check bytes, decoded bytes, fault flags) must be equal.
The plain versions of the two attention kernels are held to the
reference's XLA route (``kvcache._reference_paged_attention``, flags
exact, per slot and in total; its Pallas route does not run on this JAX).
Outputs: the strip version to f32 rounding of the XLA route (XLA and
PyTorch exponentiate and sum in other orders: ~2 ulps apart, as for the
in-place scheme) and bit for bit to its own faulty path over the
parity-decoded strips (the parity branch changes nothing but the bytes);
the chunked version within 2% of ``max|oracle|`` of the reference's fp64
``oracle_page_attention``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ecc as jecc
from repro.core import faults as jfaults
from repro.kernels import paged_attention as jpa
from repro.protection import schemes as jschemes
from repro.serving import kvcache as jkv
from repro_torch.core import ecc
from repro_torch.kernels import paged_attention
from repro_torch.protection import policy as policy_mod
from repro_torch.protection import schemes
from repro_torch.protection.tensor import ProtectedTensor
from repro_torch.serving import kvcache

ORACLE_RTOL = 0.02   # the reference's gate for its chunked kernel
F32_TOL = 1e-5       # f32 rounding between XLA and PyTorch (as in-place)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _flip(a, rate, seed):
    """A copy of a uint8 array with seeded bit flips (the reference's host
    injector)."""
    a = np.asarray(a, np.uint8)
    return jfaults.inject(a.reshape(-1), rate, seed).reshape(a.shape)


def test_tables_equal_the_reference():
    np.testing.assert_array_equal(ecc.COLS72, jecc.COLS72)
    np.testing.assert_array_equal(ecc.ROWMASK72, jecc.ROWMASK72)
    np.testing.assert_array_equal(ecc.COLS72_BYBYTE, jecc.COLS72_BYBYTE)


@pytest.mark.parametrize("rate", [0.0, 1e-2, 0.2])
def test_parity8_codec_byte_equal_to_the_reference(rate):
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (37, 64), dtype=np.uint8)
    checks = ecc.encode_parity8(_t(data))
    np.testing.assert_array_equal(checks.numpy(),
                                  np.asarray(jecc.encode_parity8(data)))
    bad_data, bad_checks = _flip(data, rate, 1), _flip(checks.numpy(), rate, 2)
    got, bad = ecc.decode_parity8(_t(bad_data), _t(bad_checks))
    ref, ref_bad = jecc.decode_parity8(jnp.asarray(bad_data),
                                       jnp.asarray(bad_checks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(bad.numpy(), np.asarray(ref_bad))
    assert (int(bad.sum()) > 0) == (rate > 0)


@pytest.mark.parametrize("flips", ["clean", "single", "double", "checks",
                                   "random"])
def test_secded72_codec_byte_equal_to_the_reference(flips):
    rng = np.random.default_rng(4)
    blocks = rng.integers(0, 256, (300, 8), dtype=np.uint8)
    checks = ecc.encode72(_t(blocks)).numpy()
    np.testing.assert_array_equal(checks,
                                  np.asarray(jecc.encode72(blocks)))
    data = blocks.copy()
    if flips in ("single", "double"):
        words = data.view(np.uint64)[:, 0]
        b1 = rng.integers(0, 64, 300).astype(np.uint64)
        words ^= np.uint64(1) << b1
        if flips == "double":
            words ^= np.uint64(1) << ((b1 + rng.integers(1, 64, 300).astype(
                np.uint64)) % np.uint64(64))
    elif flips == "checks":
        checks = checks ^ (1 << rng.integers(0, 8, 300)).astype(np.uint8)
    elif flips == "random":
        data, checks = _flip(data, 3e-2, 5), _flip(checks, 3e-2, 6)
    got = ecc.decode72(_t(data), _t(checks))
    ref = jecc.decode72(jnp.asarray(data), jnp.asarray(checks))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if flips == "single":
        np.testing.assert_array_equal(got[0].numpy(), blocks)


@pytest.mark.parametrize("scheme", ["parity-zero", "secded72"])
@pytest.mark.parametrize("rate", [0.0, 4e-3])
def test_scheme_decode_with_flags_equals_the_reference(scheme, rate):
    rng = np.random.default_rng(7)
    q = rng.integers(-127, 128, (24, 64), dtype=np.int8)
    mine, ref = schemes.get_scheme(scheme), jschemes.get_scheme(scheme)
    enc, checks = mine.encode(_t(q))
    jenc, jchecks = ref.encode(jnp.asarray(q))
    np.testing.assert_array_equal(enc.numpy(), np.asarray(jenc))
    np.testing.assert_array_equal(checks.numpy(), np.asarray(jchecks))
    e, c = _flip(enc.numpy(), rate, 8), _flip(checks.numpy(), rate, 9)
    got = mine.decode_with_flags(_t(e), _t(c))
    want = ref.decode_with_flags(jnp.asarray(e), jnp.asarray(c))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (int(got[1]) > 0) == (rate > 0)
    # the paper's aliases resolve as the reference resolves them
    for alias, sid in jschemes.ALIASES.items():
        assert schemes.get_scheme(alias).scheme_id == sid


def test_weight_leaves_with_checks_encode_as_the_reference():
    """A check-byte scheme's leaf: the same encoded image, check bytes and
    scale as the reference's policy, and the same plan accounting."""
    from repro import protection as jprotection
    from repro_torch.protection.plan import ShapeDtype
    rng = np.random.default_rng(1)
    w = rng.standard_normal((16, 40)).astype(np.float32)
    for sid in ("parity-zero", "secded72"):
        pt = policy_mod.ProtectionPolicy(sid).encode_leaf(_t(w), sid)
        jpt = jprotection.ProtectionPolicy(sid).encode_leaf(jnp.asarray(w),
                                                            sid)
        np.testing.assert_array_equal(pt.enc.numpy(), np.asarray(jpt.enc))
        np.testing.assert_array_equal(pt.checks.numpy(),
                                      np.asarray(jpt.checks))
        assert float(pt.scale) == float(jpt.scale)
        lp = policy_mod.ProtectionPolicy(sid).plan(
            {"w": ShapeDtype((16, 40), torch.float32)})["w"]
        assert (lp.check_bytes, lp.stored_bytes) == (80, 720)


def test_inject_tree_device_spans_enc_and_checks():
    """A leaf with check bytes is injected as ONE image ``enc ‖ checks``:
    flips land in both parts, and the returned positions index that image."""
    rng = np.random.default_rng(2)
    enc = _t(rng.integers(0, 256, (4, 64), dtype=np.uint8))
    checks = ecc.encode_parity8(enc)
    pt = ProtectedTensor(enc=enc, checks=checks, scale=torch.tensor(0.1),
                         scheme_id="parity-zero", orig_shape=(4, 64))
    gen = torch.Generator().manual_seed(0)
    tree, pos = policy_mod.inject_tree_device({"w": pt}, 0.05, gen)
    pos = pos["w"]
    n_bits = enc.numel() * 8
    assert bool((pos < n_bits).any()) and bool((pos >= n_bits).any())
    assert int(pos.max()) < n_bits + checks.numel() * 8
    image = torch.cat([enc.reshape(-1), checks.reshape(-1)]).clone()
    for p in pos.tolist():
        image[p // 8] ^= 1 << (p % 8)
    got = torch.cat([tree["w"].enc.reshape(-1), tree["w"].checks.reshape(-1)])
    assert torch.equal(got, image)
    assert tree["w"].checks.shape == checks.shape


def _strips(rng, b, s, kv, hd, rate):
    """Float K/V encoded through BOTH packages' parity-zero ``_encode_kv``
    (asserted equal), then data and check bytes faulted by one mask."""
    jpol, tpol = jkv.get_kv_policy("parity-zero"), kvcache.get_kv_policy(
        "parity-zero")
    out = []
    for i in range(2):
        f = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
        je, jc, jsc = jkv._encode_kv(jnp.asarray(f), jpol)
        te, tc, tsc = kvcache._encode_kv(_t(f), tpol)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
        out += [_flip(je, rate, 10 + i), _flip(jc, rate, 20 + i),
                np.asarray(jsc)]
    return out


@pytest.mark.parametrize("rate", [0.0, 5e-3])
def test_decode_kv_parity_zero_equals_the_reference(rate):
    rng = np.random.default_rng(6)
    ke, kc, _, _, _, _ = _strips(rng, 2, 16, 2, 16, rate)
    got = kvcache._decode_kv(_t(ke), _t(kc), "parity-zero")
    want = jkv._decode_kv(jnp.asarray(ke), jnp.asarray(kc), "parity-zero")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].dtype == torch.int8 and tuple(got[1].shape) == (2, 16)
    assert (int(got[1].sum()) > 0) == (rate > 0) and int(got[2].sum()) == 0


@pytest.mark.parametrize("per_slot", [False, True], ids=["totals", "per-slot"])
@pytest.mark.parametrize("rate", [0.0, 6e-3], ids=["clean", "faulted"])
@pytest.mark.parametrize("kernel", ["strip", "chunked"])
def test_page_attention_plain_parity_zero_matches_the_reference(kernel, rate,
                                                                per_slot):
    b, h, kv, s, hd = 3, 4, 2, 48, 16
    rng = np.random.default_rng(int(rate * 1e4) + 5)
    ke, kc, ksc, ve, vc, vsc = _strips(rng, b, s, kv, hd, rate)
    q = rng.standard_normal((b, h, 1, hd)).astype(np.float32)
    pos = np.array([s - 1, 20, 0], np.int32)
    jpol = dataclasses.replace(jkv.get_kv_policy("parity-zero"),
                               per_slot_flags=per_slot)
    jargs = [jnp.asarray(a) for a in (q, ke, kc, ksc, ve, vc, vsc, pos)]
    jo, jcor, jdue = jkv._reference_paged_attention(*jargs, jpol)
    want = np.stack([np.asarray(jcor), np.asarray(jdue)]).astype(np.int32)
    targs = [_t(a) for a in (q, ke, kc, ksc, ve, vc, vsc, pos)]
    if kernel == "strip":
        o, flags = paged_attention.fused_page_attention(
            *targs, scheme="parity-zero", per_slot=per_slot)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=F32_TOL,
                                   atol=F32_TOL)
        kd = ecc.decode_parity8(targs[1], targs[2])[0]
        vd = ecc.decode_parity8(targs[4], targs[5])[0]
        fo, _ = paged_attention.fused_page_attention(
            targs[0], kd, None, targs[3], vd, None, targs[6], targs[7],
            scheme="faulty")
        assert torch.equal(o, fo)
    else:
        o, flags = paged_attention.chunked_page_attention(
            *targs, scheme="parity-zero", chunk_tokens=16, per_slot=per_slot)
        oracle = jpa.oracle_page_attention(*jargs, scheme="parity-zero")
        err = np.abs(o.double().numpy() - oracle).max()
        assert err <= ORACLE_RTOL * np.abs(oracle).max()
        # the port's own oracle over the same strips agrees
        np.testing.assert_allclose(paged_attention.oracle_page_attention(
            *targs, scheme="parity-zero"), oracle, rtol=1e-12, atol=1e-12)
    assert flags.dtype == torch.int32
    assert tuple(flags.shape) == ((2, b) if per_slot else (2,))
    np.testing.assert_array_equal(flags.numpy(), want)
    if rate:
        # the count unit is BYTES: the bad bytes of valid tokens
        valid = (np.arange(s)[None, :] <= pos[:, None])[..., None, None]
        n_bad = sum(int((np.asarray(jkv._decode_kv(
            jnp.asarray(e), jnp.asarray(c), "parity-zero")[1])[..., None,
                                                                None]
            * valid).sum()) for e, c in ((ke, kc), (ve, vc)))
        assert int(flags.sum()) == n_bad > 0


@pytest.mark.parametrize("kernel", ["strip", "chunked"])
@pytest.mark.parametrize("scheme", ["faulty", "in-place"])
def test_per_slot_rows_sum_to_the_totals(kernel, scheme):
    """Per-slot rows of the other schemes equal the reference's XLA rows
    and sum to the kernel's own batch totals."""
    b, h, kv, s, hd = 3, 2, 2, 32, 16
    rng = np.random.default_rng(9)
    pol = kvcache.get_kv_policy(scheme)
    strips = []
    for i in range(2):
        e, _, sc = kvcache._encode_kv(_t(rng.standard_normal(
            (b, s, kv, hd)).astype(np.float32)), pol)
        strips += [_t(_flip(e.numpy(), 4e-3, 30 + i)), None, sc]
    q = torch.from_numpy(rng.standard_normal((b, h, 1, hd)).astype(
        np.float32))
    pos = torch.tensor([31, 9, 2])
    fn = (paged_attention.fused_page_attention if kernel == "strip"
          else paged_attention.chunked_page_attention)
    _, rows = fn(q, *strips, pos, scheme=scheme, per_slot=True)
    _, tot = fn(q, *strips, pos, scheme=scheme)
    assert torch.equal(rows.sum(1, dtype=torch.int32), tot)
    jpol = dataclasses.replace(jkv.get_kv_policy(scheme), per_slot_flags=True)
    jargs = [None if a is None else jnp.asarray(a.numpy())
             for a in (q, *strips, pos)]
    _, jcor, jdue = jkv._reference_paged_attention(*jargs, jpol)
    np.testing.assert_array_equal(rows.numpy(),
                                  np.stack([jcor, jdue]).astype(np.int32))


def test_kv_pages_carry_checks_through_the_paging_api():
    """init_paged_cache(n_pages=) shapes, set_slot_pages, copy_page and
    zero_pages on the check planes, as the reference's."""
    from repro_torch import configs
    from repro import configs as jconfigs
    cfg, jcfg = configs.get_smoke("deepseek-7b"), jconfigs.get_smoke(
        "deepseek-7b")
    cache = kvcache.init_paged_cache(cfg, 2, 32, "parity-zero", n_pages=6,
                                     device="cpu")
    ref = jkv.init_paged_cache(jcfg, 2, 32, "parity-zero", n_pages=6)
    assert sorted(cache) == sorted(ref)
    for k in cache:
        np.testing.assert_array_equal(cache[k].numpy(), np.asarray(ref[k]))
    cache["k_checks"][:, 3] = 7
    cache["k_scale"][:, 3] = 0.5
    kvcache.copy_page(cache, 3, 4)
    assert bool((cache["k_checks"][:, 4] == 7).all())
    assert bool((cache["k_scale"][:, 4] == 0.5).all())
    kvcache.set_slot_pages(cache, 1, (4, 3))
    assert cache["kv_table"][:, 1].tolist() == [[4, 3]] * cfg.n_layers
    kvcache.set_slot_pages(cache, 1, ())
    assert cache["kv_table"][:, 1].tolist() == [[1, 1]] * cfg.n_layers
    kvcache.zero_pages(cache, (3, 4))
    assert all(int(v.abs().sum()) == 0 for k, v in cache.items()
               if k != "kv_table")
    with pytest.raises(ValueError, match="parking"):
        kvcache.init_paged_cache(cfg, 2, 32, "parity-zero", n_pages=2,
                                 device="cpu")


def test_kv_policy_presets_and_checks_round_trip():
    for name in ("parity-zero", "parity-zero-fused", "parity-zero-chunked",
                 "zero-fused", "parity8-chunked"):
        mine, ref = kvcache.get_kv_policy(name), jkv.get_kv_policy(name)
        assert (mine.scheme, mine.fused, mine.attention_impl,
                mine.has_checks, mine.per_slot_flags) == (
            ref.scheme, ref.fused, ref.attention_impl, ref.has_checks,
            ref.per_slot_flags)
    assert kvcache.KV_SCHEMES == jkv.KV_SCHEMES == paged_attention.KV_SCHEMES
    with pytest.raises(ValueError, match="KV scheme"):
        kvcache.KVProtectionPolicy(scheme="secded72")
    from repro_torch import configs
    cache = kvcache.init_paged_cache(configs.get_smoke("deepseek-7b"), 2, 32,
                                     "parity-zero", device="cpu")
    tree = kvcache.as_protected_tree(cache, "parity-zero")
    assert tree["k"].checks is cache["k_checks"]
    flipped = dataclasses.replace(tree["v"], checks=tree["v"].checks ^ 1)
    new = kvcache.from_protected_tree(cache, {**tree, "v": flipped})
    assert bool((new["v_checks"] == 1).all())
    assert new["k_checks"] is cache["k_checks"]


def _export_with_checks(enc, rate, seed):
    """Reference encoded tree -> exported leaves with their check bytes,
    ``enc ‖ checks`` faulted as one image by a seeded NumPy mask."""
    from repro.protection.tensor import is_protected_tensor
    if isinstance(enc, dict):
        return {k: _export_with_checks(v, rate, seed + i)
                for i, (k, v) in enumerate(sorted(enc.items()))}
    if not is_protected_tensor(enc):
        return np.asarray(enc)
    e, c = np.asarray(enc.enc), np.asarray(enc.checks)
    img = _flip(np.concatenate([e.reshape(-1), c.reshape(-1)]), rate, seed)
    return {"enc": img[:e.size].reshape(e.shape),
            "checks": img[e.size:].reshape(c.shape),
            "scale": np.asarray(enc.scale), "scheme_id": enc.scheme_id,
            "orig_shape": tuple(enc.orig_shape)}


def _reimport(enc, exported):
    from repro.protection.tensor import is_protected_tensor
    if isinstance(enc, dict):
        return {k: _reimport(v, exported[k]) for k, v in enc.items()}
    if is_protected_tensor(enc):
        return dataclasses.replace(enc, enc=jnp.asarray(exported["enc"]),
                                   checks=jnp.asarray(exported["checks"]))
    return enc


@pytest.mark.parametrize("scheme", ["parity-zero", "secded72"])
def test_check_byte_weights_serve_as_the_reference(scheme):
    """Weights under a check-byte scheme decode whole at use (no fused
    kernel): the serve step's flags equal the reference's and its logits
    agree to f32 rounding, with faults in both data and check bytes."""
    import jax
    from repro import configs as jconfigs
    from repro import protection as jprotection
    from repro.models import lm as jlm
    from repro.serving import protected as jprot
    from repro_torch import configs, convert
    from repro_torch.serving import protected
    cfg = jconfigs.get_smoke("deepseek-7b")
    params = jax.jit(lambda k: jlm.init_params(cfg, k))(
        jax.random.PRNGKey(0))
    plan = jprotection.ProtectionPolicy(default_scheme=scheme,
                                        backend="xla").plan(params)
    exported = _export_with_checks(jax.jit(plan.encode_tree)(params), 1e-3,
                                   40)
    jstep = jax.jit(jprot.make_serve_step(cfg, plan=plan, with_flags=True,
                                          dtype=jnp.float32))
    tcfg = configs.get_smoke("deepseek-7b")
    tstep = protected.make_serve_step(tcfg, dtype=torch.float32)
    jenc = _reimport(jax.jit(plan.encode_tree)(params), exported)
    tenc = convert.protected_from_numpy(exported, device="cpu")
    jcache = jkv.init_cache(cfg, 2, 16, dtype=jnp.float32)
    from repro_torch.models import lm
    tcache = lm.init_cache(tcfg, 2, 16, torch.float32, device="cpu")
    tok = np.array([[3], [7]], np.int32)
    for t in range(2):
        jl, jcache, jfl = jstep(jenc, jcache, jnp.asarray(tok),
                                jnp.full((2,), t, jnp.int32))
        tl, tcache, tfl = tstep(tenc, tcache, torch.from_numpy(tok).long(),
                                torch.full((2,), t, dtype=torch.int32))
        for k in jfl:
            np.testing.assert_array_equal(tfl[k].numpy(), np.asarray(jfl[k]),
                                          err_msg=k)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    assert int(tfl["layers"][:, 0].sum()) > 0


def test_parity_zero_prefill_per_slot_matches_the_reference():
    """The prefill into a parity-zero pool under a per-slot policy: data
    pages AND check planes byte-equal to the reference's, (L, 2, B) KV
    rows, logits to f32 rounding."""
    import jax
    import torch_parity as P
    from repro.serving import protected as jprot
    from repro_torch import configs, convert
    from repro_torch.serving import protected
    cfg, plan, _, enc = P._reference_model("deepseek-7b")
    jkvp = dataclasses.replace(jkv.get_kv_policy("parity-zero"),
                               per_slot_flags=True)
    tkvp = dataclasses.replace(kvcache.get_kv_policy("parity-zero"),
                               per_slot_flags=True)
    prompt = np.random.default_rng(11).integers(0, cfg.vocab, (3, 21),
                                                dtype=np.int32)
    jcache = jkv.init_cache(cfg, 3, 32, kv_policy=jkvp)
    jl, jcache, jfl = jax.jit(jprot.make_prefill(
        cfg, plan=plan, with_flags=True, kv_policy=jkvp,
        dtype=jnp.float32))(enc, jcache, jnp.asarray(prompt))
    tcfg = configs.get_smoke("deepseek-7b")
    tcache = kvcache.init_cache(tcfg, 3, 32, kv_policy=tkvp, device="cpu")
    tl, tcache, tfl = protected.make_prefill(
        tcfg, kv_policy=tkvp, dtype=torch.float32, with_flags=True)(
        convert.protected_from_numpy(P.export(enc), device="cpu"), tcache,
        torch.from_numpy(prompt).long())
    assert tuple(tfl["layers_kv"].shape) == (tcfg.n_layers, 2, 3)
    for k in jfl:
        np.testing.assert_array_equal(tfl[k].numpy(), np.asarray(jfl[k]),
                                      err_msg=k)
    for k in ("k_pages", "v_pages", "k_checks", "v_checks", "kv_table"):
        np.testing.assert_array_equal(tcache[k].numpy(), np.asarray(jcache[k]),
                                      err_msg=k)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)


def test_correctable_only_injections_never_stack_in_a_block():
    """Repeated one-per-block injections sharing ``hit_blocks`` never put a
    second flip into a 64-bit block (a burst's correctable-only run)."""
    img = torch.zeros(4096, dtype=torch.uint8)
    pt = ProtectedTensor(enc=img, checks=None, scale=torch.tensor(1.0),
                         scheme_id="in-place", orig_shape=(4096,))
    hits, seen = {}, []
    tree = {"w": pt}
    for step in range(6):
        gen = torch.Generator().manual_seed(step)
        tree, pos = policy_mod.inject_tree_device(
            tree, 2e-3, gen, one_per_block=True, hit_blocks=hits)
        seen.append(pos["w"])
    allpos = torch.cat(seen)
    blocks = allpos // 64
    assert blocks.numel() == torch.unique(blocks).numel() > 100
    words = tree["w"].enc.view(torch.int64)
    assert int((words != 0).sum()) == blocks.numel()
    assert int(hits["w"].sum()) == blocks.numel()
