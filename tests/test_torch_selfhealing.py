"""Self-healing of the port against the reference's: the scrubber, MILR
repair, plan diffs and rolling migration, the healing front-end and its
telemetry. The cases of ``tests/test_selfhealing.py``, one for one, each
run in both packages on the same inputs: the reference's encoded trees
carried across, one seeded NumPy fault mask XORed into both.

Scrub statistics, scrubbed and repaired images, repair reports, migration
records and the front-ends' deterministic telemetry must be EQUAL (a
repair report's float64 ``residual`` within ``RESIDUAL_ATOL``: the kit's
responses go through BLAS in the port, einsum in the reference); the
faulted burst that heals must end at zero residual DUE with logits
bit-equal to the never-faulted tree's. The reference's own random fault
streams (``jax.random``) cannot be replayed in torch, so where its test
injects with them the masks here are drawn with NumPy and applied to
both packages.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as P
from repro import protection as jprotection
from repro.protection import repair as jrepair
from repro.protection.policy import path_str as j_path_str
from repro.protection.tensor import is_protected_tensor as j_is_pt
from repro.serving import frontend as jfe
from repro.serving import kvcache as jkv
from repro.serving import protected as jprot
from repro.serving import scrubber as jscrub
from repro.serving import telemetry as jtel
from repro_torch import configs as tconfigs
from repro_torch import convert, protection, tree
from repro_torch.launch import serve
from repro_torch.protection import repair
from repro_torch.serving import frontend, kvcache, protected, scrubber
from repro_torch.serving import telemetry

ARCH = "deepseek-7b"


def _ndim2(path, leaf):
    return getattr(leaf, "ndim", 0) >= 2


def _small_tree(seed=0, shapes=((16, 24), (24, 16), (16, 16))):
    """The reference suite's tiny all-in-place tree: (reference params,
    reference encoded tree, the port's copy of it)."""
    rng = np.random.default_rng(seed)
    params = {f"w{i}": jnp.asarray(
        rng.integers(-50, 50, size=s).astype(np.float32) / 64.0)
        for i, s in enumerate(shapes)}
    enc = jprotection.ProtectionPolicy(predicate=_ndim2).encode_tree(params)
    return params, enc, _port(enc)


def _port(jtree):
    return convert.protected_from_numpy(P.export(jtree), device="cpu")


def _jflip(pt, idx, mask=0x01):
    return dataclasses.replace(
        pt, enc=pt.enc.at[idx].set(pt.enc[idx] ^ np.uint8(mask)))


def _tflip(pt, idx, mask=0x01):
    enc = pt.enc.clone()
    enc[idx] ^= mask
    return dataclasses.replace(pt, enc=enc)


def _flip_both(jt, tt, key, idx, mask=0x01):
    jt[key] = _jflip(jt[key], idx, mask)
    tt[key] = _tflip(tt[key], idx, mask)


def _assert_trees_equal(ttree, jtree):
    exported = P.export(jtree)
    for path, leaf in tree.leaves_with_path(ttree):
        ref = tree.get_path(exported, path)
        if protection.is_protected_tensor(leaf):
            assert leaf.scheme_id == ref["scheme_id"], path
            np.testing.assert_array_equal(leaf.enc.numpy(), ref["enc"],
                                          err_msg=str(path))
            if ref["checks"] is not None:
                np.testing.assert_array_equal(leaf.checks.numpy(),
                                              ref["checks"])


def _scrub_both(jt, tt, **kw):
    jh, js = jscrub.scrub_tree(jt, **kw)
    th, ts = scrubber.scrub_tree(tt)
    assert ts == js
    _assert_trees_equal(th, jh)
    return jh, js, th


# ---------------------------------------------------------------------------
# scrubber: write-back semantics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_scrub_corrects_single_flip_bitexact(backend):
    _, jenc, tenc = _small_tree()
    clean = tenc["w0"].enc.clone()
    _flip_both(jenc, tenc, "w0", (3, 5))
    jh, js = jscrub.scrub_tree(jenc)
    th, ts = scrubber.scrub_tree(tenc, backend=backend)
    assert ts == js and ts["corrected"] >= 1 and ts["due"] == 0
    assert ts["scanned"] == ts["wrote"] == 3
    assert torch.equal(th["w0"].enc, clean)
    _assert_trees_equal(th, jh)


def test_scrub_clean_tree_is_bit_level_noop():
    _, jenc, tenc = _small_tree()
    before = {k: v.enc.clone() for k, v in tenc.items()}
    _, js, th = _scrub_both(jenc, tenc)
    assert js["corrected"] == 0 and js["due"] == 0
    for k in tenc:
        assert torch.equal(th[k].enc, before[k])


def test_scrub_never_writes_back_a_due_leaf():
    _, jenc, tenc = _small_tree()
    _flip_both(jenc, tenc, "w1", (0, 0))
    _flip_both(jenc, tenc, "w1", (0, 1))
    dirty = tenc["w1"].enc.clone()
    _, js, th = _scrub_both(jenc, tenc)
    assert js["due"] > 0 and js["due_paths"] == ["w1"] and js["wrote"] == 2
    assert torch.equal(th["w1"].enc, dirty)
    assert th["w1"] is tenc["w1"]


def test_scrub_budget_cursor_covers_tree_round_robin():
    _, jenc, tenc = _small_tree()
    cleans = {k: v.enc.clone() for k, v in tenc.items()}
    for i, k in enumerate(sorted(tenc)):
        _flip_both(jenc, tenc, k, (1, i))
    js_, ts_ = jscrub.Scrubber(leaves_per_step=1), scrubber.Scrubber(
        leaves_per_step=1)
    total = 0
    for _ in range(3):
        jenc, jst = js_.scrub_weights(jenc)
        tenc, tst = ts_.scrub_weights(tenc)
        assert tst == jst and tst["scanned"] == 1
        total += tst["corrected"]
    assert total == 3
    for k in tenc:
        assert torch.equal(tenc[k].enc, cleans[k])


# ---------------------------------------------------------------------------
# scrubber: KV pages
# ---------------------------------------------------------------------------


@pytest.fixture()
def kv_rig():
    jcfg = P._reference_model(ARCH)[0]
    cfg = tconfigs.get_smoke(ARCH)
    jcache = jkv.init_paged_cache(jcfg, batch=2, max_len=32,
                                  policy=jkv.get_kv_policy("in-place"),
                                  n_pages=6)
    cache = kvcache.init_paged_cache(cfg, 2, 32, "in-place", n_pages=6,
                                     device="cpu")
    return jcache, cache


def _kv_xor(jc, tc, key, idx, val):
    jc[key] = jc[key].at[idx].set(jc[key][idx] ^ np.uint8(val))
    tc[key][idx] ^= val


def _assert_cache_equal(tc, jc):
    for k in ("k_pages", "v_pages"):
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]),
                                      err_msg=k)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_kv_scrub_corrects_live_page_and_skips_busy(kv_rig, backend):
    jcache, cache = kv_rig
    pid = 3
    clean = cache["k_pages"][:, pid].clone()
    _kv_xor(jcache, cache, "k_pages", (0, pid, 0, 0, 0), 2)
    kvp = kvcache.get_kv_policy("in-place")
    jkvp = jkv.get_kv_policy("in-place")
    js_, ts_ = jscrub.Scrubber(pages_per_step=4), scrubber.Scrubber(
        pages_per_step=4, backend=backend)
    jskip, jst = js_.scrub_kv(jcache, jkvp, occupied=(pid,), busy=(pid,))
    tskip, tst = ts_.scrub_kv(cache, kvp, occupied=(pid,), busy=(pid,))
    assert tst == jst and tst["scanned"] == 0
    assert not torch.equal(tskip["k_pages"][:, pid], clean)
    jh, jst = js_.scrub_kv(jcache, jkvp, occupied=(pid,))
    th, tst = ts_.scrub_kv(cache, kvp, occupied=(pid,))
    assert tst == jst and tst["scanned"] == 1 and tst["corrected"] >= 1
    assert tst["due"] == 0
    assert torch.equal(th["k_pages"][:, pid], clean)
    _assert_cache_equal(th, jh)


def test_kv_scrub_skips_due_slab(kv_rig):
    jcache, cache = kv_rig
    pid = 1
    for d in (0, 1):
        _kv_xor(jcache, cache, "k_pages", (0, pid, 0, 0, d), 1)
    dirty = cache["k_pages"][0, pid].clone()
    jh, jst = jscrub.Scrubber().scrub_kv(
        jcache, jkv.get_kv_policy("in-place"), occupied=(pid,), n=-1)
    th, tst = scrubber.Scrubber().scrub_kv(cache, "in-place",
                                           occupied=(pid,), n=-1)
    assert tst == jst and tst["due"] > 0 and tst["due_slabs"] >= 1
    assert torch.equal(th["k_pages"][0, pid], dirty)
    _assert_cache_equal(th, jh)


def test_scrub_free_re_zeroes_even_due_patterns(kv_rig):
    jcache, cache = kv_rig
    ja, ta = jkv.PageAllocator(6, reserved=2), kvcache.PageAllocator(
        6, reserved=2)
    live = ta.alloc(1)
    assert ja.alloc(1) == live
    free_pid = ta.free_pages()[0]
    jcache["k_pages"] = jcache["k_pages"].at[0, free_pid].set(255)
    cache["k_pages"][0, free_pid] = 255
    _kv_xor(jcache, cache, "v_pages", (0, live[0], 0, 0, 0), 7)
    jh = jscrub.Scrubber().scrub_free(jcache, ja)
    th = scrubber.Scrubber().scrub_free(cache, ta)
    assert int(th["k_pages"][0, free_pid].sum()) == 0
    assert int(th["v_pages"][0, live[0], 0, 0, 0]) == 7
    _assert_cache_equal(th, jh)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_cache_layer_flags_equal_the_reference(kv_rig, backend):
    """``kvcache.cache_layer_flags`` over a paged cache with single and
    double flips in two layers: the reference's (n_layers, 2) rows."""
    jcache, cache = kv_rig
    _kv_xor(jcache, cache, "k_pages", (0, 3, 1, 0, 5), 4)
    for d in (0, 1):
        _kv_xor(jcache, cache, "v_pages", (1, 2, 0, 0, d), 1)
    ref = jkv.cache_layer_flags(jcache, jkv.get_kv_policy("in-place"))
    got = kvcache.cache_layer_flags(cache, "in-place", backend=backend)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got[:, 0].sum() >= 1 and got[:, 1].sum() >= 1


# ---------------------------------------------------------------------------
# error accumulation: singles become DUEs only without scrub
# ---------------------------------------------------------------------------


def test_correctable_faults_accumulate_to_due_without_scrub():
    flips = [((0, 0), 0x01), ((0, 1), 0x01)]
    _, jenc, tenc = _small_tree()
    for idx, mask in flips:
        _flip_both(jenc, tenc, "w0", idx, mask)
    _, js, _ = _scrub_both(jenc, tenc)
    assert js["due"] > 0 and js["due_paths"] == ["w0"]

    _, jenc, tenc = _small_tree()
    total = 0
    for idx, mask in flips:
        _flip_both(jenc, tenc, "w0", idx, mask)
        jenc, js, tenc = _scrub_both(jenc, tenc)
        assert js["due"] == 0
        total += js["corrected"]
    assert total == len(flips)
    _, js, _ = _scrub_both(jenc, tenc)
    assert js["due"] == 0 and js["corrected"] == 0


def _mask_tree(ttree, rate, seed, *, one_per_block=False):
    """{leaf path: uint8 XOR mask of its enc} drawn with NumPy; with
    ``one_per_block`` only the first drawn bit of each 64-bit block
    flips."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, leaf in tree.leaves_with_path(ttree):
        if protection.is_protected_tensor(leaf):
            bits = rng.random((*leaf.enc.shape, 8)) < rate
            if one_per_block:
                blk = bits.reshape(-1, 64)
                blk &= np.cumsum(blk, axis=1) == 1
            out[tree.path_str(path)] = np.packbits(
                bits, axis=-1, bitorder="little")[..., 0]
    return out


def _apply_masks(jtree, ttree, masks):
    """XOR one mask set into both packages' encoded trees -> new trees."""
    def port(path, leaf):
        m = masks.get(tree.path_str(path))
        if m is None or not protection.is_protected_tensor(leaf):
            return leaf
        return dataclasses.replace(leaf, enc=leaf.enc ^ torch.from_numpy(m))

    def ref(path, leaf):
        m = masks.get(j_path_str(path))
        if m is None or not j_is_pt(leaf):
            return leaf
        return dataclasses.replace(leaf, enc=leaf.enc ^ jnp.asarray(m))

    return (jax.tree_util.tree_map_with_path(ref, jtree, is_leaf=j_is_pt),
            tree.map_with_path(port, ttree))


def test_seeded_fault_stream_accumulates_without_scrub():
    """40 rounds of one seeded per-round fault stream (NumPy masks at
    2e-4, a round's flips in distinct blocks: each round is correctable
    on its own): left alone they collide into DUEs across rounds; the
    scrubbed twin ends with none. Both packages equal after every
    round."""
    def run(scrub):
        _, jenc, tenc = _small_tree(seed=3)
        js_, ts_ = jscrub.Scrubber(leaves_per_step=0), scrubber.Scrubber(
            leaves_per_step=0)
        for r in range(40):
            jenc, tenc = _apply_masks(jenc, tenc, _mask_tree(
                tenc, 2e-4, 17 + r, one_per_block=True))
            if scrub:
                jenc, jst = js_.scrub_weights(jenc, n=-1)
                tenc, tst = ts_.scrub_weights(tenc, n=-1)
                assert tst == jst
        _, final, _ = _scrub_both(jenc, tenc)
        return final["due"]

    assert run(scrub=False) > 0
    assert run(scrub=True) == 0


# ---------------------------------------------------------------------------
# MILR repair
# ---------------------------------------------------------------------------


def _corrupt_rows(jpt, tpt, rows, n_hits=2):
    for r in rows:
        for b in range(n_hits):
            jpt, tpt = _jflip(jpt, (r, b)), _tflip(tpt, (r, b))
    return jpt, tpt


# the kit's responses x @ q: BLAS in the port, einsum in the reference;
# a repair report's residual follows them (both far under the repair's
# tolerance, 1e-3)
KIT_Y_RTOL = 1e-12
RESIDUAL_ATOL = 1e-9


def _reports_equal(treps, jreps):
    """Repair reports equal but for ``residual``, within RESIDUAL_ATOL."""
    assert len(treps) == len(jreps)
    for t, j in zip(treps, jreps):
        assert {k: v for k, v in t.items() if k != "residual"} == \
            {k: v for k, v in j.items() if k != "residual"}
        assert (t["residual"] is None) == (j["residual"] is None)
        if t["residual"] is not None:
            assert abs(t["residual"] - j["residual"]) <= RESIDUAL_ATOL


def _views_equal(tev, jev):
    """The deterministic telemetry views equal, repair events' residuals
    within RESIDUAL_ATOL."""
    tv, jv = telemetry.deterministic_view(tev), jtel.deterministic_view(jev)
    _reports_equal([e for e in tv if e["event"] == "repair"],
                   [e for e in jv if e["event"] == "repair"])
    strip = lambda v: [{k: x for k, x in e.items() if k != "residual"}  # noqa: E731
                       for e in v]
    assert strip(tv) == strip(jv)


def _assert_kits_equal(tkit, jkit):
    """Probes and twins equal; responses within ``KIT_Y_RTOL``."""
    assert sorted(tkit.entries) == sorted(jkit.entries)
    assert (tkit.n_samples, tkit.tol) == (jkit.n_samples, jkit.tol)
    for p, je in jkit.entries.items():
        te = tkit.entries[p]
        for f in ("x", "y"):
            a, b = getattr(te, f), getattr(je, f)
            assert (a is None) == (b is None)
        if te.x is not None:
            np.testing.assert_array_equal(te.x, je.x)
            np.testing.assert_allclose(te.y, je.y, rtol=KIT_Y_RTOL,
                                       atol=KIT_Y_RTOL * np.abs(je.y).max())
        _assert_trees_equal({"t": te.twin}, {"t": je.twin})


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_milr_repair_reconstructs_rows_bitexact(backend):
    """The kit (probes and twins equal, responses within
    ``KIT_Y_RTOL``) and the solved rows equal the reference's bit for bit;
    the repaired image is the clean one."""
    _, jenc, tenc = _small_tree(seed=1)
    jkit = jrepair.build_repair_kit(jenc, seed=9, n_samples=8)
    tkit = repair.build_repair_kit(tenc, seed=9, n_samples=8,
                                   backend=backend)
    _assert_kits_equal(tkit, jkit)
    clean = tenc["w0"].enc.clone()
    jd, td = _corrupt_rows(jenc["w0"], tenc["w0"], rows=(2, 11))
    jq, jdbl = jrepair.due_block_mask(jd)
    tq, tdbl = repair.due_block_mask(td, backend=backend)
    np.testing.assert_array_equal(tdbl, jdbl)
    np.testing.assert_array_equal(tq, jq)
    jfix, jrep = jrepair.repair_leaf(jd, jkit.entries["w0"], tol=jkit.tol)
    tfix, trep = repair.repair_leaf(td, tkit.entries["w0"], tol=tkit.tol,
                                    backend=backend)
    _reports_equal([trep], [jrep])
    assert trep["status"] == "repaired" and trep["rows"] == 2
    assert trep["due_blocks"] == 2 and trep["residual"] < 1e-9
    assert torch.equal(tfix.enc, clean) and tfix.scheme_id == "in-place"
    _assert_trees_equal({"w": tfix}, {"w": jfix})


def test_milr_repairs_a_stacked_secded72_leaf_bitexact():
    """A stacked (L, K, N) leaf under secded72: per-layer solves, the
    reference's rows."""
    rng = np.random.default_rng(4)
    w = jnp.asarray(rng.integers(-50, 50, (3, 24, 16)).astype(np.float32)
                    / 64.0)
    jenc = jprotection.ProtectionPolicy(
        default_scheme="secded72", predicate=_ndim2).encode_tree({"w": w})
    tenc = _port(jenc)
    jkit = jrepair.build_repair_kit(jenc, seed=2, n_samples=6)
    tkit = repair.build_repair_kit(tenc, seed=2, n_samples=6)
    _assert_kits_equal(tkit, jkit)
    jd, td = jenc["w"], tenc["w"]
    for idx in ((0, 3, 0), (0, 3, 1), (2, 7, 8), (2, 7, 9)):
        jd, td = _jflip(jd, idx), _tflip(td, idx)
    jfix, jrep = jrepair.repair_leaf(jd, jkit.entries["w"])
    tfix, trep = repair.repair_leaf(td, tkit.entries["w"])
    _reports_equal([trep], [jrep])
    assert trep["status"] == "repaired"
    assert torch.equal(tfix.enc, tenc["w"].enc)
    _assert_trees_equal({"w": tfix}, {"w": jfix})


def test_milr_quarantines_when_underdetermined():
    _, jenc, tenc = _small_tree(seed=2)
    jkit = jrepair.build_repair_kit(jenc, seed=9, n_samples=4)
    tkit = repair.build_repair_kit(tenc, seed=9, n_samples=4)
    jd, td = _corrupt_rows(jenc["w2"], tenc["w2"], rows=tuple(range(6)))
    jfix, jrep = jrepair.repair_leaf(jd, jkit.entries["w2"], tol=jkit.tol,
                                     n_samples=4)
    tfix, trep = repair.repair_leaf(td, tkit.entries["w2"], tol=tkit.tol,
                                    n_samples=4)
    _reports_equal([trep], [jrep])
    assert trep["status"] == "quarantined"
    assert tfix.scheme_id == "secded72"
    qc, _ = repair.due_block_mask(tenc["w2"])
    qf, df = repair.due_block_mask(tfix)
    assert not df.any() and np.array_equal(qf, qc)
    _assert_trees_equal({"w": tfix}, {"w": jfix})


def test_milr_unrecoverable_without_twin():
    _, jenc, tenc = _small_tree(seed=2)
    jkit = jrepair.build_repair_kit(jenc, seed=9, n_samples=4, twins=False)
    tkit = repair.build_repair_kit(tenc, seed=9, n_samples=4, twins=False)
    jd, td = _corrupt_rows(jenc["w2"], tenc["w2"], rows=tuple(range(6)))
    _, jrep = jrepair.repair_leaf(jd, jkit.entries["w2"], n_samples=4)
    same, trep = repair.repair_leaf(td, tkit.entries["w2"], n_samples=4)
    _reports_equal([trep], [jrep])
    assert trep["status"] == "unrecoverable"
    assert same is td


def test_repair_kit_requires_clean_tree_and_repair_tree_reports():
    _, jenc, tenc = _small_tree(seed=4)
    jenc["w1"], tenc["w1"] = _corrupt_rows(jenc["w1"], tenc["w1"], (0,))
    with pytest.raises(ValueError, match="clean tree"):
        repair.build_repair_kit(tenc)
    _, jclean, tclean = _small_tree(seed=4)
    jkit = jrepair.build_repair_kit(jclean, seed=9, n_samples=8)
    tkit = repair.build_repair_kit(tclean, seed=9, n_samples=8)
    jh, jreps = jrepair.repair_tree(jenc, jkit)
    th, treps = repair.repair_tree(tenc, tkit)
    _reports_equal(treps, jreps)
    assert [r["path"] for r in treps] == ["w1"]
    assert treps[0]["status"] == "repaired"
    _assert_trees_equal(th, jh)
    assert repair.repair_tree(th, tkit)[1] == []


# ---------------------------------------------------------------------------
# plan diff and rolling migration
# ---------------------------------------------------------------------------


def test_plan_diff_and_migrate_step_value_exact():
    params, jenc, tenc = _small_tree(seed=6)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    jplan = jprotection.ProtectionPolicy(predicate=_ndim2).plan(params)
    jtgt = jprotection.ProtectionPolicy(default_scheme="secded72",
                                        predicate=_ndim2).plan(params)
    tplan = protection.ProtectionPolicy(predicate=_ndim2).plan(tparams)
    ttgt = protection.ProtectionPolicy(default_scheme="secded72",
                                       predicate=_ndim2).plan(tparams)
    jd, td = jplan.diff(jtgt), tplan.diff(ttgt)
    assert td.paths == jd.paths and set(td.paths) == set(tenc)
    assert td.summary() == jd.summary()
    assert td.summary()["stored_bytes_delta"] > 0
    first = td.paths[0]
    jenc2, jmixed, jrecs = jplan.migrate_step(jenc, jtgt, [first])
    tenc2, tmixed, trecs = tplan.migrate_step(tenc, ttgt, [first])
    assert trecs == jrecs and trecs[0]["to"] == "secded72"
    _assert_trees_equal(tenc2, jenc2)
    assert tmixed.leaves[first].scheme_id == "secded72"
    assert tmixed.diff(ttgt).paths == jmixed.diff(jtgt).paths
    dec_a = tplan.decode_tree(tenc, torch.float32)
    dec_b = tmixed.decode_tree(tenc2, torch.float32)
    for k in tparams:
        assert torch.equal(dec_a[k], dec_b[k])
    with pytest.raises(KeyError):
        tplan.migrate_step(tenc, ttgt, ["nope"])


def test_plan_diff_rejects_mismatched_leaf_sets():
    params, _, _ = _small_tree(seed=6)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    pol = protection.ProtectionPolicy(predicate=_ndim2)
    with pytest.raises(ValueError):
        pol.plan(tparams).diff(pol.plan(
            {k: tparams[k] for k in sorted(tparams)[:2]}))


@functools.lru_cache(maxsize=None)
def _ref_step():
    cfg, plan, _, _ = P._reference_model(ARCH)
    kvp = dataclasses.replace(jkv.get_kv_policy("in-place"),
                              per_slot_flags=True)
    return kvp, jax.jit(jprot.make_serve_step(
        cfg, plan=plan, with_flags=True, kv_policy=kvp, dtype=jnp.float32))


def _waves(maker, vocab):
    return maker(seed=11, n_waves=2, wave_size=3, vocab=vocab,
                 prompt_len=(3, 6), max_new=(2, 4), gap_steps=4)


def _targets():
    """The secded72 target plans of the smoke model, in both packages."""
    cfg, _, params, _ = P._reference_model(ARCH)
    jtgt = jprot.make_plan(params, jprotection.ProtectionPolicy(
        default_scheme="secded72"))
    from repro_torch.models import lm as tlm
    ttgt = protection.ProtectionPolicy(default_scheme="secded72").plan(
        tlm.param_shapes(tconfigs.get_smoke(ARCH)))
    return jtgt, ttgt


def test_migration_mid_traffic_tokens_match():
    """A live in-place -> secded72 migration while serving, in both
    front-ends: the tokens are the non-migrating run's (the transcode is
    value-exact), the deterministic telemetry (migrate events included)
    equals the reference's, every live leaf ends under secded72."""
    cfg, jplan, _, jenc = P._reference_model(ARCH)
    tcfg = tconfigs.get_smoke(ARCH)
    tplan = P.port_plan(ARCH)
    tenc = _port(jenc)
    jtgt, ttgt = _targets()
    kvp, step = _ref_step()
    base = frontend.run_burst(tcfg, tenc, plan=tplan,
                              waves=_waves(frontend.make_waves, cfg.vocab),
                              slots=2, max_len=32, dtype=torch.float32,
                              device="cpu")[2]
    jfe_ = jfe.ServingFrontend(cfg, jenc, plan=jplan, slots=2, max_len=32,
                               kv_policy=kvp, serve_step=step,
                               dtype=jnp.float32)
    tfe = frontend.ServingFrontend(tcfg, tenc, plan=tplan, slots=2,
                                   max_len=32, dtype=torch.float32,
                                   device="cpu")
    for fe, mk, tgt in ((jfe_, jfe, jtgt), (tfe, frontend, ttgt)):
        for req in _waves(mk.make_waves, cfg.vocab):
            fe.submit(dataclasses.replace(req, arrival_step=0))
        fe.start_migration(tgt, leaves_per_step=2, every=1)
        fe.run()
    n = len(ttgt.diff(tplan).paths)
    assert tfe.migration_done and tfe._migrator.promoted == n
    assert tfe.results == base == jfe_.results
    assert telemetry.deterministic_view(tfe.telemetry.events) == \
        jtel.deterministic_view(jfe_.telemetry.events)
    leaves = [l for _, l in tree.leaves_with_path(tfe.enc_params)
              if protection.is_protected_tensor(l)]
    assert leaves and all(l.scheme_id == "secded72" for l in leaves)
    assert telemetry.summarize(tfe.telemetry.events)["healing"][
        "migrated_leaves"] == n


def test_migration_guard_rails():
    cfg, _, _, jenc = P._reference_model(ARCH)
    tcfg = tconfigs.get_smoke(ARCH)
    _, ttgt = _targets()
    fe = frontend.ServingFrontend(tcfg, _port(jenc), plan=P.port_plan(ARCH),
                                  slots=2, max_len=32, device="cpu")
    fe.start_migration(ttgt)
    with pytest.raises(RuntimeError, match="already in flight"):
        fe.start_migration(ttgt)
    fe2 = frontend.ServingFrontend(tcfg, fe.enc_params, slots=2, max_len=32,
                                   device="cpu")
    with pytest.raises(ValueError, match="without a plan"):
        fe2.start_migration(ttgt)
    with pytest.raises(ValueError, match=">= 1"):
        scrubber.Migrator(P.port_plan(ARCH), ttgt, leaves_per_step=0)
    with pytest.raises(ValueError, match=">= 0"):
        scrubber.Scrubber(leaves_per_step=-1)


# ---------------------------------------------------------------------------
# end to end: a faulted serve loop heals to the clean state, bit for bit
# ---------------------------------------------------------------------------


def _weight_masks(tenc, steps, rate=1e-3, seed=5):
    return {t: _mask_tree(tenc, rate, seed + 1_000_003 + t) for t in steps}


def _kv_masks(cache, steps, rate=1e-3, seed=5):
    rng = np.random.default_rng(seed)
    out = {}
    for t in steps:
        out[t] = {}
        for key in ("k_pages", "v_pages"):
            bits = rng.random((*cache[key].shape, 8)) < rate
            out[t][key] = np.packbits(bits, axis=-1, bitorder="little")[
                ..., 0]
    return out


def _healing_runs():
    """The faulted healing burst in both front-ends: KV and weight masks
    at 1e-3 before every 4th step while requests are active, a scrub
    every step (2 weight leaves, 4 pages), MILR repair, the final at-rest
    pass. -> ((reference fe, events, final), (port fe, events, final))."""
    cfg, jplan, _, jenc = P._reference_model(ARCH)
    tcfg = tconfigs.get_smoke(ARCH)
    tenc = _port(jenc)
    kvp, step = _ref_step()
    jkit = jrepair.build_repair_kit(jenc, seed=5)
    tkit = repair.build_repair_kit(tenc, seed=5)
    _assert_kits_equal(tkit, jkit)
    out = []
    wmasks = kvmasks = None
    for pkg in ("ref", "port"):
        if pkg == "ref":
            col = jtel.TelemetryCollector()
            fe = jfe.ServingFrontend(
                cfg, jenc, plan=jplan, slots=2, max_len=32, kv_policy=kvp,
                serve_step=step, collector=col, dtype=jnp.float32,
                scrub_every=1, scrub_weight_leaves=2, repair_kit=jkit)
            waves = _waves(jfe.make_waves, cfg.vocab)
        else:
            col = telemetry.TelemetryCollector()
            fe = frontend.ServingFrontend(
                tcfg, tenc, plan=P.port_plan(ARCH), slots=2, max_len=32,
                collector=col, dtype=torch.float32, scrub_every=1,
                scrub_weight_leaves=2, repair_kit=tkit, device="cpu")
            waves = _waves(frontend.make_waves, cfg.vocab)
        if wmasks is None:
            steps = range(0, 64, 4)
            wmasks = _weight_masks(tenc, steps)
            kvmasks = _kv_masks({k: np.asarray(v) for k, v in
                                 fe.cache.items()}, steps)
        pending = sorted(waves, key=lambda r: (r.arrival_step, r.rid))
        i = 0
        for _ in range(10_000):
            while i < len(pending) and pending[i].arrival_step <= fe.step_no:
                fe.submit(pending[i])
                i += 1
            if i >= len(pending) and not fe.queue.peek() and fe.active == 0:
                break
            if fe.active > 0 and fe.step_no in wmasks:
                m = kvmasks[fe.step_no]
                if pkg == "ref":
                    fe.cache = {**fe.cache, **{k: fe.cache[k] ^ jnp.asarray(v)
                                               for k, v in m.items()}}
                    fe.enc_params, _ = _apply_masks(
                        fe.enc_params, tenc, wmasks[fe.step_no])
                else:
                    for k, v in m.items():
                        fe.cache[k] ^= torch.from_numpy(v)
                    _, fe.enc_params = _apply_masks(
                        jenc, fe.enc_params, wmasks[fe.step_no])
            fe.step()
        out.append((fe, col.events, fe.final_scrub()))
    return out


@pytest.fixture(scope="module")
def healed():
    return _healing_runs()


def test_faulted_serve_loop_heals_to_bitexact_logits(healed):
    """With KV and weight faults at 1e-3 throughout, both loops drain; the
    at-rest pass reports ZERO residual DUE; the port's events, tokens,
    healed tree and repair reports equal the reference's; the healed tree
    serves logits bit-equal to the never-faulted tree's."""
    (jf, jev, jfin), (tf, tev, tfin) = healed
    assert tfin == jfin
    assert tf.results == jf.results
    _views_equal(tev, jev)
    _assert_trees_equal(tf.enc_params, jf.enc_params)
    summ = telemetry.summarize(tev)
    assert summ["requests"]["finished"] == summ["requests"]["submitted"]
    assert summ["pool"]["leaked_pages"] == 0
    assert tfin["w_due"] == 0 and tfin["kv_due"] == 0
    heal = summ["healing"]
    assert heal["scrub_passes"] > 0 and heal["repairs"]
    assert heal["w_corrected"] + tfin["w_corrected"] > 0
    assert heal["final_due"] == {"w": 0, "kv": 0,
                                 "w_corrected": tfin["w_corrected"],
                                 "kv_corrected": tfin["kv_corrected"],
                                 "w_repaired": tfin["w_repaired"]}
    tcfg = tconfigs.get_smoke(ARCH)
    clean = _port(P._reference_model(ARCH)[3])
    step = protected.make_serve_step(tcfg, plan=P.port_plan(ARCH),
                                     dtype=torch.float32)
    logits = []
    for t in (clean, tf.enc_params):
        cache = kvcache.init_cache(tcfg, 2, 32, dtype=torch.float32,
                                   device="cpu")
        logits.append(step(t, cache, torch.ones((2, 1), dtype=torch.long),
                           torch.zeros((2,), dtype=torch.int32))[0])
    assert torch.equal(logits[0], logits[1])


def test_faulted_healing_run_is_bit_deterministic(healed):
    """A second port run of the same masks agrees on the full
    deterministic view and every token; healing events carry no wall
    fields."""
    (_, _, _), (tf, tev, tfin) = healed
    (_, _, _), (tf2, tev2, tfin2) = _healing_runs()
    assert tf2.results == tf.results and tfin2 == tfin
    assert telemetry.deterministic_view(tev2) == \
        telemetry.deterministic_view(tev)
    heal = [e for e in tev if e["event"] in ("scrub", "scrub_final",
                                             "migrate", "repair")]
    assert heal
    for e in heal:
        assert not any(k.endswith(("_s", "_ms")) for k in e)


def test_run_burst_heals_with_its_own_fault_streams():
    """``run_burst(scrub_every=1, repair=True)`` with its seeded weight
    and KV streams: it drains, leaks no page and ends with no residual
    DUE (the torch generators cannot replay the reference's streams, so
    this run is held to the contract, not to the reference's counts)."""
    cfg, _, _, jenc = P._reference_model(ARCH)
    tcfg = tconfigs.get_smoke(ARCH)
    _, summ, res = frontend.run_burst(
        tcfg, _port(jenc), plan=P.port_plan(ARCH),
        waves=_waves(frontend.make_waves, cfg.vocab), slots=2, max_len=32,
        fault_rate=1e-3, weight_fault_rate=1e-3, scrub_every=1,
        repair=True, device="cpu")
    assert summ["requests"]["finished"] == 6 and len(res) == 6
    assert summ["pool"]["leaked_pages"] == 0
    assert summ["healing"]["final_due"]["w"] == 0
    assert summ["healing"]["final_due"]["kv"] == 0


# ---------------------------------------------------------------------------
# telemetry v2
# ---------------------------------------------------------------------------


def test_summary_schema_v2_and_v1_compat(tmp_path):
    assert telemetry.SUMMARY_SCHEMA == jtel.SUMMARY_SCHEMA == "burst_sim/v2"
    summ = telemetry.summarize([])
    assert summ == jtel.summarize([])
    assert summ["healing"]["scrub_passes"] == 0
    assert summ["healing"]["final_due"] is None
    v2 = tmp_path / "v2.json"
    telemetry.write_summary(summ, str(v2))
    assert telemetry.load_summary(str(v2)) == summ == jtel.load_summary(
        str(v2))
    v1 = tmp_path / "v1.json"
    v1.write_text(json.dumps({"schema": "burst_sim/v1", "steps": 3}))
    assert telemetry.load_summary(str(v1)) == jtel.load_summary(str(v1))
    assert telemetry.load_summary(str(v1))["healing"] is None
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": "burst_sim/v99"}))
    with pytest.raises(ValueError, match="unsupported"):
        telemetry.load_summary(str(bad))


def test_healing_rollup_counts_events():
    events = [
        {"event": "scrub", "step": 0, "w_scanned": 2, "w_corrected": 3,
         "w_due": 1, "kv_scanned": 4, "kv_corrected": 5, "kv_due": 0},
        {"event": "scrub", "step": 2, "w_scanned": 2, "w_corrected": 0,
         "w_due": 0, "kv_scanned": 4, "kv_corrected": 1, "kv_due": 0},
        {"event": "repair", "step": 0, "path": "a", "status": "repaired"},
        {"event": "repair", "step": 0, "path": "b",
         "status": "quarantined"},
        {"event": "migrate", "step": 1, "phase": "start", "pending": 2},
        {"event": "migrate", "step": 1, "phase": "promote", "path": "a",
         "pending": 1},
        {"event": "migrate", "step": 2, "phase": "promote", "path": "b",
         "pending": 0},
        {"event": "scrub_final", "step": 9, "w_scanned": 9,
         "w_corrected": 7, "w_repaired": 1, "w_due": 0, "kv_scanned": 2,
         "kv_corrected": 0, "kv_due": 0},
    ]
    heal = telemetry.summarize(events)["healing"]
    assert heal == jtel.summarize(events)["healing"]
    assert heal["scrub_passes"] == 2
    assert heal["w_corrected"] == 3 and heal["kv_corrected"] == 6
    assert heal["due_leaves_seen"] == 1
    assert heal["repairs"] == {"repaired": 1, "quarantined": 1}
    assert heal["migrated_leaves"] == 2
    assert heal["final_due"] == {"w": 0, "kv": 0, "w_corrected": 7,
                                 "kv_corrected": 0, "w_repaired": 1}


# ---------------------------------------------------------------------------
# the CLIs: serve --policy/--autotune/--scrub-every/--repair, burst_sim
# ---------------------------------------------------------------------------


def test_serve_cli_heals_under_a_mixed_preset(tmp_path):
    """``--policy``, ``--autotune``, ``--scrub-every`` and ``--repair`` on
    the fixed-batch path: two schemes planned, faults written back during
    the run, no DUE leaf left after the final pass."""
    table = tmp_path / "autotune.json"
    table.write_text(json.dumps({"schema": "bench_kernels/v1", "entries": [
        {"shape": [64, 64], "best": "xla"}]}))
    out = serve.main(
        ["--device", "cpu", "--tokens", "4", "--batch", "2", "--policy",
         "attn-inplace-mlp-secded", "--autotune", str(table),
         "--scrub-every", "2", "--repair", "--fault-rate", "1e-3",
         "--trials", "1"])
    heal = out["healing"]
    assert heal["corrected"] > 0 and heal["residual_due_leaves"] == 0


def test_burst_sim_scrub_grid_heals_and_replays():
    from repro_torch.benchmarks import burst_sim
    out = burst_sim.main(["--device", "cpu", "--smoke", "--kv-policies",
                          "in-place", "--fault-rates", "1e-3",
                          "--scrub-every", "2", "--repair",
                          "--weight-fault-rate", "1e-3"])
    assert sorted(out["cells"]) == ["in-place_r0.001",
                                    "in-place_r0.001_scrub2"]
    assert all(c["cell"]["bit_deterministic"] for c in out["cells"].values())
    row, = out["scrub_slo"]
    assert row["final_due"]["w"] == 0 and row["final_due"]["kv"] == 0
    assert row["w_corrected"] > 0 and row["leaked_pages"] == 0
