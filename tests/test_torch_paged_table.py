"""The table entries of the port's paged-attention kernels against the
reference, on the CPU.

``fused_page_attention_paged`` and ``chunked_page_attention_paged`` read
one layer's KV pool through the page table (the serving cache's decode
path); for CPU tensors they run their plain versions, the gather then the
strip plain version. A pool made with NumPy, encoded through the
reference's ``_encode_kv`` and faulted with one shared mask, is laid out as
the serving front-end lays it out: parking pages, a shuffled table, a page
shared by two rows and a parking page past a row's ``pos``. The table
entries are held equal to ``paged_attention.gather_strips`` + the strip
plain versions, and to the reference's XLA route (``repro.serving.kvcache.
_gather_seq`` + ``_reference_paged_attention``): flags exactly, outputs
within the tolerances of ``test_torch_paged_attention.py``. The chunked
kernel's split plan is tested here too, and the decode path is checked
not to gather on the kernel presets.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import faults as jfaults
from repro.serving import kvcache as jkv
from repro_torch import configs
from repro_torch.kernels import paged_attention
from repro_torch.models import lm
from repro_torch.protection.policy import ProtectionPolicy
from repro_torch.serving import kvcache, protected

# as test_torch_paged_attention.py: f32 to summation order; bf16 to one
# bf16 ulp of the probabilities
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _pool(rng, b, npg, ps, kv, hd, scheme):
    """A faulted pool as NumPy arrays, its table and positions.

    Pages 0..B-1 park the slots; rows' pages follow in a shuffled order;
    rows 0 and 1 share their first page; the last row's last page is its
    parking page, past its pos. -> (k enc, k checks | None, k scale, v
    enc, v checks | None, v scale, table (B, npg) int32, pos (B,) int32).
    """
    n_pages = b + b * npg + 2
    jpol = jkv.KVProtectionPolicy(scheme=scheme)
    out = []
    for i in range(2):
        f = rng.standard_normal((n_pages, ps, kv, hd)).astype(np.float32)
        enc, ch, sc = (None if a is None else np.asarray(a)
                       for a in jkv._encode_kv(jnp.asarray(f), jpol))
        enc = jfaults.inject(enc.reshape(-1), 4e-3, 40 + i).reshape(enc.shape)
        if ch is not None:
            ch = jfaults.inject(ch.reshape(-1), 4e-3, 50 + i).reshape(
                ch.shape)
        out += [enc, ch, sc]
    table = (rng.permutation(n_pages - b)[: b * npg] + b).reshape(
        b, npg).astype(np.int32)
    table[1, 0] = table[0, 0]
    table[b - 1, npg - 1] = b - 1
    s = npg * ps
    pos = np.array([s - 1, s // 2, 5, (npg - 1) * ps - 1][:b], np.int32)
    pos[b - 1] = min(pos[b - 1], (npg - 1) * ps - 1)
    return out + [table, pos]


def _torch(arrays):
    return [None if a is None else _t(a) for a in arrays]


def _reference(q, pool, table, pos, scheme, per_slot):
    """The reference's XLA route: its gather, then decode-then-attend."""
    j = [None if a is None else jnp.asarray(a) for a in pool]
    jt = jnp.asarray(table)
    ke, kch, ksc = jkv._gather_seq(j[0], j[1], j[2], jt)
    ve, vch, vsc = jkv._gather_seq(j[3], j[4], j[5], jt)
    pol = dataclasses.replace(jkv.KVProtectionPolicy(scheme=scheme),
                              per_slot_flags=per_slot)
    return jkv._reference_paged_attention(q, ke, kch, ksc, ve, vch, vsc,
                                          jnp.asarray(pos), pol)


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("scheme", ["faulty", "parity-zero", "in-place"])
@pytest.mark.parametrize("kernel", ["strip", "chunked"])
def test_table_entries_equal_gather_plus_strip_plain(kernel, scheme,
                                                     per_slot):
    rng = np.random.default_rng(7)
    b, h, kv, hd, npg, ps = 4, 4, 2, 16, 5, 8
    *pool, table, pos = _pool(rng, b, npg, ps, kv, hd, scheme)
    tp, tt, tpos = _torch(pool), _t(table), _t(pos)
    q = _t(rng.standard_normal((b, h, 1, hd)).astype(np.float32))
    if kernel == "strip":
        entry = paged_attention.fused_page_attention_paged
        plain = paged_attention.fused_page_attention_plain
        kw = {}
    else:
        entry = paged_attention.chunked_page_attention_paged
        plain = paged_attention.chunked_page_attention_plain
        kw = dict(chunk_tokens=16)
    o, f = entry(q, *tp, tt, tpos, scheme=scheme, per_slot=per_slot, **kw)
    ke, kch, ksc = paged_attention.gather_strips(*tp[:3], tt)
    ve, vch, vsc = paged_attention.gather_strips(*tp[3:], tt)
    po, pf = plain(q, ke, kch, ksc, ve, vch, vsc, tpos, scheme=scheme,
                   per_slot=per_slot, **kw)
    assert torch.equal(o, po) and torch.equal(f, pf)
    assert tuple(f.shape) == ((2, b) if per_slot else (2,))
    assert (int(f[0].sum()) > 0) == (scheme != "faulty")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("scheme", ["faulty", "parity-zero", "in-place"])
@pytest.mark.parametrize("kernel", ["strip", "chunked"])
def test_table_entries_match_the_reference_xla_route(kernel, scheme,
                                                     per_slot, dtype):
    rng = np.random.default_rng(11)
    b, h, kv, hd, npg, ps = 3, 6, 2, 16, 4, 16    # rep 3
    *pool, table, pos = _pool(rng, b, npg, ps, kv, hd, scheme)
    q = rng.standard_normal((b, h, 1, hd)).astype(np.float32)
    jq = jnp.asarray(q).astype(getattr(jnp, dtype))
    tq = _t(np.asarray(jq.astype(jnp.float32))).to(getattr(torch, dtype))
    jo, jc, jd = _reference(jq, pool, table, pos, scheme, per_slot)
    entry = (paged_attention.fused_page_attention_paged if kernel == "strip"
             else paged_attention.chunked_page_attention_paged)
    o, f = entry(tq, *_torch(pool), _t(table), _t(pos), scheme=scheme,
                 per_slot=per_slot)
    assert f.tolist() == [np.asarray(jc).tolist(), np.asarray(jd).tolist()]
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(jo.astype(jnp.float32)),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_split_plan_covers_every_live_token_once():
    """Every token <= pos of a row is read by exactly one split, each split
    starts on a 32-token tile (whole pages at the presets' page size) and
    stays inside its row; the plan keeps every CTA resident at the serve
    shapes."""
    tile = paged_attention.CHUNK_TILE
    assert tile == 32
    for s in (16, 100, 2064, 16384):
        for n_live in sorted({1, 15, 16, 17, 33, s // 2, s} &
                             set(range(1, s + 1))):
            for splits in (1, 2, 3, 5, 17, 64):
                ranges = paged_attention.split_token_ranges(s, n_live, splits)
                assert len(ranges) == splits
                covered = np.zeros(n_live, np.int32)
                for t0, t1 in ranges:
                    assert 0 <= t0 <= t1 <= n_live
                    assert t0 % tile == 0 or t0 == n_live
                    covered[t0:t1] += 1
                assert (covered == 1).all()
                assert [r[0] for r in ranges] == sorted(r[0] for r in ranges)
    plan = paged_attention.plan_splits
    assert plan(4, 32, 2064, 132) == 5           # 640 CTAs, 4.8 per SM
    assert plan(1, 32, 16384, 132) == 20         # 640 CTAs
    assert plan(8, 32, 128, 132) == 2            # 2 tiles a split at least
    assert plan(4, 32, 16, 132) == 1
    for b, kv, s in ((1, 1, 16), (2, 8, 100), (64, 32, 4096), (1, 8, 10 ** 6)):
        sp = plan(b, kv, s, 132)
        assert sp >= 1 and (sp == 1 or (
            -(-s // tile) // sp >= 2 and b * kv * sp <= 5 * 132))


def test_table_bound_of_a_split_holds_its_pages():
    """chunked_table_entries bounds the pages any split's tiles span."""
    tile = paged_attention.CHUNK_TILE
    for npg, ps in ((129, 16), (5, 8), (3, 40), (1, 2064), (64, 64)):
        s = npg * ps
        ntl = -(-s // tile)
        for splits in (1, 2, 5):
            bound = paged_attention.chunked_table_entries(npg, ps, s, splits)
            for sp in range(splits):
                c0, c1 = sp * ntl // splits, (sp + 1) * ntl // splits
                if c1 > c0:
                    last = min(c1 * tile, s) - 1
                    assert last // ps - c0 * tile // ps + 1 <= bound


@pytest.mark.parametrize("kv_policy", ["in-place-fused", "in-place-chunked",
                                       "parity-zero-fused",
                                       "parity-zero-chunked"])
def test_decode_path_reads_the_pool_through_the_table(kv_policy,
                                                      monkeypatch):
    """On the kernel presets ``paged_gqa_decode`` hands the pool and the
    table to the table entries and never calls ``gather_strips`` itself
    (on CPU tensors only the entries' plain versions gather, inside the
    entry; on the card nothing does); the reference preset still gathers
    in the decode path (so the patch is live)."""
    gather = paged_attention.gather_strips
    inside = []

    def no_gather(*a, **k):
        if not inside:
            raise AssertionError("the decode path gathered the pool")
        return gather(*a, **k)
    monkeypatch.setattr(paged_attention, "gather_strips", no_gather)
    seen = []
    for name in ("fused_page_attention_paged",
                 "chunked_page_attention_paged"):
        orig = getattr(paged_attention, name)

        def spy(*a, _orig=orig, _name=name, **k):
            seen.append(_name)
            inside.append(_name)
            try:
                return _orig(*a, **k)
            finally:
                inside.pop()
        monkeypatch.setattr(paged_attention, name, spy)
    cfg = configs.get_smoke("minitron-4b")
    plan = ProtectionPolicy(backend="cuda").plan(lm.param_shapes(cfg))
    enc = lm.init_params(cfg, 0, device="cpu", leaf_fn=plan.encode_leaf)

    def run(policy):
        step = protected.make_serve_step(cfg, plan=plan, backend="cuda",
                                         kv_policy=policy)
        cache = kvcache.init_cache(cfg, 2, 32, kv_policy=policy,
                                   device="cpu")
        return step(enc, cache, torch.zeros((2, 1), dtype=torch.long),
                    torch.tensor([0, 3], dtype=torch.int32))
    run(kv_policy)
    want = ("chunked" if kv_policy.endswith("chunked") else "fused") + \
        "_page_attention_paged"
    assert seen and set(seen) == {want}
    with pytest.raises(AssertionError, match="gathered"):
        run(kv_policy.rsplit("-", 1)[0])


@pytest.mark.parametrize("arch", ["deepseek-7b", "minitron-4b",
                                  "qwen1.5-4b", "whisper-base"])
def test_dense_kv_bytes_equals_the_reference(arch):
    from repro import configs as jconfigs
    for batch, max_len in ((1, 16), (4, 64), (8, 2064)):
        assert kvcache.dense_kv_bytes(configs.get(arch), batch, max_len) == \
            jkv.dense_kv_bytes(jconfigs.get(arch), batch, max_len)
        assert kvcache.dense_kv_bytes(configs.get_smoke(arch), batch,
                                      max_len) == \
            jkv.dense_kv_bytes(jconfigs.get_smoke(arch), batch, max_len)
