"""The moe family (deepseek-v2-236b's and deepseek-v3-671b's smoke configs)
in the port against the reference's XLA route: the capacity-based top-k
MoE (in f32 and bf16, the experts it picks, the (token, k) pairs it drops
when one expert overflows, ties broken to the lower index), MLA over a
sequence and one token at a time over the latent cache (v2's single query
projection and v3's low-rank ``q_lora`` pair), ``lm.decode_step`` on f32
params, the decode-at-use serve step and the cache-less forward on a
faulted tree with exactly equal flags, the bf16 forward where the two
packages route alike, the calibration scales, the parameter and cache
shapes of the full configs, the carried-over moe leaves, the raises the
reference shares (a paged KV cache with MLA), the serve CLI, and the
moe-GQA branch (``use_mla=False``) on its dense and paged KV caches.

Weights come from the reference's ``lm.init_params`` through NumPy; each
reference model is built once (``tests/torch_parity.py`` caches it). On the
CPU the ``cuda`` route's kernel wrappers take their plain versions.
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
from repro.models import layers as jL
from repro.models import lm as jlm
from repro.serving import kvcache as jkv
from repro.serving import protected as jprot
from repro.training import train as jtrain
from repro_torch import configs, convert, tree
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.serving import kvcache
from repro_torch.serving import protected
from repro_torch.training import train

ARCHS = ("deepseek-v2-236b", "deepseek-v3-671b")
# f32 on both sides: matmul sums in another order, last-ulp differences of
# exp, cos and sin; routing is equal, so the outputs are too up to that
F32_TOL = 1e-4
# bf16 on the same inputs: the expert products and the weighted sum over
# k round to bf16 at other places in XLA and PyTorch; a few bf16 ulps
# (2^-8 relative each) of outputs up to |2| (0.0234 seen at the smoke
# width)
BF16_TOL = 2 ** -5
# bf16 activations through whole blocks, as tests/test_torch_forward.py
# holds every other family, on the rows that both packages route alike
BF16_MAX_ATOL = 0.125
BF16_MEAN_ATOL = 0.02
# at most this share of (token, layer) pairs may route to another top-k
# set in the bf16 forward: the routes round each activation at other
# places, and a gate within a bf16 rounding of the k-th one flips (one
# pair in 96 seen at the smoke width, 2 x 24 tokens x 2 layers)
BF16_ROUTE_FLIP_SHARE = 0.1
BATCH, STEPS = 2, 4


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _t(x, dtype="float32"):
    return torch.from_numpy(np.array(x, np.float32)).to(getattr(torch,
                                                                dtype))


def _j(x, dtype="float32"):
    return jnp.asarray(np.asarray(x, np.float32), getattr(jnp, dtype))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _layer(arch, sub, i=0):
    """Layer ``i``'s ``sub`` params of the reference's smoke init."""
    p = P.reference_params(arch)["layers"][sub]
    return {k: np.array(v[i]) for k, v in p.items()}


@functools.lru_cache(maxsize=None)
def _gqa_model(arch):
    """The moe-GQA variant (``use_mla=False``): the smoke config keeps the
    full config's 128 KV heads over its 4 query heads, where both packages
    fail (GQA's repeat factor is 4 // 128 = 0), so it takes 2 KV heads."""
    cfg = jconfigs.get_smoke(arch).with_(use_mla=False, n_kv_heads=2)
    params = jax.jit(lambda k: jlm.init_params(cfg, k))(jax.random.PRNGKey(0))
    plan = jprotection.ProtectionPolicy(backend="xla").plan(params)
    return cfg, plan, params, jax.jit(plan.encode_tree)(params)


def _model(arch, gqa=False):
    return _gqa_model(arch) if gqa else P._reference_model(arch)


def _port_cfg(arch, gqa=False):
    cfg = configs.get_smoke(arch)
    return cfg.with_(use_mla=False, n_kv_heads=2) if gqa else cfg


@functools.lru_cache(maxsize=None)
def _faulted_export(arch, gqa=False):
    return P._flip_exported(P.export(_model(arch, gqa)[3]), seed=17)


def _spy_top_k(monkeypatch, store):
    """Record the reference's ``jax.lax.top_k`` indices (its moe's routing)
    per call, inside jit and scan too."""
    real = jax.lax.top_k

    def spy(x, k):
        w, i = real(x, k)
        jax.debug.callback(lambda a: store.append(np.asarray(a)), i,
                           ordered=True)
        return w, i
    monkeypatch.setattr(jax.lax, "top_k", spy)


def _port_routing(monkeypatch):
    """Record the port's moe routing: the top-k expert ids of each call."""
    calls: list = []
    real = L.top_k_lower_first

    def spy(x, k):
        w, i = real(x, k)
        calls.append(i)
        return w, i
    monkeypatch.setattr(L, "top_k_lower_first", spy)
    return calls


def _kept(cfg, topi):
    """The (token, k) pairs the port's queues keep at capacity (B, S, k)."""
    b, s, k = topi.shape
    pos = L.queue_positions(topi.reshape(b, s * k), cfg.n_experts)[3]
    return (pos < L.moe_capacity(cfg, s)).reshape(b, s, k)


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------


def _moe_both(arch, p, x, dtype, monkeypatch):
    """Run the reference's and the port's ``moe`` on the same params and
    input -> (ref out, port out, ref topi, port topi, port keep)."""
    cfg, tcfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jtopi: list = []
    _spy_top_k(monkeypatch, jtopi)
    ref = jL.moe({k: _j(v) for k, v in p.items()}, _j(x, dtype), cfg)
    jax.effects_barrier()
    sink = _port_routing(monkeypatch)
    got = L.moe({k: _t(v) for k, v in p.items()}, _t(x, dtype), tcfg)
    assert len(jtopi) == 1 and len(sink) == 1
    return (_f32(ref), _f32(got), jtopi[0], sink[0].numpy(),
            _kept(tcfg, sink[0]).numpy())


def _bf16_exact(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_reference(arch, dtype, monkeypatch):
    """Layer 0's MoE over (2, 24) seeded inputs: in f32 the same experts
    per token (top-k indices equal, in order) and outputs within F32_TOL;
    in bf16 (inputs bf16-exact) the same experts and outputs within
    BF16_TOL. No pair is dropped at this size (capacity 8 per expert for
    24 tokens, 2 x 24 pairs over 8 experts)."""
    p = _layer(arch, "moe")
    x = _bf16_exact(_rand((2, 24, 64), 3))
    ref, got, jtopi, ttopi, keep = _moe_both(arch, p, x, dtype, monkeypatch)
    np.testing.assert_array_equal(ttopi, jtopi)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)
    assert L.moe_capacity(configs.get_smoke(arch), 24) == \
        jL.moe_capacity(jconfigs.get_smoke(arch), 24) == 8


def _queue_keep(topi, cap):
    """The reference's capacity rule, written out: in each row the (token,
    k) pairs queue at their expert in (token, k) order, and the first
    ``cap`` of each queue are kept."""
    keep = np.zeros(topi.shape, bool)
    for b in range(topi.shape[0]):
        seen: dict = {}
        for t in range(topi.shape[1]):
            for j in range(topi.shape[2]):
                e = int(topi[b, t, j])
                keep[b, t, j] = seen.get(e, 0) < cap
                seen[e] = seen.get(e, 0) + 1
    return keep


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_drops_the_same_pairs_on_overflow(arch, monkeypatch):
    """A router that sends every token's first choice to expert 3 (its
    column is all 0.1 over inputs of positive sum, so its logit leads by
    about 8 and the other gates stay normal f32 numbers, which XLA's CPU
    code would flush to zero as denormals): 24 pairs queue at an expert
    of 8 slots (the inputs' positive sum favours one expert for the
    second choice too, which may overflow as well). The port keeps
    exactly the first 8 pairs of each expert's queue in (token, k) order
    (the queue is a stable sort) and drops the others, 16 of them
    expert 3's, and its output equals the reference's within F32_TOL, which
    a different set of drops would break by O(1)."""
    p = _layer(arch, "moe")
    router = _rand(p["router"].shape, 5, 0.1)
    router[:, 3] = 0.1
    p["router"] = router
    x = np.abs(_rand((2, 24, 64), 6)) + 0.5
    ref, got, jtopi, ttopi, keep = _moe_both(arch, p, x, "float32",
                                             monkeypatch)
    np.testing.assert_array_equal(ttopi, jtopi)
    assert (ttopi[..., 0] == 3).all()
    assert not (ttopi[..., 1] == 3).any()
    np.testing.assert_array_equal(keep, _queue_keep(ttopi, cap=8))
    assert keep[:, :8, 0].all() and not keep[:, 8:, 0].any()
    np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL)
    # without the drops the output would differ where pairs were dropped
    cfg = configs.get_smoke(arch).with_(capacity_factor=4.0)
    roomy = L.moe({k: _t(v) for k, v in p.items()}, _t(x), cfg).numpy()
    assert np.abs(roomy - got)[:, 8:].min(axis=-1).max() > 0
    np.testing.assert_allclose(roomy[:, :8], got[:, :8], rtol=F32_TOL,
                               atol=F32_TOL)


# router columns as multiples of one positive direction: (expert 0,
# expert 1, expert 2); the rest far below. "boundary": the k-th gate ties
# with the (k+1)-th; "top": the two largest tie; "three": three tie
TIES = {"boundary": (3.0, 2.0, 2.0), "top": (2.0, 2.0, 1.0),
        "three": (2.0, 2.0, 2.0)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(TIES))
def test_moe_breaks_ties_to_the_lower_index(kind, dtype, monkeypatch):
    """Gates that tie exactly (equal router columns): the port picks the
    reference's experts, the lower index first, [0, 1] for every token,
    and its output matches (``torch.topk`` is free to pick expert 2)."""
    arch = "deepseek-v2-236b"
    p = _layer(arch, "moe")
    u = np.full((64,), 1.0 / 64, np.float32)
    router = _rand(p["router"].shape, 7, 1e-3)
    for e, scale in enumerate(TIES[kind]):
        router[:, e] = scale * u
    p["router"] = router
    x = _bf16_exact(np.abs(_rand((2, 24, 64), 8)) + 0.5)
    ref, got, jtopi, ttopi, _ = _moe_both(arch, p, x, dtype, monkeypatch)
    logits = _t(x, dtype) @ _t(router, dtype)
    gates = torch.softmax(logits.float(), dim=-1)
    tied = (1, 2) if kind == "boundary" else (0, 1)
    assert torch.equal(gates[..., tied[0]], gates[..., tied[1]])
    assert (jtopi == [0, 1]).all() and (ttopi == [0, 1]).all()
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def test_top_k_lower_first_is_stable():
    """Descending, the lower index first among equals, as
    ``jax.lax.top_k``, on rows with ties everywhere."""
    x = np.random.default_rng(9).integers(0, 4, (50, 16)).astype(np.float32)
    w, i = L.top_k_lower_first(torch.from_numpy(x), 5)
    jw, ji = jax.lax.top_k(jnp.asarray(x), 5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attention", ["torch", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mla_attention_matches_reference(arch, attention):
    """MLA over (2, 20) seeded inputs in f32 (v2: one query projection;
    v3: ``w_dq`` -> ``w_uq``), the attention through the plain chunked
    route and through the flash wrapper (its plain version on the CPU, v
    of 16 dims against q and k of 16 + 8)."""
    cfg, tcfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    p = _layer(arch, "attn")
    assert ("w_dq" in p) == (arch == "deepseek-v3-671b")
    x = _rand((2, 20, 64), 11)
    pos = np.tile(np.arange(20, dtype=np.int32), (2, 1))
    ref = jL.mla_attention({k: _j(v) for k, v in p.items()}, _j(x), cfg,
                           positions=jnp.asarray(pos), chunk=8)
    got = L.mla_attention({k: _t(v) for k, v in p.items()}, _t(x), tcfg,
                          positions=torch.from_numpy(pos), chunk=8,
                          attention=attention)
    np.testing.assert_allclose(got.numpy(), _f32(ref), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_mla_decode_matches_reference_over_steps(arch):
    """Six single-token MLA steps over a latent cache of 8 slots, per-row
    positions apart by two: outputs within F32_TOL and the cache (written
    in place on the port) equal to the reference's returned one."""
    cfg, tcfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    p = _layer(arch, "attn")
    jp, tp = {k: _j(v) for k, v in p.items()}, {k: _t(v) for k, v in
                                                 p.items()}
    r, qr = cfg.kv_lora_rank, cfg.qk_rope_dim
    jc = {"latent": jnp.zeros((2, 8, r)), "k_rope": jnp.zeros((2, 8, qr))}
    tc = {"latent": torch.zeros((2, 8, r)), "k_rope": torch.zeros((2, 8, qr))}
    for t in range(6):
        x = _rand((2, 1, 64), 20 + t)
        pos = np.array([t, t + 2], np.int32)
        ref, jc = jL.mla_decode(jp, _j(x), cfg, jc, pos=jnp.asarray(pos))
        got, tc = L.mla_decode(tp, _t(x), tcfg, tc,
                               pos=torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), _f32(ref), rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=f"step {t}")
        for k in jc:
            np.testing.assert_allclose(tc[k].numpy(), _f32(jc[k]),
                                       rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch):
    """``lm.decode_step`` on the f32 params over the latent cache, four
    greedy steps (the reference's tokens fed to both)."""
    cfg, tcfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    params = P.reference_params(arch)
    tp = P.port_params(params)
    jc = jlm.init_cache(cfg, BATCH, 16, jnp.float32)
    tc = lm.init_cache(tcfg, BATCH, 16, torch.float32, device="cpu")
    step = jax.jit(lambda p, c, tok, pos: jlm.decode_step(
        cfg, p, c, tok, pos, dtype=jnp.float32))
    tok = P.seeded_tokens(tcfg, (BATCH, 1), 12)
    for t in range(STEPS):
        pos = np.full((BATCH,), t, np.int32)
        ref, jc = step(P.jax_params(params), jc, jnp.asarray(tok),
                       jnp.asarray(pos))
        got, tc = lm.decode_step(tcfg, tp, tc, torch.from_numpy(tok).long(),
                                 torch.from_numpy(pos), dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), _f32(ref), rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=f"step {t}")
        tok = np.asarray(jnp.argmax(ref, -1)).astype(np.int32)
    for k in jc:
        np.testing.assert_allclose(tc[k].numpy(), _f32(jc[k]), rtol=F32_TOL,
                                   atol=F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_equals_decode_steps_without_drops(arch):
    """The port's f32 forward over 8 tokens against 8 decode steps from an
    empty latent cache: the capacity is 8 slots per expert, so no pair can
    drop in either, and both compute the same function."""
    tcfg = configs.get_smoke(arch)
    tp = P.port_params(P.reference_params(arch))
    toks = torch.from_numpy(P.seeded_tokens(tcfg, (BATCH, 8), 13)).long()
    full = lm.forward(tcfg, tp, toks, dtype=torch.float32)
    cache = lm.init_cache(tcfg, BATCH, 8, torch.float32, device="cpu")
    for t in range(8):
        lg, cache = lm.decode_step(tcfg, tp, cache, toks[:, t:t + 1],
                                   torch.full((BATCH,), t, dtype=torch.int32),
                                   dtype=torch.float32)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=F32_TOL, atol=F32_TOL)


# ---------------------------------------------------------------------------
# decode at use: the serve step and the cache-less forward
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reference_serve(arch, gqa, kv):
    """The reference's serve step over STEPS greedy steps on the faulted
    tree -> (fed tokens, logits (T, B, V), flags per step)."""
    cfg, plan, _, enc = _model(arch, gqa)
    enc = P._reimport(enc, _faulted_export(arch, gqa))
    step = jax.jit(jprot.make_serve_step(cfg, plan=plan, with_flags=True,
                                         kv_policy=kv, dtype=jnp.float32))
    cache = (jlm.init_cache(cfg, BATCH, 32, jnp.float32) if kv is None
             else jkv.init_cache(cfg, BATCH, 32, kv_policy=kv))
    tok = jnp.zeros((BATCH, 1), jnp.int32)
    fed, logits, flags = [], [], []
    for t in range(STEPS):
        fed.append(np.asarray(tok))
        lg, cache, fl = step(enc, cache, tok, jnp.full((BATCH,), t,
                                                       jnp.int32))
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        logits.append(np.asarray(lg[:, 0]))
        flags.append({k: np.asarray(v) for k, v in fl.items()})
    return fed, np.stack(logits), flags


def _port_serve(arch, gqa, kv, backend, fed):
    cfg = _port_cfg(arch, gqa)
    enc = convert.protected_from_numpy(_faulted_export(arch, gqa),
                                       device="cpu")
    step = protected.make_serve_step(cfg, backend=backend, kv_policy=kv,
                                     dtype=torch.float32)
    cache = kvcache.init_cache(cfg, BATCH, 32, kv_policy=kv,
                               dtype=torch.float32, device="cpu")
    logits, flags = [], []
    for t in range(STEPS):
        lg, cache, fl = step(enc, cache, torch.tensor(fed[t]).long(),
                             torch.full((BATCH,), t, dtype=torch.int32))
        logits.append(lg[:, 0].numpy())
        flags.append({k: v.numpy() for k, v in fl.items()})
    return np.stack(logits), flags


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_faulted_serve_step_matches_reference(arch, backend):
    """The decode-at-use serve step on the faulted tree over the latent
    cache: flags (``top`` and ``layers`` only: every expert leaf and the
    router decode whole each step, each counted) exactly equal at every
    step, logits within F32_TOL."""
    fed, ref_logits, ref_flags = _reference_serve(arch, False, None)
    logits, flags = _port_serve(arch, False, None, backend, fed)
    assert sorted(flags[0]) == ["layers", "top"]
    P.assert_flags_equal(ref_flags, flags)
    assert sum(int(f["layers"].sum()) for f in flags) > 0
    np.testing.assert_allclose(logits, ref_logits, rtol=F32_TOL,
                               atol=F32_TOL)


@functools.lru_cache(maxsize=None)
def _reference_prefill(arch):
    cfg, plan, _, enc = _model(arch)
    enc = P._reimport(enc, _faulted_export(arch))
    toks = P.seeded_tokens(cfg, (BATCH, 64), 4)
    prefill = jax.jit(jprot.make_prefill(cfg, plan=plan, with_flags=True,
                                         dtype=jnp.float32, chunk=16))
    logits, flags = prefill(enc, jnp.asarray(toks))
    return toks, np.asarray(logits), {k: np.asarray(v)
                                      for k, v in flags.items()}


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_at_use_matches_reference(arch, backend, monkeypatch):
    """The cache-less decode-at-use forward over 2 x 64 tokens on the
    faulted tree (capacity 24 per expert: some pairs drop): flags exactly
    equal, logits within F32_TOL; the ``cuda`` route runs MLA's attention
    through the flash wrapper."""
    toks, ref_logits, ref_flags = _reference_prefill(arch)
    cfg = configs.get_smoke(arch)
    tenc = convert.protected_from_numpy(_faulted_export(arch), device="cpu")
    sink = _port_routing(monkeypatch)
    prefill = protected.make_prefill(cfg, backend=backend, with_flags=True,
                                     dtype=torch.float32, chunk=16)
    logits, flags = prefill(tenc, torch.from_numpy(toks).long())
    assert sorted(flags) == ["layers", "top"]
    P.assert_flag_dict_equal(ref_flags,
                             {k: v.numpy() for k, v in flags.items()})
    assert int(flags["layers"].sum()) > 0
    assert len(sink) == cfg.n_layers
    np.testing.assert_allclose(logits.numpy(), ref_logits, rtol=F32_TOL,
                               atol=F32_TOL)


def _rows_routed_alike(jtopi, ttopi):
    """(B, S) rows whose logits no routing difference reaches: the token
    took the same top-k set in every layer, and no earlier token of its
    row took another set in a layer before the last (its changed residual
    reaches the later tokens through the next layer's attention). -> (rows
    bool (B, S), share of (token, layer) pairs routed differently)."""
    flips = np.stack([np.sort(j, -1) != np.sort(t, -1)
                      for j, t in zip(jtopi, ttopi)]).any(-1)   # (L, B, S)
    early = np.cumsum(flips[:-1].any(0), axis=1) > 0            # (B, S)
    return ~(flips.any(0) | early), float(flips.mean())


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_matches_reference_where_routed_alike(arch,
                                                           monkeypatch):
    """The moe family's cases of test_torch_forward's bf16 forward (QAT
    fake-quant on): both packages round the bf16 activations at other
    places, so a token whose k-th and (k+1)-th gates lie within that
    rounding takes another expert in one of them and its logits move by
    O(1). At most BF16_ROUTE_FLIP_SHARE of the (token, layer) pairs may
    route differently; every row no routing difference reaches is held to
    that test's tolerances, and at least three quarters of the rows are
    such rows."""
    cfg, tcfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    p = P.reference_params(arch)
    b = P.token_batch(arch, 2, 24)
    jtopi: list = []
    _spy_top_k(monkeypatch, jtopi)
    ref = jax.jit(lambda p, t: jlm.forward(
        cfg, p, t, wt=jtrain.qat_wt, dtype=jnp.bfloat16, chunk=8))(
        p, b["tokens"])
    jax.effects_barrier()
    sink = _port_routing(monkeypatch)
    got = lm.forward(tcfg, P.port_params(p), torch.from_numpy(b["tokens"]),
                     wt=train.qat_wt, dtype=torch.bfloat16, chunk=8)
    assert len(jtopi) == len(sink) == cfg.n_layers
    rows, share = _rows_routed_alike(jtopi, [t.numpy() for t in sink])
    assert share <= BF16_ROUTE_FLIP_SHARE, share
    assert rows.mean() >= 0.75, rows.mean()
    d = np.abs(_f32(got) - _f32(ref))[rows]
    assert d.max() <= BF16_MAX_ATOL and d.mean() <= BF16_MEAN_ATOL, \
        (d.max(), d.mean(), share)


@pytest.mark.parametrize("arch", ARCHS)
def test_calibrate_act_scales_matches_the_reference(arch):
    """The int8 calibration pass over the moe family (the projections of
    MLA and of the shared experts observe their activations; the router
    and the expert leaves decode whole and observe none, in both) equals
    the reference's scales, as tests/test_torch_int8_serving.py holds the
    dense family's."""
    cfg, _, exported, scales = P.calibrated_model(arch)
    enc = convert.protected_from_numpy(exported, device="cpu")
    toks = torch.from_numpy(P.seeded_tokens(cfg, P.CAL_SHAPE, 3)).long()
    got = protected.calibrate_act_scales(cfg, enc, toks,
                                         plan=P.port_plan(arch),
                                         dtype=torch.float32, chunk=16)
    assert sorted(got) == sorted(scales)
    assert "layers/moe/ws_gate" in got and "layers/attn/w_uk" in got
    assert "layers/moe/router" not in got
    for path in scales:
        np.testing.assert_allclose(got[path], scales[path], rtol=1e-5,
                                   err_msg=path)


# ---------------------------------------------------------------------------
# the moe-GQA branch (use_mla=False)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv,port_kv,backend", [
    (None, None, "torch"), ("in-place", "in-place-fused", "cuda"),
    ("in-place", "in-place", "torch")],
    ids=["dense", "paged-fused", "paged"])
def test_moe_gqa_branch_matches_reference(kv, port_kv, backend):
    """deepseek-v2-236b's smoke config without MLA (GQA, 4 query heads over
    2 KV heads): the faulted serve step on its dense KV cache and on the
    paged in-place KV cache (the port's ``in-place-fused`` preset through
    the kernel wrappers, and its unfused one), against the reference's
    unfused route: flags exactly equal (``layers_kv`` too on the paged
    cache), logits within F32_TOL."""
    arch = "deepseek-v2-236b"
    assert kvcache.supports_paged(_port_cfg(arch, True))
    fed, ref_logits, ref_flags = _reference_serve(arch, True, kv)
    logits, flags = _port_serve(arch, True, port_kv, backend, fed)
    want = ["layers", "top"] + (["layers_kv"] if kv else [])
    assert sorted(flags[0]) == sorted(want)
    P.assert_flags_equal(ref_flags, flags)
    np.testing.assert_allclose(logits, ref_logits, rtol=F32_TOL,
                               atol=F32_TOL)


def test_moe_gqa_paged_prefill_matches_reference():
    """The moe-GQA prefill of 2 x 16 prompt tokens into the paged in-place
    KV cache (``lm.prefill_with_cache``: the MoE after the paged
    attention): flags (``top``, ``layers``, ``layers_kv``) exactly equal,
    logits within F32_TOL."""
    arch = "deepseek-v2-236b"
    cfg, plan, _, enc = _model(arch, True)
    toks = P.seeded_tokens(cfg, (BATCH, 16), 14)
    prefill = jax.jit(jprot.make_prefill(cfg, plan=plan, with_flags=True,
                                         kv_policy="in-place",
                                         dtype=jnp.float32, chunk=8))
    ref, _, ref_flags = prefill(enc, jkv.init_cache(cfg, BATCH, 32,
                                                    kv_policy="in-place"),
                                jnp.asarray(toks))
    tcfg = _port_cfg(arch, True)
    tenc = convert.protected_from_numpy(P.export(enc), device="cpu")
    tpre = protected.make_prefill(tcfg, kv_policy="in-place", with_flags=True,
                                  dtype=torch.float32, chunk=8)
    cache = kvcache.init_cache(tcfg, BATCH, 32, kv_policy="in-place",
                               dtype=torch.float32, device="cpu")
    got, _, flags = tpre(tenc, cache, torch.from_numpy(toks).long())
    P.assert_flag_dict_equal({k: np.asarray(v) for k, v in ref_flags.items()},
                             {k: v.numpy() for k, v in flags.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=F32_TOL,
                               atol=F32_TOL)


# ---------------------------------------------------------------------------
# shapes, conversion, raises, CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,n", [("deepseek-v2-236b", 244_188_410_880),
                                    ("deepseek-v3-671b", 703_797_687_296)])
def test_param_shapes_of_the_full_configs_match_reference(arch, n):
    """The full configs' parameter tree (nothing allocated): the
    reference's ``param_specs`` leaf for leaf, 244.2 G and 703.8 G
    parameters; 160 (256) routed experts of 1,536 (2,048)."""
    cfg = configs.get(arch)
    mine = {tree.path_str(p): tuple(s.shape)
            for p, s in tree.leaves_with_path(lm.param_shapes(cfg))}
    specs = jlm.param_specs(jconfigs.get(arch))
    want = {"/".join(str(getattr(k, "key", k)) for k in path):
            tuple(a.shape)
            for path, a in jax.tree_util.tree_flatten_with_path(specs)[0]}
    assert mine == want
    assert sum(int(np.prod(s)) for s in mine.values()) == n
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    assert mine["layers/moe/we_gate"] == (cfg.n_layers, e, d, f)


@pytest.mark.parametrize("gqa", [False, True], ids=["mla", "gqa"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_shapes_match_reference(arch, gqa):
    """The latent cache ``{"latent": (L, B, S, r), "k_rope": (L, B, S,
    qr)}`` (the K/V cache without MLA) in the reference's shapes and
    dtype, and ``dense_kv_bytes`` counts it as the reference does, at the
    full config too."""
    jcfg, tcfg = _model(arch, gqa)[0], _port_cfg(arch, gqa)
    jc = jlm.init_cache(jcfg, 3, 20)
    tc = lm.init_cache(tcfg, 3, 20, device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in tc.items()} \
        == {k: (tuple(v.shape), str(v.dtype)) for k, v in jc.items()}
    assert sorted(tc) == (["k", "v"] if gqa else ["k_rope", "latent"])
    assert kvcache.dense_kv_bytes(tcfg, 4, 64) == \
        jkv.dense_kv_bytes(jcfg, 4, 64)
    if not gqa:
        full = configs.get(arch)
        assert kvcache.dense_kv_bytes(full, 4, 64) == \
            jkv.dense_kv_bytes(jconfigs.get(arch), 4, 64) == \
            2 * full.n_layers * 4 * 64 * (512 + 64)


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_carries_the_moe_leaves(arch):
    """The reference's encoded tree through its NumPy export into the port:
    every moe leaf (``router``, ``we_*``, ``ws_*``, ``w_dkv``, ``w_uk``,
    ``w_uv`` and v3's ``w_dq``, ``w_uq``) arrives as a ProtectedTensor
    with the reference's bytes, scale and shape; the 3-D expert leaves
    stay 4-D stacked images that slice per layer."""
    enc = _model(arch)[3]
    exported = P.export(enc)
    tenc = convert.protected_from_numpy(exported, device="cpu")
    names = set(tenc["layers"]["moe"]) | set(tenc["layers"]["attn"])
    want = {"router", "we_gate", "we_up", "we_down", "ws_gate", "ws_up",
            "ws_down", "w_dkv", "w_uk", "w_uv", "wo"}
    want |= {"w_dq", "w_uq"} if arch == "deepseek-v3-671b" else {"wq"}
    assert names == want
    for path, leaf in tree.leaves_with_path(tenc["layers"]):
        src = tree.get_path(exported["layers"], path)
        if hasattr(leaf, "enc"):
            assert leaf.enc.numpy().tobytes() == src["enc"].tobytes()
            assert float(leaf.scale) == float(src["scale"])
            assert leaf.orig_shape == tuple(src["orig_shape"])
    we = tenc["layers"]["moe"]["we_down"]
    cfg = configs.get_smoke(arch)
    assert we.enc.ndim == 4 and we.layer(1).orig_shape == (
        cfg.n_experts, cfg.moe_d_ff, cfg.d_model)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_kv_cache_raises_like_reference(arch):
    """MLA serves its latent cache only: both packages raise the same
    ValueError for a paged one; ``serve`` and the CLI raise before any
    work for a paged policy, a prompt and a burst."""
    cfg, jcfg = configs.get_smoke(arch), jconfigs.get_smoke(arch)
    assert not kvcache.supports_paged(cfg) and not jkv.supports_paged(jcfg)
    with pytest.raises(ValueError) as ref:
        jkv.init_cache(jcfg, 2, 32, kv_policy="in-place")
    with pytest.raises(ValueError) as got:
        kvcache.init_cache(cfg, 2, 32, kv_policy="in-place", device="cpu")
    assert str(got.value) == str(ref.value)
    assert "with MLA" in str(got.value)
    for argv in (["--kv-policy", "in-place-fused"],
                 ["--kv-policy", "in-place", "--prompt-len", "8"],
                 ["--burst"]):
        with pytest.raises(ValueError, match="'moe' with MLA"):
            launch_serve.main(["--device", "cpu", "--arch", arch,
                               "--tokens", "1", *argv])
    with pytest.raises(ValueError, match="'moe' with MLA"):
        launch_serve.serve(cfg, device="cpu", tokens=1, prompt_len=8,
                           log=lambda *_: None)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_decodes_on_the_latent_cache_on_cpu(arch, capsys):
    out = launch_serve.main(["--device", "cpu", "--arch", arch,
                             "--tokens", "3", "--batch", "2",
                             "--fault-rate", "1e-3"])
    log = capsys.readouterr().out
    assert f"{arch} (moe," in log
    assert "dense latent cache (k_rope, latent)" in log
    assert out["logits"].shape == (3, 2, 512)
    assert out["flags"]["corrected"] > 0
    assert torch.isfinite(out["logits"]).all()
