"""The hybrid family (recurrentgemma-2b's smoke config) in the port against
the reference's XLA route: the depthwise causal conv, the RG-LRU scan, its
block and its single step; ``gqa_decode`` over a ring of ``window`` slots
across the wrap; ``decode_step`` on the f32 params and the decode-at-use
serve step over 40 steps (the window of 32 wraps) on both of the port's
routes, clean and faulted, with the ``top``, ``layers`` and ``tail`` flags
exactly equal; the cache-less decode-at-use forward at S = 80, longer
than the window, on both routes; the flash kernel's plain version with a
sliding window against ``chunked_causal_attention(window=)`` and an fp64
oracle; the parameter and cache shapes, the raises the reference shares (a
paged KV cache) and the serve CLI.

The smoke config's 6 layers are two super-blocks and no tail, so every
test that must reach the tail runs ``SMOKE.with_(n_layers=8)``: two
super-blocks and two tail RG-LRU layers. Weights come from the
reference's ``lm.init_params`` through NumPy; each reference model and
jitted step is built once per module. On the CPU the ``cuda`` route's
kernel wrappers take their plain versions (the windowed flash kernel
against its plain version on the card is
``test_torch_gpu.py::test_gpu_flash_attention_window_matches_plain``).
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
from repro_torch import configs, convert, tree
from repro_torch.core import wot
from repro_torch.kernels import flash_attention
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.serving import kvcache
from repro_torch.serving import protected

ARCH = "recurrentgemma-2b"
# f32 on both sides: matmul sums in another order, last-ulp differences of
# exp, softplus, sigmoid and tanh, and the RG-LRU's scan, which the port
# sums by doubling where XLA's associative_scan sums odd/even; the
# recurrence is contractive (a < 1), so these stay at f32 noise
F32_TOL = 1e-4
# bf16: XLA keeps elementwise chains in f32 inside a fusion where PyTorch
# rounds every op to bf16, so values differ by a few bf16 ulps (2^-8
# relative each) of an O(1) activation
BF16_RTOL, BF16_ATOL = 2 ** -5, 2 ** -6
# bf16 activations through whole blocks (tests/test_torch_forward.py)
BF16_MAX_ATOL = 0.125
BF16_MEAN_ATOL = 0.02
# flash's plain version against chunked_causal_attention and fp64: the
# same softmax in other tile orders (tests/test_torch_flash_attention.py)
FLASH_F32_TOL = 1e-5
FLASH_BF16_TOL = 1e-2
BATCH, STEPS = 2, 40   # 40 steps from position 0 wrap the smoke ring of 32


def _cfg8(pkg_configs):
    """Two super-blocks and two tail RG-LRU layers."""
    return pkg_configs.get_smoke(ARCH).with_(n_layers=8)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _t(x, dtype="float32"):
    return torch.from_numpy(np.array(x, np.float32)).to(getattr(torch,
                                                                dtype))


def _j(x, dtype="float32"):
    return jnp.asarray(np.asarray(x, np.float32), getattr(jnp, dtype))


def _bf16_exact(x):
    """f32 values that bf16 holds exactly: both packages start from the
    same bf16 inputs."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _close(got, ref, dtype):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL)
    else:
        np.testing.assert_allclose(got, ref, rtol=BF16_RTOL, atol=BF16_ATOL)


def _f32(x):
    return np.asarray(x.astype(jnp.float32))


def _rglru_params(cfg, seed=0):
    """One RG-LRU block's params at the reference's init scales."""
    out = {}
    for i, (name, shp) in enumerate(sorted(L.rglru_params_shape(cfg).items())):
        if name == "a_param":
            out[name] = np.full(shp, 1.3, np.float32)
        elif name == "conv_w":
            out[name] = _rand(shp, seed + i, 0.1)
        else:
            out[name] = _rand(shp, seed + i, 1.0 / np.sqrt(shp[-2]))
    return out


# ---------------------------------------------------------------------------
# the RG-LRU's pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_reference(dtype):
    """Four taps, each reading its shift back, zeros before the start."""
    x = _bf16_exact(_rand((2, 37, 64), 1))
    w = _bf16_exact(_rand((4, 64), 2, 0.1))
    got = L._causal_conv(_t(x, dtype), _t(w))
    ref = jax.jit(jL._causal_conv)(_j(x, dtype), _j(w))
    assert got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), _f32(ref), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [1, 5, 300])
def test_rglru_scan_matches_reference(dtype, length):
    """The doubling scan against ``associative_scan`` over L = 1, 5 (not a
    power of two) and 300 (nine doublings), with a gate range that puts a
    anywhere in (5e-6, 1)."""
    shp = (2, length, 64)
    x = _bf16_exact(_rand(shp, 3))
    ig = _bf16_exact(1 / (1 + np.exp(-_rand(shp, 4))))
    ag = _bf16_exact(_rand(shp, 5, 2.0))
    ap = np.full((64,), 1.3, np.float32)
    got = L._rglru_scan(_t(x, dtype), _t(ig, dtype), _t(ag, dtype),
                        torch.from_numpy(ap))
    ref = jax.jit(jL._rglru_scan)(_j(x, dtype), _j(ig, dtype),
                                  _j(ag, dtype), jnp.asarray(ap))
    assert got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), _f32(ref), dtype)


def test_linear_scan_is_the_recurrence():
    """The doubling scan against the step-by-step loop in f64."""
    rng = np.random.default_rng(6)
    a = rng.uniform(0, 1, (3, 77, 5))
    b = rng.standard_normal((3, 77, 5))
    h, want = np.zeros((3, 5)), []
    for t in range(77):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got = L._linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.stack(want, 1), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_block_matches_reference(dtype):
    cfg = configs.get_smoke(ARCH)
    p = _rglru_params(cfg)
    x = _bf16_exact(_rand((2, 45, cfg.d_model), 7))
    got = L.rglru_block({k: torch.from_numpy(v) for k, v in p.items()},
                        _t(x, dtype), cfg)
    ref = jax.jit(functools.partial(jL.rglru_block,
                                    cfg=jconfigs.get_smoke(ARCH)))(
        {k: jnp.asarray(v) for k, v in p.items()}, _j(x, dtype))
    _close(got.float().numpy(), _f32(ref), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_decode_matches_reference_over_steps(dtype):
    """Six steps carrying ``h`` and the conv history (in ``dtype``, as the
    cache holds them); the port steps its cache in place."""
    cfg, jcfg = configs.get_smoke(ARCH), jconfigs.get_smoke(ARCH)
    p = _rglru_params(cfg, seed=10)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    w = cfg.lru_width
    tc = {"h": torch.zeros((2, w), dtype=getattr(torch, dtype)),
          "conv": torch.zeros((2, 3, w), dtype=getattr(torch, dtype))}
    jc = {"h": jnp.zeros((2, w), getattr(jnp, dtype)),
          "conv": jnp.zeros((2, 3, w), getattr(jnp, dtype))}
    step = jax.jit(functools.partial(jL.rglru_decode, cfg=jcfg))
    for t in range(6):
        x = _bf16_exact(_rand((2, 1, cfg.d_model), 20 + t))
        got, tc2 = L.rglru_decode(tp, _t(x, dtype), cfg, tc)
        ref, jc = step(jp, _j(x, dtype), cache=jc)
        assert tc2 is tc and tc["h"].dtype == getattr(torch, dtype)
        _close(got.float().numpy(), _f32(ref), dtype)
        _close(tc["h"].float().numpy(), _f32(jc["h"]), dtype)
        _close(tc["conv"].float().numpy(), _f32(jc["conv"]), dtype)


@pytest.mark.parametrize("smax,window", [(16, 16), (24, 16)],
                         ids=["smax-eq-window", "smax-gt-window"])
def test_gqa_decode_ring_matches_reference_across_the_wrap(smax, window):
    """40 steps over a ring of ``smax`` slots: the slot ``pos % smax`` and
    the age mask; with ``smax > window`` stale slots stay masked (the
    reference's widened-window fix)."""
    cfg, jcfg = configs.get_smoke(ARCH), jconfigs.get_smoke(ARCH)
    p = {k: _rand(s, i, 0.2) for i, (k, s) in
         enumerate(sorted(L.gqa_params_shape(cfg).items()))}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    shape = (2, smax, cfg.n_kv_heads, cfg.head_dim)
    tc = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    jc = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    step = jax.jit(functools.partial(jL.gqa_decode, cfg=jcfg, window=window))
    for t in range(40):
        x = _rand((2, 1, cfg.d_model), 100 + t)
        pos = np.array([t, max(t - 3, 0)], np.int32)
        got, _ = L.gqa_decode(tp, torch.from_numpy(x), cfg, tc,
                              pos=torch.from_numpy(pos), window=window)
        ref, jc = step(jp, jnp.asarray(x), cache=jc, pos=jnp.asarray(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=F32_TOL, atol=F32_TOL)
        # the same slots written, with K equal to f32 rounding
        np.testing.assert_array_equal((tc["k"] != 0).numpy(),
                                      np.asarray(jc["k"]) != 0)
        np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                                   rtol=F32_TOL, atol=F32_TOL)


# ---------------------------------------------------------------------------
# the model: decode step, serve step and forward with a tail
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reference_model():
    """(cfg, plan, f32 params, encoded tree) at 8 layers: with a tail."""
    cfg = _cfg8(jconfigs)
    params = jax.jit(lambda k: jlm.init_params(cfg, k))(jax.random.PRNGKey(0))
    plan = jprotection.ProtectionPolicy(backend="xla").plan(params)
    return cfg, plan, params, jax.jit(plan.encode_tree)(params)


@functools.lru_cache(maxsize=None)
def _faulted_export():
    _, _, _, enc = _reference_model()
    return P._flip_exported(P.export(enc), seed=29)


def _tokens(t):
    return np.random.default_rng(40 + t).integers(
        0, 512, (BATCH, 1)).astype(np.int32)


def _pos(t):
    return np.full((BATCH,), t, np.int32)


@functools.lru_cache(maxsize=None)
def _reference_serve(faulted):
    """The reference's serve step over STEPS seeded tokens -> (logits
    (T, B, V), flags per step as NumPy)."""
    cfg, plan, _, enc = _reference_model()
    if faulted:
        enc = P._reimport(enc, _faulted_export())
    step = jax.jit(jprot.make_serve_step(cfg, plan=plan, with_flags=True,
                                         dtype=jnp.float32))
    cache = jlm.init_cache(cfg, BATCH, STEPS, jnp.float32)
    logits, flags = [], []
    for t in range(STEPS):
        lg, cache, fl = step(enc, cache, jnp.asarray(_tokens(t)),
                             jnp.asarray(_pos(t)))
        logits.append(np.asarray(lg[:, 0]))
        flags.append({k: np.asarray(v) for k, v in fl.items()})
    return np.stack(logits), flags


@pytest.mark.parametrize("faulted", [False, True], ids=["clean", "faulted"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_serve_step_matches_reference_across_the_ring_wrap(backend,
                                                           faulted):
    """40 decode-at-use steps from position 0 over the ring of 32 slots:
    flags (``top``, ``layers`` and the tail's ``tail``) exactly equal at
    every step, logits within F32_TOL."""
    ref_logits, ref_flags = _reference_serve(faulted)
    _, _, _, enc = _reference_model()
    exported = _faulted_export() if faulted else P.export(enc)
    cfg = _cfg8(configs)
    tenc = convert.protected_from_numpy(exported, device="cpu")
    step = protected.make_serve_step(cfg, backend=backend,
                                     dtype=torch.float32)
    cache = kvcache.init_cache(cfg, BATCH, STEPS, dtype=torch.float32,
                               device="cpu")
    assert tuple(cache["k"].shape)[2] == cfg.attn_window
    logits, flags = [], []
    for t in range(STEPS):
        lg, cache, fl = step(tenc, cache, torch.from_numpy(_tokens(t)).long(),
                             torch.from_numpy(_pos(t)))
        logits.append(lg[:, 0].numpy())
        flags.append({k: v.numpy() for k, v in fl.items()})
    assert sorted(flags[0]) == ["layers", "tail", "top"]
    P.assert_flags_equal(ref_flags, flags)
    if faulted:
        assert sum(int(f["tail"][:, 0].sum()) for f in flags) > 0
        assert sum(int(f["layers"][:, 1].sum()) for f in flags) > 0
    np.testing.assert_allclose(np.stack(logits), ref_logits, rtol=F32_TOL,
                               atol=F32_TOL)


def test_decode_step_matches_reference_on_f32_params():
    """``lm.decode_step`` on the plain f32 params (no decode at use) over
    the wrap: logits and every state of the cache (the ring K/V, the
    RG-LRU states and conv histories, the tail's) within F32_TOL."""
    jcfg, _, params, _ = _reference_model()
    cfg = _cfg8(configs)
    tp = P.port_params(jax.tree.map(np.asarray, params))
    jstep = jax.jit(functools.partial(jlm.decode_step, jcfg,
                                      dtype=jnp.float32))
    jc = jlm.init_cache(jcfg, BATCH, STEPS, jnp.float32)
    tc = lm.init_cache(cfg, BATCH, STEPS, torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}
    for t in range(STEPS):
        ref, jc = jstep(params, jc, jnp.asarray(_tokens(t)),
                        jnp.asarray(_pos(t)))
        got, tc = lm.decode_step(cfg, tp, tc,
                                 torch.from_numpy(_tokens(t)).long(),
                                 torch.from_numpy(_pos(t)),
                                 dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=F32_TOL, atol=F32_TOL)
    for k in jc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=k)


@functools.lru_cache(maxsize=None)
def _reference_prefill():
    cfg, plan, _, enc = _reference_model()
    enc = P._reimport(enc, _faulted_export())
    toks = P.seeded_tokens(cfg, (2, 80), 4)
    prefill = jax.jit(jprot.make_prefill(cfg, plan=plan, with_flags=True,
                                         dtype=jnp.float32))
    logits, flags = prefill(enc, jnp.asarray(toks))
    return toks, np.asarray(logits), {k: np.asarray(v)
                                      for k, v in flags.items()}


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_forward_at_use_past_the_window_matches_reference(backend,
                                                          monkeypatch):
    """The cache-less decode-at-use forward over 80 tokens, longer than the
    window of 32, on a faulted tree: flags (``top``, ``layers``, ``tail``)
    exactly equal, logits within F32_TOL. The ``cuda`` route's local
    attention goes through the flash wrapper with the window (its plain
    version on the CPU), never through the plain chunked attention."""
    toks, ref_logits, ref_flags = _reference_prefill()
    cfg = _cfg8(configs)
    seen = []
    real = flash_attention.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[2], kw.get("window", 0)))
        return real(q, k, v, **kw)
    monkeypatch.setattr(flash_attention, "flash_attention", spy)
    if backend == "cuda":
        monkeypatch.setattr(L, "chunked_causal_attention", None)
    tenc = convert.protected_from_numpy(_faulted_export(), device="cpu")
    prefill = protected.make_prefill(cfg, backend=backend, with_flags=True,
                                     dtype=torch.float32)
    logits, flags = prefill(tenc, torch.from_numpy(toks).long())
    P.assert_flag_dict_equal(ref_flags,
                             {k: v.numpy() for k, v in flags.items()})
    assert sorted(flags) == ["layers", "tail", "top"]
    assert int(flags["tail"].sum()) > 0
    np.testing.assert_allclose(logits.numpy(), ref_logits, rtol=F32_TOL,
                               atol=F32_TOL)
    n = lm.n_scan_layers(cfg)
    assert seen == ([(80, cfg.attn_window)] * n if backend == "cuda" else [])


def test_cuda_route_drops_a_window_that_covers_the_sequence(monkeypatch):
    """At S <= window the window covers every key: the flash wrapper gets
    window 0 (the causal kernel), as the plain route drops it."""
    _, _, params, _ = _reference_model()
    cfg = _cfg8(configs)
    seen = []
    real = flash_attention.flash_attention

    def spy(q, k, v, **kw):
        seen.append(kw.get("window", 0))
        return real(q, k, v, **kw)
    monkeypatch.setattr(flash_attention, "flash_attention", spy)
    tp = P.port_params(jax.tree.map(np.asarray, params))
    toks = torch.from_numpy(P.seeded_tokens(cfg, (2, cfg.attn_window), 5))
    got = lm.forward(cfg, tp, toks.long(), dtype=torch.float32,
                     attention="cuda")
    want = lm.forward(cfg, tp, toks.long(), dtype=torch.float32)
    assert seen == [0] * lm.n_scan_layers(cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_past_the_window_with_tail_matches_reference(dtype):
    """``lm.forward`` on the f32 params at 8 layers (the tail included)
    over 80 tokens: the windowed chunked attention, the RG-LRU scan over
    80 steps and the tail stack."""
    jcfg, _, params, _ = _reference_model()
    cfg = _cfg8(configs)
    toks = P.seeded_tokens(cfg, (2, 80), 6)
    ref = jax.jit(lambda p, t: jlm.forward(
        jcfg, p, t, dtype=getattr(jnp, dtype)))(params, jnp.asarray(toks))
    tp = P.port_params(jax.tree.map(np.asarray, params))
    got = lm.forward(cfg, tp, torch.from_numpy(toks).long(),
                     dtype=getattr(torch, dtype))
    d = np.abs(got.float().numpy() - np.asarray(ref, np.float32))
    if dtype == "float32":
        assert d.max() <= F32_TOL, d.max()
    else:
        assert d.max() <= BF16_MAX_ATOL and d.mean() <= BF16_MEAN_ATOL, \
            (d.max(), d.mean())


def test_calibration_covers_the_tail_like_reference():
    """Static activation scales from the cache-less forward: every
    stacked subtree's leaves, the tail's included, with the reference's
    values (f32, F32_TOL relative)."""
    jcfg, plan, _, enc = _reference_model()
    toks = P.seeded_tokens(jcfg, P.CAL_SHAPE, 3)
    ref = jprot.calibrate_act_scales(jcfg, enc, jnp.asarray(toks), plan=plan,
                                     backend="xla", dtype=jnp.float32,
                                     chunk=16)
    got = protected.calibrate_act_scales(
        _cfg8(configs), convert.protected_from_numpy(P.export(enc),
                                                     device="cpu"),
        torch.from_numpy(toks).long(), dtype=torch.float32, chunk=16)
    assert sorted(got) == sorted(ref)
    assert any(p.startswith("tail/") for p in got)
    for p in ref:
        np.testing.assert_allclose(got[p], float(ref[p]), rtol=F32_TOL,
                                   err_msg=p)


# ---------------------------------------------------------------------------
# flash attention with a sliding window (plain version)
# ---------------------------------------------------------------------------


def _windowed_f64(q, k, v, window):
    q, k, v = (np.asarray(x, np.float64) for x in (q, k, v))
    s = q.shape[2]
    age = np.arange(s)[:, None] - np.arange(s)[None, :]
    sc = q @ k.swapaxes(-1, -2) / np.sqrt(q.shape[-1])
    sc = np.where((age >= 0) & (age < window), sc, -np.inf)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)) @ v


# (S, window): whole tiles; a window that is not a multiple of 64; a
# ragged S; a window shorter than a tile; a window of at least S
WINDOW_CASES = [(256, 64), (200, 100), (300, 128), (130, 20), (96, 96),
                (70, 500)]


@pytest.mark.parametrize("s,window", WINDOW_CASES)
def test_flash_plain_window_matches_chunked_and_f64(s, window):
    rng = np.random.default_rng(s + window)
    q, k, v = (rng.standard_normal((2, 2, s, 16)).astype(np.float32)
               for _ in range(3))
    t = [torch.from_numpy(x) for x in (q, k, v)]
    out = flash_attention.flash_attention(*t, window=window)
    np.testing.assert_allclose(out.numpy(), _windowed_f64(q, k, v, window),
                               rtol=FLASH_F32_TOL, atol=FLASH_F32_TOL)
    cca = L.chunked_causal_attention(*t, chunk=64, window=window)
    np.testing.assert_allclose(out.numpy(), cca.numpy(), rtol=FLASH_F32_TOL,
                               atol=FLASH_F32_TOL)
    if window >= s:   # the window covers every key: the causal result
        np.testing.assert_allclose(
            out.numpy(), flash_attention.flash_attention(*t).numpy(),
            rtol=FLASH_F32_TOL, atol=FLASH_F32_TOL)


@pytest.mark.parametrize("s,window", [(200, 100), (130, 20)])
def test_flash_plain_window_bf16_matches_f64(s, window):
    """bf16 inputs against the fp64 oracle on the same values (the bf16
    chunked attention merges its chunks in bf16, so the oracle is the
    sharper yardstick here)."""
    rng = np.random.default_rng(7 * s)
    t = [torch.from_numpy(rng.standard_normal((1, 2, s, 32)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3)]
    out = flash_attention.flash_attention(*t, window=window)
    assert out.dtype == torch.bfloat16
    want = _windowed_f64(*(x.float().numpy() for x in t), window)
    np.testing.assert_allclose(out.float().numpy(), want, rtol=0,
                               atol=FLASH_BF16_TOL)


def test_flash_plain_window_rejects_a_negative_window():
    x = torch.zeros((1, 1, 8, 16))
    with pytest.raises(ValueError, match="window"):
        flash_attention.flash_attention_plain(x, x, x, window=-1)


# ---------------------------------------------------------------------------
# shapes, raises, CLI
# ---------------------------------------------------------------------------


def test_param_and_cache_shapes_match_reference():
    """The port's init draws the reference's tree with its tail (8 layers:
    2 super-blocks, 2 tail layers), the reference's init values for the
    RG-LRU's ``a_param`` (1.3) and the protected set: the embedding, 25
    leaves of the super-block stack and 9 of the tail (conv kernels
    included, ``a_param`` not); the cache holds the ring of
    ``attn_window`` slots whatever ``max_len`` is, and ``dense_kv_bytes``
    counts it as the reference does."""
    jcfg, _, params, _ = _reference_model()
    cfg = _cfg8(configs)
    want = {tree.path_str(p): tuple(np.shape(a))
            for p, a in tree.leaves_with_path(jax.tree.map(np.asarray,
                                                           params))}
    mine = lm.init_params(cfg, 0, device="cpu")
    assert want == {tree.path_str(p): tuple(t.shape)
                    for p, t in tree.leaves_with_path(mine)}
    assert want == {tree.path_str(p): tuple(s.shape)
                    for p, s in tree.leaves_with_path(lm.param_shapes(cfg))}
    assert bool((mine["tail"]["rg0"]["a_param"] == 1.3).all())
    prot = [tree.path_str(p) for p, t in tree.leaves_with_path(mine)
            if wot.is_protected_weight(p, t)]
    assert len(prot) == 1 + 25 + 9 and "tail/rg0/conv_w" in prot
    assert not any(p.endswith("a_param") for p in prot)
    for max_len in (16, 100):
        jc = jlm.init_cache(jcfg, 3, max_len)
        tc = lm.init_cache(cfg, 3, max_len, device="cpu")
        assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in
                tc.items()} == {k: (tuple(v.shape), str(v.dtype))
                                for k, v in jc.items()}
    for mine_cfg, ref_cfg in ((configs.get(ARCH), jconfigs.get(ARCH)),
                              (cfg, jcfg)):
        assert kvcache.dense_kv_bytes(mine_cfg, 4, 64) == \
            jkv.dense_kv_bytes(ref_cfg, 4, 64)


def test_full_config_shapes():
    """26 layers: 8 super-blocks and 2 tail layers; about 2.89 B
    parameters."""
    cfg = configs.get(ARCH)
    assert lm.n_scan_layers(cfg) == 8 and lm.hybrid_tail_layers(cfg) == 2
    n = sum(int(np.prod(s.shape)) for _, s in
            tree.leaves_with_path(lm.param_shapes(cfg)))
    assert n == jax.tree_util.tree_reduce(
        lambda a, x: a + int(np.prod(x.shape)),
        jlm.param_specs(jconfigs.get(ARCH)), 0)
    assert 2.88e9 < n < 2.90e9


def test_paged_kv_cache_raises_like_reference():
    """The hybrid family serves its dense ring cache only: both packages
    raise the same ValueError for a paged one; ``serve`` raises before any
    work for a paged policy, a prompt, and a burst."""
    cfg, jcfg = configs.get_smoke(ARCH), jconfigs.get_smoke(ARCH)
    assert not kvcache.supports_paged(cfg) and not jkv.supports_paged(jcfg)
    with pytest.raises(ValueError) as ref:
        jkv.init_cache(jcfg, 2, 32, kv_policy="in-place")
    with pytest.raises(ValueError) as got:
        kvcache.init_cache(cfg, 2, 32, kv_policy="in-place", device="cpu")
    assert str(got.value) == str(ref.value)
    for argv in (["--kv-policy", "in-place-chunked"],
                 ["--kv-policy", "in-place", "--prompt-len", "8"],
                 ["--burst"]):
        with pytest.raises(ValueError, match="not family 'hybrid'"):
            launch_serve.main(["--device", "cpu", "--arch", ARCH,
                               "--tokens", "1", *argv])


def test_serve_cli_decodes_recurrentgemma_on_cpu(capsys):
    out = launch_serve.main(["--device", "cpu", "--arch", ARCH,
                             "--tokens", "3", "--batch", "2",
                             "--fault-rate", "1e-3"])
    log = capsys.readouterr().out
    assert "recurrentgemma-2b (hybrid," in log and "tied head" in log
    assert "26 tensors protected" in log
    assert out["logits"].shape == (3, 2, 512)
    assert out["flags"]["corrected"] > 0
    assert torch.isfinite(out["logits"]).all()
