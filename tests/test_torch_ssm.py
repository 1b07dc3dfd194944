"""The ssm family (mamba2-2.7b's smoke config) in the port against the
reference's XLA route: the SSD chunked scan at one and three chunks (and
against the plain recurrence in f64), the Mamba2 mixer over a sequence and
its single step, the raise on a length that is not a multiple of the
chunk, ``lm.forward`` against ``lm.decode_step`` from a zero state (the
port's own ``test_prefill_decode_agree``), the decode-at-use serve step
over 16 steps on both of the port's routes, clean and faulted, with the
``top`` and ``layers`` flags exactly equal, the cache-less decode-at-use
forward on both routes, the reference's init values of ``A_log``, ``D``
and ``dt_bias``, the parameter and state-cache shapes, the raises the
reference shares (a paged KV cache) and the serve CLI.

Weights come from the reference's ``lm.init_params`` through NumPy; each
reference model and jitted step is built once per module. On the CPU the
``cuda`` route's kernel wrappers take their plain versions.
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
from repro_torch.kernels import ecc_decode, ecc_qmatmul
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.serving import kvcache
from repro_torch.serving import protected

ARCH = "mamba2-2.7b"
# f32 on both sides: matmul sums in another order and last-ulp differences
# of exp and softplus; the SSD's decays are below one, so these stay at
# f32 noise
F32_TOL = 1e-4
# bf16: the port forms the SSD's 4-operand products pairwise in a stated
# order, rounding each to bf16, where XLA picks its own order and keeps
# elementwise chains in f32 inside a fusion; a few bf16 ulps (2^-8 to 2^-7
# relative each) of values up to |16| (the worst seen: 0.0625 at |y| 11,
# one ulp there)
BF16_RTOL, BF16_ATOL = 2 ** -5, 2 ** -5
# bf16 activations through whole blocks (tests/test_torch_forward.py)
BF16_MAX_ATOL = 0.125
BF16_MEAN_ATOL = 0.02
# the reference's own gate of its prefill/decode agreement
# (tests/test_consistency.py::test_prefill_decode_agree)
AGREE_TOL = 1e-3
BATCH, STEPS = 2, 16
# the reference's A_log is log(linspace(1, 16, h)) in XLA's f32; the port
# takes it in f64 and rounds once, which differs from XLA's f32 log in the
# last two ulps at most
A_LOG_ULPS = 2


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


def _f32(x):
    return np.asarray(x.astype(jnp.float32))


def _close(got, ref, dtype):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL)
    else:
        np.testing.assert_allclose(got, ref, rtol=BF16_RTOL, atol=BF16_ATOL)


def _mixer_params(cfg, seed=0):
    """One Mamba2 mixer's params at the reference's init values."""
    out = {}
    for i, (name, shp) in enumerate(sorted(L.mamba2_params_shape(cfg)
                                           .items())):
        if name == "A_log":
            out[name] = np.log(np.linspace(1, 16, shp[-1])).astype(np.float32)
        elif name == "dt_bias":
            out[name] = np.full(shp, 0.5, np.float32)
        elif name == "D":
            out[name] = np.ones(shp, np.float32)
        elif name == "conv_w":
            out[name] = _rand(shp, seed + i, 0.1)
        else:
            out[name] = _rand(shp, seed + i, 1.0 / np.sqrt(shp[-2]))
    return out


def _ssd_inputs(length, seed, h=4, p=8, n=16):
    """SSD inputs of the reference's ranges: x ~ N(0, 1), dt =
    softplus(N(0, 1) + 0.5) (f32), A = -linspace(1, 16, h) (f32), B and
    C ~ N(0, 1)/2; x, B and C bf16-exact."""
    x = _bf16_exact(_rand((2, length, h, p), seed))
    dt = np.log1p(np.exp(_rand((2, length, h), seed + 1) + 0.5))
    A = -np.linspace(1, 16, h).astype(np.float32)
    B = _bf16_exact(_rand((2, length, n), seed + 2, 0.5))
    C = _bf16_exact(_rand((2, length, n), seed + 3, 0.5))
    return x, dt.astype(np.float32), A, B, C


# ---------------------------------------------------------------------------
# the mixer's pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_chunks", [1, 3])
def test_ssd_chunked_matches_reference(dtype, n_chunks):
    """One chunk (no scan across chunks) and three (the scan carries the
    state twice): y and the final state."""
    chunk = 16
    x, dt, A, B, C = _ssd_inputs(n_chunks * chunk, 10 + n_chunks)
    y, s = L._ssd_chunked(_t(x, dtype), _t(dt), _t(A), _t(B, dtype),
                          _t(C, dtype), chunk)
    jy, js = jax.jit(functools.partial(jL._ssd_chunked, chunk=chunk))(
        _j(x, dtype), _j(dt), _j(A), _j(B, dtype), _j(C, dtype))
    assert y.dtype == s.dtype == getattr(torch, dtype)
    assert tuple(y.shape) == x.shape and tuple(s.shape) == (2, 4, 8, 16)
    _close(y.float().numpy(), _f32(jy), dtype)
    _close(s.float().numpy(), _f32(js), dtype)


def test_ssd_chunked_is_the_recurrence():
    """In f64 the chunked scan equals the step-by-step recurrence
    ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T``, ``y_t = h_t C_t``,
    over three chunks."""
    x, dt, A, B, C = (a.astype(np.float64) for a in _ssd_inputs(48, 3))
    h = np.zeros((2, 4, 8, 16))
    want = []
    for t in range(48):
        da = np.exp(dt[:, t] * A)                                   # (b, h)
        h = h * da[:, :, None, None] + np.einsum(
            "bh,bhp,bn->bhpn", dt[:, t], x[:, t], B[:, t])
        want.append(np.einsum("bhpn,bn->bhp", h, C[:, t]))
    y, s = L._ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, B, C)),
                          16)
    np.testing.assert_allclose(y.numpy(), np.stack(want, 1), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(s.numpy(), h, rtol=1e-10, atol=1e-10)


def test_ssd_chunked_raises_on_a_ragged_length():
    """The reference reshapes by ``l // chunk`` and fails on a length that
    is not a multiple of the chunk; the port says so instead of padding."""
    x, dt, A, B, C = (_t(a) for a in _ssd_inputs(40, 4))
    with pytest.raises(ValueError, match="multiple of its chunk"):
        L._ssd_chunked(x, dt, A, B, C, 16)
    cfg = configs.get_smoke(ARCH)
    tp = P.port_params(P.reference_params(ARCH))
    toks = torch.from_numpy(P.seeded_tokens(cfg, (2, cfg.ssm_chunk + 8), 2))
    with pytest.raises(ValueError, match="multiple of its chunk"):
        lm.forward(cfg, tp, toks.long(), dtype=torch.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [24, 96])
def test_mamba2_block_matches_reference(dtype, s):
    """The mixer over S = 24 (one chunk, cut to S) and 96 (three chunks of
    the smoke config's 32)."""
    cfg = configs.get_smoke(ARCH)
    p = _mixer_params(cfg)
    x = _bf16_exact(_rand((2, s, cfg.d_model), 7))
    got = L.mamba2_block({k: torch.from_numpy(v) for k, v in p.items()},
                         _t(x, dtype), cfg)
    ref = jax.jit(functools.partial(jL.mamba2_block,
                                    cfg=jconfigs.get_smoke(ARCH)))(
        {k: jnp.asarray(v) for k, v in p.items()}, _j(x, dtype))
    assert got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), _f32(ref), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_decode_matches_reference_over_steps(dtype):
    """Eight steps carrying the state and the conv history (in ``dtype``,
    as the cache holds them, rounded every step); the port steps its cache
    in place."""
    cfg, jcfg = configs.get_smoke(ARCH), jconfigs.get_smoke(ARCH)
    p = _mixer_params(cfg, seed=10)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    h, hd, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    c = cfg.d_inner + 2 * n
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tc = {"state": torch.zeros((2, h, hd, n), dtype=tdt),
          "conv": torch.zeros((2, 3, c), dtype=tdt)}
    jc = {"state": jnp.zeros((2, h, hd, n), jdt),
          "conv": jnp.zeros((2, 3, c), jdt)}
    step = jax.jit(functools.partial(jL.mamba2_decode, cfg=jcfg))
    for t in range(8):
        x = _bf16_exact(_rand((2, 1, cfg.d_model), 20 + t))
        got, tc2 = L.mamba2_decode(tp, _t(x, dtype), cfg, tc)
        ref, jc = step(jp, _j(x, dtype), cache=jc)
        assert tc2 is tc and tc["state"].dtype == tdt
        _close(got.float().numpy(), _f32(ref), dtype)
        _close(tc["state"].float().numpy(), _f32(jc["state"]), dtype)
        _close(tc["conv"].float().numpy(), _f32(jc["conv"]), dtype)


# ---------------------------------------------------------------------------
# the model: decode step, forward, serve step
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reference_model():
    cfg = jconfigs.get_smoke(ARCH)
    params = jax.jit(lambda k: jlm.init_params(cfg, k))(jax.random.PRNGKey(0))
    plan = jprotection.ProtectionPolicy(backend="xla").plan(params)
    return cfg, plan, params, jax.jit(plan.encode_tree)(params)


@functools.lru_cache(maxsize=None)
def _faulted_export():
    _, _, _, enc = _reference_model()
    return P._flip_exported(P.export(enc), seed=31)


def _tokens(t):
    return np.random.default_rng(40 + t).integers(
        0, 512, (BATCH, 1)).astype(np.int32)


def _pos(t):
    return np.full((BATCH,), t, np.int32)


def test_forward_agrees_with_decode_steps():
    """``lm.forward`` over S = 64 (two chunks of 32: the scan across
    chunks runs) against 64 ``lm.decode_step`` calls from a zero state,
    in f32, within the reference's 1e-3."""
    cfg = configs.get_smoke(ARCH)
    tp = P.port_params(P.reference_params(ARCH))
    toks = torch.from_numpy(P.seeded_tokens(cfg, (BATCH, 64), 9)).long()
    full = lm.forward(cfg, tp, toks, dtype=torch.float32)
    cache = lm.init_cache(cfg, BATCH, 64, torch.float32, device="cpu")
    outs = []
    for t in range(64):
        lg, cache = lm.decode_step(cfg, tp, cache, toks[:, t:t + 1],
                                   torch.full((BATCH,), t, dtype=torch.int32),
                                   dtype=torch.float32)
        outs.append(lg[:, 0])
    d = (torch.stack(outs, 1) - full).abs().max().item()
    assert d < AGREE_TOL, d


def test_decode_step_matches_reference_on_f32_params():
    """``lm.decode_step`` on the plain f32 params (no decode at use) over
    16 steps: logits, every layer's state and conv history within
    F32_TOL."""
    jcfg, _, params, _ = _reference_model()
    cfg = configs.get_smoke(ARCH)
    tp = P.port_params(jax.tree.map(np.asarray, params))
    jstep = jax.jit(functools.partial(jlm.decode_step, jcfg,
                                      dtype=jnp.float32))
    jc = jlm.init_cache(jcfg, BATCH, STEPS, jnp.float32)
    tc = lm.init_cache(cfg, BATCH, STEPS, torch.float32, device="cpu")
    for t in range(STEPS):
        ref, jc = jstep(params, jc, jnp.asarray(_tokens(t)),
                        jnp.asarray(_pos(t)))
        got, tc = lm.decode_step(cfg, tp, tc,
                                 torch.from_numpy(_tokens(t)).long(),
                                 torch.from_numpy(_pos(t)),
                                 dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=F32_TOL, atol=F32_TOL)
    assert sorted(tc) == sorted(jc) == ["conv", "state"]
    for k in jc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_over_chunks_matches_reference(dtype):
    """``lm.forward`` on the f32 params over S = 96: three chunks of 32."""
    jcfg, _, params, _ = _reference_model()
    cfg = configs.get_smoke(ARCH)
    toks = P.seeded_tokens(cfg, (2, 96), 6)
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


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def spy(*a, **kw):
        calls.append(name)
        return real(*a, **kw)
    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("faulted", [False, True], ids=["clean", "faulted"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_serve_step_matches_reference(backend, faulted, monkeypatch):
    """16 decode-at-use steps from position 0 over the state cache: flags
    (``top`` and ``layers``, no other row) exactly equal at every step,
    logits within F32_TOL. On the ``cuda`` route every projection goes
    through the ``ecc_qmatmul`` wrapper (2 per layer and the head) and the
    embedding and every ``conv_w`` through the ``ecc_decode`` wrapper
    (1 + 1 per layer), each step."""
    ref_logits, ref_flags = _reference_serve(faulted)
    _, _, _, enc = _reference_model()
    exported = _faulted_export() if faulted else P.export(enc)
    cfg = configs.get_smoke(ARCH)
    calls: list = []
    _spy(monkeypatch, ecc_decode, "ecc_decode", calls)
    _spy(monkeypatch, ecc_qmatmul, "ecc_qmatmul", calls)
    tenc = convert.protected_from_numpy(exported, device="cpu")
    step = protected.make_serve_step(cfg, backend=backend,
                                     dtype=torch.float32)
    cache = kvcache.init_cache(cfg, BATCH, STEPS, dtype=torch.float32,
                               device="cpu")
    logits, flags = [], []
    for t in range(STEPS):
        calls.clear()
        lg, cache, fl = step(tenc, cache, torch.from_numpy(_tokens(t)).long(),
                             torch.from_numpy(_pos(t)))
        logits.append(lg[:, 0].numpy())
        flags.append({k: v.numpy() for k, v in fl.items()})
        nl = cfg.n_layers
        want = ({"ecc_decode": 1 + nl, "ecc_qmatmul": 2 * nl + 1}
                if backend == "cuda" else {})
        assert {k: calls.count(k) for k in set(calls)} == want
    assert sorted(flags[0]) == ["layers", "top"]
    P.assert_flags_equal(ref_flags, flags)
    if faulted:
        assert sum(int(f["layers"][:, 0].sum()) for f in flags) > 0
        assert sum(int(f["top"][0]) for f in flags) > 0
    np.testing.assert_allclose(np.stack(logits), ref_logits, rtol=F32_TOL,
                               atol=F32_TOL)


@functools.lru_cache(maxsize=None)
def _reference_prefill():
    cfg, plan, _, enc = _reference_model()
    enc = P._reimport(enc, _faulted_export())
    toks = P.seeded_tokens(cfg, (2, 64), 4)
    prefill = jax.jit(jprot.make_prefill(cfg, plan=plan, with_flags=True,
                                         dtype=jnp.float32))
    logits, flags = prefill(enc, jnp.asarray(toks))
    return toks, np.asarray(logits), {k: np.asarray(v)
                                      for k, v in flags.items()}


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_forward_at_use_matches_reference(backend):
    """The cache-less decode-at-use forward over 64 tokens (two chunks) on
    a faulted tree: flags (``top`` and ``layers``) exactly equal, logits
    within F32_TOL."""
    toks, ref_logits, ref_flags = _reference_prefill()
    cfg = configs.get_smoke(ARCH)
    tenc = convert.protected_from_numpy(_faulted_export(), device="cpu")
    prefill = protected.make_prefill(cfg, backend=backend, with_flags=True,
                                     dtype=torch.float32)
    logits, flags = prefill(tenc, torch.from_numpy(toks).long())
    assert sorted(flags) == ["layers", "top"]
    P.assert_flag_dict_equal(ref_flags,
                             {k: v.numpy() for k, v in flags.items()})
    assert int(flags["layers"].sum()) > 0
    np.testing.assert_allclose(logits.numpy(), ref_logits, rtol=F32_TOL,
                               atol=F32_TOL)


# ---------------------------------------------------------------------------
# init, shapes, raises, CLI
# ---------------------------------------------------------------------------


def test_init_values_of_the_ssm_leaves_match_reference():
    """``A_log`` = log(linspace(1, 16, h)) in every layer (within
    A_LOG_ULPS of XLA's f32), ``D`` one and ``dt_bias`` 0.5 exactly, as
    the reference inits them; at the smoke and the full head count."""
    _, _, params, _ = _reference_model()
    mine = lm.init_params(configs.get_smoke(ARCH), 0, device="cpu")
    for name in ("A_log", "D", "dt_bias"):
        ref = np.asarray(params["layers"]["mixer"][name])
        got = mine["layers"]["mixer"][name].numpy()
        assert got.shape == ref.shape and got.dtype == ref.dtype
        if name == "A_log":
            ulps = np.abs(got - ref) / np.spacing(np.abs(ref) + 1e-30)
            assert ulps.max() <= A_LOG_ULPS, ulps.max()
        else:
            np.testing.assert_array_equal(got, ref, err_msg=name)
    h = configs.get(ARCH).ssm_heads
    ref = np.asarray(jax.jit(lambda: jnp.log(jnp.linspace(1.0, 16.0, h)))())
    got = lm.init_params(configs.get_smoke(ARCH).with_(ssm_head_dim=1,
                                                      d_model=40),
                         0, device="cpu")["layers"]["mixer"]["A_log"][0]
    assert got.shape == (h,)
    ulps = np.abs(got.numpy() - ref) / np.spacing(np.abs(ref) + 1e-30)
    assert ulps.max() <= A_LOG_ULPS, ulps.max()


def test_param_and_cache_shapes_match_reference():
    """The port's init draws the reference's tree; the protected set is
    the embedding, the head, ``w_in``, ``w_out`` and ``conv_w`` (3-D when
    stacked), not ``A_log``, ``D`` or ``dt_bias``; the state cache has the
    reference's keys (``state`` and ``conv``, no ``k`` or ``v``), shapes
    and dtypes whatever ``max_len`` is, and ``dense_kv_bytes`` counts it
    as the reference does, at the full config too (64 layers, batch 4:
    335.5 MB of state and 8.3 MB of conv history in bf16)."""
    jcfg, _, params, _ = _reference_model()
    cfg = configs.get_smoke(ARCH)
    want = {tree.path_str(p): tuple(np.shape(a))
            for p, a in tree.leaves_with_path(jax.tree.map(np.asarray,
                                                           params))}
    mine = lm.init_params(cfg, 0, device="cpu")
    assert want == {tree.path_str(p): tuple(t.shape)
                    for p, t in tree.leaves_with_path(mine)}
    assert want == {tree.path_str(p): tuple(s.shape)
                    for p, s in tree.leaves_with_path(lm.param_shapes(cfg))}
    prot = sorted(tree.path_str(p) for p, t in tree.leaves_with_path(mine)
                  if wot.is_protected_weight(p, t))
    assert prot == ["embed", "head", "layers/mixer/conv_w",
                    "layers/mixer/w_in", "layers/mixer/w_out"]
    for max_len in (16, 100):
        jc = jlm.init_cache(jcfg, 3, max_len)
        tc = lm.init_cache(cfg, 3, max_len, device="cpu")
        assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in
                tc.items()} == {k: (tuple(v.shape), str(v.dtype))
                                for k, v in jc.items()}
    full, jfull = configs.get(ARCH), jconfigs.get(ARCH)
    for mine_cfg, ref_cfg in ((full, jfull), (cfg, jcfg)):
        assert kvcache.dense_kv_bytes(mine_cfg, 4, 64) == \
            jkv.dense_kv_bytes(ref_cfg, 4, 64)
    assert kvcache.dense_kv_bytes(full, 4, 64) == \
        2 * 64 * 4 * (80 * 64 * 128 + 3 * 5376)


def test_full_config_shapes():
    """64 layers of one mixer each; ``w_in`` 2,560 -> 10,576 ([x, z, B, C,
    dt]: 5,120 + 5,120 + 128 + 128 + 80), the vocabulary padded to 50,304;
    about 2.7 B parameters, the reference's count."""
    cfg = configs.get(ARCH)
    shapes = lm.param_shapes(cfg)
    assert shapes["layers"]["mixer"]["w_in"].shape == (64, 2560, 10576)
    assert shapes["layers"]["mixer"]["conv_w"].shape == (64, 4, 5376)
    assert shapes["embed"].shape == (50304, 2560)
    n = sum(int(np.prod(s.shape)) for _, s in tree.leaves_with_path(shapes))
    assert n == jax.tree_util.tree_reduce(
        lambda a, x: a + int(np.prod(x.shape)),
        jlm.param_specs(jconfigs.get(ARCH)), 0)
    assert 2.6e9 < n < 2.9e9


def test_paged_kv_cache_raises_like_reference():
    """The ssm family serves its state cache only: both packages raise the
    same ValueError for a paged one; ``serve`` raises before any work for
    a paged policy, a prompt, and a burst."""
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
        with pytest.raises(ValueError, match="not family 'ssm'"):
            launch_serve.main(["--device", "cpu", "--arch", ARCH,
                               "--tokens", "1", *argv])
    with pytest.raises(ValueError, match="not family 'ssm'"):
        launch_serve.serve(cfg, device="cpu", tokens=1, prompt_len=8,
                           log=lambda *_: None)


def test_serve_cli_decodes_mamba2_on_cpu(capsys):
    out = launch_serve.main(["--device", "cpu", "--arch", ARCH,
                             "--tokens", "3", "--batch", "2",
                             "--fault-rate", "1e-3"])
    log = capsys.readouterr().out
    assert "mamba2-2.7b (ssm," in log and "own head" in log
    assert "5 tensors protected" in log
    assert "dense state cache (conv, state)" in log
    assert out["logits"].shape == (3, 2, 512)
    assert out["flags"]["corrected"] > 0
    assert torch.isfinite(out["logits"]).all()
