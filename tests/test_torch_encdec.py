"""The encdec family (whisper-base's smoke config) in the port against the
reference: layer norm, the GELU MLP, cross-attention, the cache-less
decode-at-use forward over encoder frames with its per-layer flags (the
encoder's ``"enc_layers"`` row beside the decoder's), ``decode_step`` on
the f32 params, and the serve step over
zero and over encoder-filled cross caches on both of the port's routes,
a QATT step, the parameter and cache shapes, the raises the reference
shares (a paged KV cache, int8 calibration) and both CLIs.

Weights come from the reference's ``lm.init_params`` through NumPy, frame
embeddings from a NumPy seed, rounded to bf16 on the reference's side
first so that both packages get the same values. The forward, its loss and
its gradients over frames are cases of ``test_torch_forward.py``; serve
parity over the zero cross caches (the reference CLI's) on the plain
route is a case of ``test_torch_serve.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as P
from repro import configs as jconfigs
from repro.core import wot as jwot
from repro.models import layers as jL
from repro.models import lm as jlm
from repro.serving import kvcache as jkv
from repro.serving import protected as jprot
from repro.training import optim as joptim
from repro.training import train as jtrain
from repro_torch import configs, convert, tree
from repro_torch.core import wot
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.protection.policy import decode_leaf_with_flags
from repro_torch.protection.tensor import is_protected_tensor
from repro_torch.serving import kvcache
from repro_torch.serving import protected
from repro_torch.training import train

ARCH = "whisper-base"
# f32 on both sides: matmul sums in another order, last-ulp differences of
# exp, tanh and rsqrt (tests/test_torch_serve.py, test_torch_forward.py)
F32_TOL = 1e-4
# bf16 activations rounded at different places by XLA and PyTorch (two
# bf16 ulps at |x| in [2, 4); tests/test_torch_forward.py)
BF16_MAX_ATOL = 0.125
BF16_MEAN_ATOL = 0.02


def _frames(b, seed=5):
    """(b, enc_seq, d_model) frame embeddings: bf16 values as f32."""
    cfg = configs.get_smoke(ARCH)
    x = np.random.default_rng(seed).standard_normal(
        (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, ref, dtype):
    d = np.abs(np.asarray(got, np.float32) - np.asarray(ref, np.float32))
    if dtype == "float32":
        assert d.max() <= F32_TOL, d.max()
    else:
        assert d.max() <= BF16_MAX_ATOL and d.mean() <= BF16_MEAN_ATOL, \
            (d.max(), d.mean())


def _t(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _j(x, dtype):
    return jnp.asarray(x, getattr(jnp, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    """Population variance, eps 1e-5, f32 inside, one cast at the end. An
    offset of 3 per row makes Bessel's correction or an eps of 1e-6 show;
    in bf16 both round the same f32 result once."""
    x = _rand((3, 5, 64), 0) + 3.0
    w, b = _rand((64,), 1), _rand((64,), 2)
    got = L.apply_norm(_t(x, dtype), {"w": torch.from_numpy(w),
                                      "b": torch.from_numpy(b)}, "layer")
    ref = jL.apply_norm(_j(x, dtype), {"w": jnp.asarray(w),
                                       "b": jnp.asarray(b)}, "layer")
    assert got.dtype == getattr(torch, dtype)
    want = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    else:   # one bf16 ulp where the f32 values straddle a rounding edge
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                                   atol=0)
        assert (got.float().numpy() != want).mean() < 0.01


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_reference(dtype):
    """The tanh GELU (jax.nn.gelu's default) with the biases added after
    each projection."""
    cfg = configs.get_smoke(ARCH)
    shapes = L.gelu_mlp_params_shape(cfg)
    p = {k: _rand(s, i + 3, 0.1 if k.startswith("w_") else 0.5)
         for i, (k, s) in enumerate(sorted(shapes.items()))}
    x = _rand((2, 7, cfg.d_model), 9)
    got = L.gelu_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                     _t(x, dtype))
    ref = jL.gelu_mlp({k: jnp.asarray(v) for k, v in p.items()}, _j(x, dtype))
    _close(got.float().numpy(), ref.astype(jnp.float32), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_kv_and_attention_match_reference(dtype):
    """Cross K and V with n_heads heads; every query over every encoder
    position."""
    cfg = configs.get_smoke(ARCH)
    p = {k: _rand(s, i, 0.2) for i, (k, s) in
         enumerate(sorted(L.cross_params_shape(cfg).items()))}
    enc = _rand((2, cfg.enc_seq, cfg.d_model), 11)
    x = _rand((2, 3, cfg.d_model), 12)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tk, tv = L.cross_kv(tp, _t(enc, dtype), cfg)
    jk, jv = jL.cross_kv(jp, _j(enc, dtype), cfg)
    assert tuple(tk.shape) == (2, cfg.enc_seq, cfg.n_heads, cfg.head_dim)
    _close(tk.float().numpy(), jk.astype(jnp.float32), dtype)
    _close(tv.float().numpy(), jv.astype(jnp.float32), dtype)
    # attention over the same K and V on both sides
    kv = (np.array(jk.astype(jnp.float32)), np.array(jv.astype(
        jnp.float32)))
    got = L.cross_attention(tp, _t(x, dtype), tuple(_t(a, dtype) for a in kv),
                            cfg)
    ref = jL.cross_attention(jp, _j(x, dtype), tuple(_j(a, dtype)
                                                     for a in kv), cfg)
    _close(got.float().numpy(), ref.astype(jnp.float32), dtype)


# ---------------------------------------------------------------------------
# decode at use over a faulted encoded tree
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _faulted_model():
    """(cfg, reference plan, clean and faulted reference trees, the
    faulted tree exported)."""
    cfg, plan, _, enc = P._reference_model(ARCH)
    exported = P._flip_exported(P.export(enc), seed=23)
    return cfg, plan, enc, P._reimport(enc, exported), exported


@functools.lru_cache(maxsize=None)
def _reference_prefill():
    cfg, plan, _, jenc, exported = _faulted_model()
    prefill = jprot.make_prefill(cfg, plan=plan, with_flags=True,
                                 dtype=jnp.float32)
    toks = P.seeded_tokens(cfg, (2, 12), 4)
    frames = _frames(2)
    logits, flags = jax.jit(prefill)(jenc, jnp.asarray(toks),
                                     {"enc_embeds": jnp.asarray(frames)})
    return exported, toks, frames, np.asarray(logits), {
        k: np.asarray(v) for k, v in flags.items()}


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_forward_flags_on_a_faulted_tree_match_reference(backend):
    """The cache-less decode-at-use forward over frames: the encoder's
    images decode at use too, so the "enc_layers" row counts their flips
    beside "layers" and "top", exactly as the reference's."""
    exported, toks, frames, ref_logits, ref_flags = _reference_prefill()
    cfg = configs.get_smoke(ARCH)
    enc = convert.protected_from_numpy(exported, device="cpu")
    prefill = protected.make_prefill(cfg, backend=backend, with_flags=True,
                                     dtype=torch.float32)
    logits, flags = prefill(enc, torch.from_numpy(toks).long(),
                            {"enc_embeds": torch.from_numpy(frames)})
    P.assert_flag_dict_equal(ref_flags,
                             {k: v.numpy() for k, v in flags.items()})
    assert sorted(flags) == ["enc_layers", "layers", "top"]
    assert int(flags["enc_layers"].sum()) > 0
    np.testing.assert_allclose(logits.numpy(), ref_logits, rtol=F32_TOL,
                               atol=F32_TOL)


def _port_dense(enc, dtype=torch.float32) -> dict:
    """Every protected leaf of a port tree decoded (as a serve step's
    decode does), the rest as it is."""
    return tree.map_with_path(
        lambda _, t: decode_leaf_with_flags(t, dtype)[0]
        if is_protected_tensor(t) else t, enc)


def _port_cross(cfg, dense, frames):
    """lm._encode on the frames, then layers.cross_kv per decoder layer ->
    (cross_k, cross_v), each (L, B, Se, H, hd)."""
    enc_out = lm._encode(cfg, dense, frames, dtype=torch.float32)[0]
    kv = [L.cross_kv(lm._take(i, dense["layers"])["cross"], enc_out, cfg)
          for i in range(cfg.n_layers)]
    return tuple(torch.stack([p[j] for p in kv]) for j in (0, 1))


def _reference_cross(cfg, jenc, frames):
    dense = jprot.decode_tree(jenc, jnp.float32)
    enc_out = jlm._encode(cfg, dense, jnp.asarray(frames), wt=jlm.Identity,
                          dtype=jnp.float32)[0]
    kv = [jL.cross_kv(jlm._take(i, dense["layers"])["cross"], enc_out, cfg)
          for i in range(cfg.n_layers)]
    return tuple(jnp.stack([p[j] for p in kv]) for j in (0, 1))


@functools.lru_cache(maxsize=None)
def _reference_serve(cross, faulted):
    """The reference's serve step over zero or encoder-filled cross caches
    (the encoder over seeded frames on the clean tree's decoded weights)."""
    cfg, _, clean, jenc, exported = _faulted_model()
    if not faulted:
        jenc, exported = clean, P.export(clean)
    cache = jkv.init_cache(cfg, P.BATCH, P.MAX_LEN, dtype=jnp.float32)
    frames = _frames(P.BATCH, seed=6)
    if cross == "encoder":
        ck, cv = _reference_cross(cfg, clean, frames)
        cache = {**cache, "cross_k": ck, "cross_v": cv}
    step = P._reference_step(ARCH, None, "float32")
    tok = jnp.zeros((P.BATCH, 1), jnp.int32)
    fed, logits, flags = [], [], []
    for t in range(P.STEPS):
        fed.append(np.array(tok))
        lg, cache, fl = step(jenc, cache, tok,
                             jnp.full((P.BATCH,), t, jnp.int32))
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        logits.append(np.asarray(lg[:, 0]))
        flags.append({k: np.asarray(v) for k, v in fl.items()})
    return exported, frames, fed, np.stack(logits), flags


@pytest.mark.parametrize("faulted", [False, True], ids=["clean", "faulted"])
@pytest.mark.parametrize("cross,backend", [
    ("zero", "cuda"), ("encoder", "torch"), ("encoder", "cuda")])
def test_serve_step_over_cross_caches_matches_reference(cross, backend,
                                                         faulted):
    """Dense KV. Zero cross caches (the reference CLI's) make the
    cross-attention add exactly 0, so the encoder-filled caches are what
    hold ``cross_attention`` and the decoder's cross ``wq`` and ``wo`` to
    the reference; both packages fill them from their own ``_encode`` and
    ``cross_kv`` on the same frames and weights, equal within F32_TOL."""
    exported, frames, fed, ref_logits, ref_flags = _reference_serve(
        cross, faulted)
    cfg = configs.get_smoke(ARCH)
    enc = convert.protected_from_numpy(exported, device="cpu")
    cache = kvcache.init_cache(cfg, P.BATCH, P.MAX_LEN, dtype=torch.float32,
                               device="cpu")
    if cross == "encoder":
        clean = convert.protected_from_numpy(
            P.export(_faulted_model()[2]), device="cpu")
        ck, cv = _port_cross(cfg, _port_dense(clean),
                             torch.from_numpy(frames))
        jk, jv = _reference_cross(cfg, _faulted_model()[2], frames)
        for got, want in ((ck, jk), (cv, jv)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=F32_TOL, atol=F32_TOL)
        assert float(ck.abs().max()) > 0.1
        cache["cross_k"].copy_(ck)
        cache["cross_v"].copy_(cv)
    step = protected.make_serve_step(cfg, backend=backend,
                                     dtype=torch.float32)
    logits, flags = [], []
    for t in range(P.STEPS):
        lg, cache, fl = step(enc, cache, torch.from_numpy(fed[t]).long(),
                             torch.full((P.BATCH,), t, dtype=torch.int32))
        logits.append(lg[:, 0].numpy())
        flags.append({k: v.numpy() for k, v in fl.items()})
    P.assert_flags_equal(ref_flags, flags)
    np.testing.assert_allclose(np.stack(logits), ref_logits, rtol=F32_TOL,
                               atol=F32_TOL)
    if faulted:
        assert sum(int(f["layers"][:, 0].sum()) for f in flags) > 0


@pytest.mark.parametrize("cross", ["zero", "encoder"])
def test_decode_step_matches_reference(cross):
    """``lm.decode_step`` on the f32 params (no protection): three steps
    over the dense cache, cross K and V zero or from the encoder (the
    reference's ``_encode`` and ``cross_kv`` on seeded frames, the same
    arrays in both caches), within F32_TOL."""
    cfg, tcfg = jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)
    p = P.reference_params(ARCH)
    jc = jlm.init_cache(cfg, P.BATCH, P.MAX_LEN, jnp.float32)
    if cross == "encoder":
        enc_out = jlm._encode(cfg, P.jax_params(p),
                              jnp.asarray(_frames(P.BATCH, seed=9)),
                              wt=jlm.Identity, dtype=jnp.float32)[0]
        kv = [jL.cross_kv(jlm._take(i, P.jax_params(p)["layers"])["cross"],
                          enc_out, cfg) for i in range(cfg.n_layers)]
        jc = {**jc, "cross_k": jnp.stack([k for k, _ in kv]),
              "cross_v": jnp.stack([v for _, v in kv])}
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    step = jax.jit(lambda p, c, t, pos: jlm.decode_step(
        cfg, p, c, t, pos, dtype=jnp.float32))
    tp = P.port_params(p)
    tok = np.zeros((P.BATCH, 1), np.int32)
    for t in range(P.STEPS):
        pos = np.full((P.BATCH,), t, np.int32)
        ref, jc = step(P.jax_params(p), jc, jnp.asarray(tok), pos)
        got, tc = lm.decode_step(tcfg, tp, tc, torch.from_numpy(tok).long(),
                                 torch.from_numpy(pos),
                                 dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=F32_TOL, atol=F32_TOL)
        tok = np.array(jnp.argmax(ref, axis=-1)).astype(np.int32)


def test_encoder_caches_move_the_logits():
    """The guard of the test above: the same steps over zero and over
    encoder-filled cross caches give different logits."""
    zero = _reference_serve("zero", False)[3]
    filled = _reference_serve("encoder", False)[3]
    assert float(np.abs(zero - filled).max()) > 1e-2


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def test_qatt_step_matches_reference():
    """One f32 QATT step over frames, split into two microbatches, from the
    same params and momentum (test_torch_train.py's tolerances: masters
    2e-6, momentum 2e-5) with the throttle off; then the reference's
    updated masters throttled on both of the port's routes: bit-exact, the
    WOT constraint on every protected leaf."""
    cfg = jconfigs.get_smoke(ARCH).with_(microbatch=2)
    tcfg = configs.get_smoke(ARCH).with_(microbatch=2)
    p = P.reference_params(ARCH)
    m = jax.tree.map(lambda a: (0.01 * np.random.default_rng(a.size)
                                .standard_normal(a.shape)).astype(np.float32),
                     p)
    kw = dict(lr=1e-3, chunk=8, bf16_weights=False, wot_throttle=False)
    jstep = jax.jit(jtrain.make_train_step(
        cfg, loss_fn=lambda p, b: jlm.loss_fn(cfg, p, b, wt=jtrain.qat_wt,
                                              dtype=jnp.float32, chunk=8),
        **kw))
    tstep = train.make_train_step(
        tcfg, loss_fn=lambda p, b: lm.loss_fn(tcfg, p, b, wt=train.qat_wt,
                                              dtype=torch.float32, chunk=8),
        **kw)
    b = {**P.token_batch(ARCH, 4, 16), "enc_embeds": _frames(4, seed=7)}
    jp, jo, jl = jstep(P.jax_params(p), joptim.SgdState(P.jax_params(m)),
                       P.jax_params(b))
    tp, to, tl = tstep(P.port_params(p),
                       convert.sgd_state_from_numpy(m, device="cpu"),
                       {k: torch.from_numpy(v) for k, v in b.items()})
    assert abs(float(tl) - float(jl)) < F32_TOL / 10
    assert P.max_diff(tp, jp) < 2e-6
    assert P.max_diff(to.momentum, jo.momentum) < 2e-5
    jp = jax.tree.map(np.asarray, jp)
    ref = jax.tree.map(np.asarray, jwot.throttle_tree(P.jax_params(jp)))
    for route in ("torch", "cuda"):
        got = wot.throttle_tree(P.port_params(jp), backend=route)
        n = 0
        for path, t in tree.leaves_with_path(got):
            assert t.numpy().tobytes() == tree.get_path(ref, path).tobytes()
            if wot.is_protected_weight(path, t):
                _, q, _ = wot.throttle_tensor(t, with_q=True)
                assert wot.satisfies_constraint(q.reshape(-1)), path
                n += 1
        assert n == 18


# ---------------------------------------------------------------------------
# shapes, raises, CLIs
# ---------------------------------------------------------------------------


def test_param_and_cache_shapes_match_reference():
    """The port's init draws the reference's tree (18 protected leaves:
    the embedding, the head, 10 per decoder layer stack and 6 per encoder
    stack); the dense cache adds cross K and V of n_heads heads over
    enc_seq frames."""
    cfg, jcfg = configs.get_smoke(ARCH), jconfigs.get_smoke(ARCH)
    ref = P.reference_params(ARCH)
    want = {tree.path_str(p): tuple(np.shape(a))
            for p, a in tree.leaves_with_path(ref)}
    mine = lm.init_params(cfg, 0, device="cpu")
    assert want == {tree.path_str(p): tuple(t.shape)
                    for p, t in tree.leaves_with_path(mine)}
    assert want == {tree.path_str(p): tuple(s.shape)
                    for p, s in tree.leaves_with_path(lm.param_shapes(cfg))}
    for path, t in tree.leaves_with_path(mine):
        name = path[-1]
        if name == "b" or name.startswith("b_"):
            assert not bool(t.any()), path
        elif name == "w":
            assert bool((t == 1).all()), path
    assert sum(wot.is_protected_weight(p, t)
               for p, t in tree.leaves_with_path(mine)) == 18
    jc = jlm.init_cache(jcfg, 3, 16)
    tc = lm.init_cache(cfg, 3, 16, device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}
    assert tuple(tc["cross_k"].shape) == (2, 3, 32, 4, 16)


def test_paged_kv_cache_raises_like_reference():
    """The encdec family serves its dense cache only: both packages raise
    the same ValueError for a paged one, and ``supports_paged`` says so."""
    cfg, jcfg = configs.get_smoke(ARCH), jconfigs.get_smoke(ARCH)
    assert not kvcache.supports_paged(cfg) and not jkv.supports_paged(jcfg)
    with pytest.raises(ValueError) as ref:
        jkv.init_cache(jcfg, 2, 32, kv_policy="in-place")
    with pytest.raises(ValueError) as got:
        kvcache.init_cache(cfg, 2, 32, kv_policy="in-place", device="cpu")
    assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError, match="not family 'encdec'"):
        launch_serve.main(["--device", "cpu", "--arch", ARCH, "--tokens", "1",
                           "--kv-policy", "in-place"])


def test_calibration_raises_in_both_packages():
    """The reference calibrates through lm.forward without frames and fails
    (repro/models/lm.py:343); the port raises a ValueError that says so."""
    cfg, plan, _, enc = P._reference_model(ARCH)
    toks = jnp.asarray(P.seeded_tokens(cfg, P.CAL_SHAPE, 3))
    with pytest.raises(AttributeError):
        jprot.calibrate_act_scales(cfg, enc, toks, plan=plan, backend="xla",
                                   dtype=jnp.float32, chunk=16)
    tenc = convert.protected_from_numpy(P.export(enc), device="cpu")
    with pytest.raises(ValueError, match="lm.py:343"):
        protected.calibrate_act_scales(
            configs.get_smoke(ARCH), tenc,
            torch.from_numpy(np.array(toks)).long())


def test_serve_cli_decodes_whisper_on_cpu(capsys):
    out = launch_serve.main(["--device", "cpu", "--arch", ARCH,
                             "--tokens", "2", "--batch", "2",
                             "--fault-rate", "1e-3"])
    log = capsys.readouterr().out
    assert "whisper-base (encdec," in log and "18 tensors protected" in log
    assert out["logits"].shape == (2, 2, 512)
    assert out["flags"]["corrected"] > 0
    assert torch.isfinite(out["logits"]).all()


def test_train_cli_feeds_the_reference_frames_on_cpu(capsys):
    out = launch_train.main(["--device", "cpu", "--arch", ARCH,
                             "--steps", "2", "--batch", "4", "--seq", "16"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert "batch 4 x (32 frames + 16 tokens)" in capsys.readouterr().out
    cfg = configs.get_smoke(ARCH)
    want = np.asarray(jnp.asarray(np.random.default_rng(0).normal(
        size=(4, cfg.enc_seq, cfg.d_model)), jnp.bfloat16).astype(
        jnp.float32))
    got = launch_train.reference_frames(cfg, 4, "cpu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
