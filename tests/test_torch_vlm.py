"""The vlm family (paligemma-3b's smoke config) in the port against the
reference: the forward with an image-patch prefix, the ``sqrt(d_model)``
input scale, the loss over the text positions and its gradients through the
tied embedding, QATT steps, the serve step with faults in the embedding
(the tied head decodes nothing of its own), the converted tree and both
CLIs.

Weights come from the reference's ``lm.init_params`` through NumPy, patch
embeddings from a NumPy seed, rounded to bf16 on the reference's side
first so that both packages get the same values. Serve parity without
embedding-only faults, the prefill into the paged KV cache and the
chunked decode after it, and the guarded int8 serve step of paligemma-3b
are cases of ``test_torch_serve.py``, ``test_torch_serve_bf16.py``,
``test_torch_prefill.py`` and ``test_torch_guarded_serve.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as P
from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.serving import kvcache as jkv
from repro.training import optim as joptim
from repro.training import train as jtrain
from repro_torch import configs, convert, tree
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.training import train

ARCH = "paligemma-3b"
# the tolerances of tests/test_torch_forward.py and test_torch_train.py:
# f32 matmuls summed in another order; bf16 activations rounded at
# different places by XLA and PyTorch
F32_ATOL = 1e-4
BF16_MAX_ATOL = 0.125
BF16_MEAN_ATOL = 0.02
# the serve step in f32 (tests/test_torch_serve.py)
SERVE_F32_TOL = 1e-4


def _prefix(b, seed=2):
    """(b, n_patches, d_model) patch embeddings, bf16 values as f32."""
    cfg = configs.get_smoke(ARCH)
    x = np.random.default_rng(seed).standard_normal(
        (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _batch(b, s, step=0):
    """Tokens, targets and patch embeddings as NumPy."""
    return {**P.token_batch(ARCH, b, s, step=step),
            "prefix_embeds": _prefix(b, seed=2 + step)}


def _jax_batch(b):
    return {k: jnp.asarray(v, jnp.bfloat16 if k == "prefix_embeds" else None)
            for k, v in b.items()}


def _torch_batch(b):
    return {k: torch.from_numpy(v).to(torch.bfloat16 if k == "prefix_embeds"
                                      else None) for k, v in b.items()}


@pytest.mark.parametrize("dtype,qat", [("float32", False), ("float32", True),
                                       ("bfloat16", True)])
def test_forward_with_patch_prefix_matches_reference(dtype, qat):
    """Logits over the P + S positions, and the loss over the last S."""
    cfg, tcfg = jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)
    p = P.reference_params(ARCH)
    b = _batch(2, 24)
    jwt = jtrain.qat_wt if qat else jlm.Identity
    twt = train.qat_wt if qat else L.Identity
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jb, tb = _jax_batch(b), _torch_batch(b)
    ref, jloss = jax.jit(lambda p, b: (
        jlm.forward(cfg, p, b["tokens"], prefix_embeds=b["prefix_embeds"],
                    wt=jwt, dtype=jdt, chunk=8),
        jlm.loss_fn(cfg, p, b, wt=jwt, dtype=jdt, chunk=8)))(p, jb)
    got = lm.forward(tcfg, P.port_params(p), tb["tokens"],
                     prefix_embeds=tb["prefix_embeds"], wt=twt, dtype=tdt,
                     chunk=8)
    assert tuple(got.shape) == (2, cfg.n_patches + 24, cfg.vocab_padded)
    d = np.abs(got.float().numpy() - np.asarray(ref, np.float32))
    if dtype == "float32":
        tol = F32_ATOL
        assert d.max() <= tol, d.max()
    else:
        tol = BF16_MAX_ATOL
        assert d.max() <= tol and d.mean() <= BF16_MEAN_ATOL, \
            (d.max(), d.mean())
    tloss = lm.loss_fn(tcfg, P.port_params(p), tb, wt=twt, dtype=tdt,
                       chunk=8)
    # the loss is a mean over the logits: a tenth of their tolerance
    assert abs(float(tloss) - float(jloss)) < tol / 10


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d_model", [2048, 64])
def test_sqrt_d_model_scale_rounds_as_the_reference(d_model, dtype):
    """The input scale is sqrt(d_model) rounded to the activation dtype
    before the multiply (45.25 in bf16 at paligemma-3b's 2048): an
    all-ones embedding comes out as exactly the reference's scale."""
    cfg = configs.get_smoke(ARCH).with_(d_model=d_model)
    want = float(jnp.asarray(np.sqrt(d_model), getattr(jnp, dtype)))
    x = lm._embed_in(cfg, torch.zeros((1, 3), dtype=torch.long),
                     torch.ones((4, d_model)), getattr(torch, dtype))
    assert x.dtype == getattr(torch, dtype)
    assert torch.all(x == want)
    if (d_model, dtype) == (2048, "bfloat16"):
        assert want == 45.25


def test_loss_gradients_through_the_tied_embedding_match_jax_grad():
    """The embedding's gradient sums the lookup's (raw master) and the
    tied head's (fake-quantized) uses; the patch positions take no loss."""
    cfg, tcfg = jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH)
    p = P.reference_params(ARCH)
    b = _batch(2, 16)
    lfn = lambda p, b: jlm.loss_fn(cfg, p, b, wt=jtrain.qat_wt,
                                   dtype=jnp.float32, chunk=8)
    g_ref = jax.jit(jax.grad(lfn))(p, _jax_batch(b))
    tp = P.port_params(p)
    assert "head" not in tp
    for _, t in tree.leaves_with_path(tp):
        t.requires_grad_()
    lm.loss_fn(tcfg, tp, _torch_batch(b), wt=train.qat_wt,
               dtype=torch.float32, chunk=8).backward()
    for path, t in tree.leaves_with_path(tp):
        r = np.asarray(tree.get_path(g_ref, path))
        # f32 sums in another order, relative to the gradient's scale
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(r).max()),
                                   err_msg="/".join(path))


@pytest.mark.parametrize("bf16", [False, True])
def test_qatt_steps_match_reference(bf16):
    """Three QATT steps (fake-quant, fused momentum, WOT throttle) over
    batches with patch prefixes, split into two microbatches; the
    tolerances of ``test_torch_train.py::test_train_steps_match_reference``
    (f32: masters 2e-6, momentum 2e-5; bf16: 5e-4 and 5e-2)."""
    cfg = jconfigs.get_smoke(ARCH).with_(microbatch=2)
    tcfg = configs.get_smoke(ARCH).with_(microbatch=2)
    p = P.reference_params(ARCH)
    m = jax.tree.map(lambda a: (0.01 * np.random.default_rng(a.size)
                                .standard_normal(a.shape)).astype(np.float32),
                     p)
    kw = dict(lr=1e-3, chunk=8, bf16_weights=bf16)
    if bf16:
        jlfn = tlfn = None
    else:
        jlfn = lambda p, b: jlm.loss_fn(cfg, p, b, wt=jtrain.qat_wt,
                                        dtype=jnp.float32, chunk=8)
        tlfn = lambda p, b: lm.loss_fn(tcfg, p, b, wt=train.qat_wt,
                                       dtype=torch.float32, chunk=8)
    jstep = jax.jit(jtrain.make_train_step(cfg, loss_fn=jlfn, **kw))
    tstep = train.make_train_step(tcfg, loss_fn=tlfn, **kw)
    jp, jo = P.jax_params(p), joptim.SgdState(P.jax_params(m))
    tp, to = P.port_params(p), convert.sgd_state_from_numpy(m, device="cpu")
    tol, mtol = (5e-4, 5e-2) if bf16 else (2e-6, 2e-5)
    for step in range(3):
        b = _batch(4, 16, step=step)
        jp, jo, jl = jstep(jp, jo, _jax_batch(b))
        tp, to, tl = tstep(tp, to, _torch_batch(b))
        assert abs(float(tl) - float(jl)) < (BF16_MAX_ATOL / 10 if bf16
                                             else F32_ATOL / 10)
        assert P.max_diff(tp, jp) < tol, step
        assert P.max_diff(to.momentum, jo.momentum) < mtol, step


def _embedding_faults(exported):
    """One flip in block 0 of the embedding's image and two in block 5
    (corrected and detected at every use); no other image is touched."""
    img = exported["embed"]["enc"].copy()
    flat = img.reshape(-1)
    flat[0] ^= 1 << 3
    flat[40] ^= 1 << 0
    flat[41] ^= 1 << 1
    return {**exported, "embed": {**exported["embed"], "enc": img}}


@functools.lru_cache(maxsize=None)
def _reference_embedding_faults(kv):
    cfg, _, _, enc = P._reference_model(ARCH)
    exported = _embedding_faults(P.export(enc))
    enc = P._reimport(enc, exported)
    step = P._reference_step(ARCH, kv, "float32")
    cache = jkv.init_cache(cfg, P.BATCH, P.MAX_LEN, kv_policy=kv,
                           dtype=jnp.float32)
    tok = jnp.zeros((P.BATCH, 1), jnp.int32)
    fed, logits, flags = [], [], []
    for t in range(P.STEPS):
        fed.append(np.asarray(tok))
        lg, cache, fl = step(enc, cache, tok,
                             jnp.full((P.BATCH,), t, jnp.int32))
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        logits.append(np.asarray(lg[:, 0]))
        flags.append({k: np.asarray(v) for k, v in fl.items()})
    return exported, fed, np.stack(logits), flags


@pytest.mark.parametrize("kv,port_kv,backend", [
    (None, None, "torch"), ("in-place", "in-place", "torch"),
    ("in-place", "in-place-fused", "cuda")],
    ids=["dense-kv", "paged-kv", "kernel-route"])
def test_embedding_faults_land_in_the_top_row_once(kv, port_kv, backend):
    """The tied head is the decoded embedding transposed: the "top" row
    counts the embedding's one corrected and one DUE block once per step,
    exactly as the reference does, and the logits agree in f32."""
    exported, fed, ref_logits, ref_flags = _reference_embedding_faults(kv)
    logits, _, flags = P.port_run(ARCH, port_kv, "float32", exported, fed,
                                  backend=backend)
    P.assert_flags_equal(ref_flags, flags)
    for f in flags:
        np.testing.assert_array_equal(f["top"], [1, 1])
        assert int(np.abs(f["layers"]).sum()) == 0
    np.testing.assert_allclose(logits, ref_logits, rtol=SERVE_F32_TOL,
                               atol=SERVE_F32_TOL)


@pytest.mark.parametrize("arch", [ARCH, "phi3-medium-14b"])
def test_convert_gives_the_reference_tree(arch):
    """The reference's tree carried across has the port's own paths and
    shapes (paligemma-3b: tied, no "head"), as its ``lm.init_params`` and
    ``lm.param_shapes`` draw and describe them."""
    cfg = configs.get_smoke(arch)
    ref = P.port_params(P.reference_params(arch))
    mine = lm.init_params(cfg, 0, device="cpu")
    shapes = lm.param_shapes(cfg)
    assert ("head" in ref) == (not cfg.tie_embeddings)
    want = {tree.path_str(p): tuple(t.shape)
            for p, t in tree.leaves_with_path(ref)}
    assert want == {tree.path_str(p): tuple(t.shape)
                    for p, t in tree.leaves_with_path(mine)}
    assert want == {tree.path_str(p): tuple(s.shape)
                    for p, s in tree.leaves_with_path(shapes)}
    assert all(t.dtype == torch.float32
               for _, t in tree.leaves_with_path(ref))


def test_serve_cli_prefills_and_decodes_paligemma_on_cpu(capsys):
    out = launch_serve.main(["--device", "cpu", "--arch", ARCH,
                             "--prompt-len", "20", "--tokens", "2",
                             "--batch", "2", "--kv-policy",
                             "in-place-chunked", "--fault-rate", "1e-3"])
    log = capsys.readouterr().out
    assert "paligemma-3b (vlm," in log and "tied head" in log
    assert out["prefill_logits"].shape == (2, 20, 512)
    assert out["logits"].shape == (2, 2, 512)
    assert out["flags"]["corrected"] > 0
    assert torch.isfinite(out["logits"]).all()


def test_train_cli_feeds_patch_prefixes_on_cpu(capsys):
    out = launch_train.main(["--device", "cpu", "--arch", ARCH,
                             "--steps", "2", "--batch", "4", "--seq", "16"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert "8 patches + 16 tokens" in capsys.readouterr().out
