"""The port's cache-less forward (``lm.forward``), its loss and the
loss's gradients against the reference, in f32 and bf16, with and without
QAT's fake-quant, at the smoke sizes of every ported arch: deepseek-7b,
minitron-4b and phi3-medium-14b (GQA), qwen1.5-4b (qkv biases) and
paligemma-3b (the vlm family: the sqrt(d_model) input scale and a tied
head; its image-patch prefix is in tests/test_torch_vlm.py) and
whisper-base (the encdec family: layer norms, a bidirectional encoder over
frame embeddings, cross-attention and the GELU MLP; the frames are bf16
values from a NumPy seed). Weights come from the reference's
``lm.init_params`` through NumPy, tokens from ``synthetic.token_batch``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.training import train as jtrain
from repro_torch import configs, tree
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.training import train

import torch_parity as P
from torch_parity import ARCHS

# XLA and PyTorch sum the f32 matmuls in different orders
F32_ATOL = 1e-4
# bf16 activations: the two frameworks round them at different places
# (as in tests/test_torch_prefill.py: two bf16 ulps at |logit| in [2, 4),
# and a mean well under one)
BF16_MAX_ATOL = 0.125
BF16_MEAN_ATOL = 0.02

_ref_params, _port = P.reference_params, P.port_params


def _batch(arch, b, s, step=0):
    """Tokens and targets; for the encdec family also (b, enc_seq,
    d_model) frame embeddings, bf16 values as f32."""
    out = P.token_batch(arch, b, s, step=step)
    cfg = configs.get_smoke(arch)
    if cfg.family == "encdec":
        x = np.random.default_rng(8 + step).standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        out["enc_embeds"] = np.array(jnp.asarray(x, jnp.bfloat16).astype(
            jnp.float32))
    return out


# the moe family's bf16 case is tests/test_torch_moe.py's
# test_bf16_forward_matches_reference_where_routed_alike: a token whose
# k-th and (k+1)-th gates lie within a bf16 rounding routes to another
# expert in one package, and its logits move by O(1) there
FORWARD_CASES = [(a, dtype, qat) for dtype, qat in [
    ("float32", False), ("float32", True), ("bfloat16", True)]
    for a in ARCHS
    if dtype == "float32" or configs.get_smoke(a).family != "moe"]


@pytest.mark.parametrize("arch,dtype,qat", FORWARD_CASES, ids=[
    f"{d}-{q}-{a}" for a, d, q in FORWARD_CASES])
def test_forward_and_loss_match_reference(arch, dtype, qat):
    """minitron-4b smoke is GQA, qwen1.5-4b smoke has qkv biases; all three
    configs remat. Fake-quant scales each layer's slice (two layers)."""
    cfg, tcfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    p = _ref_params(arch)
    b = _batch(arch, 2, 24)
    jwt = jtrain.qat_wt if qat else jlm.Identity
    twt = train.qat_wt if qat else L.Identity
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref, jloss = jax.jit(lambda p, b: (
        jlm.forward(cfg, p, b["tokens"], enc_embeds=b.get("enc_embeds"),
                    wt=jwt, dtype=jdt, chunk=8),
        jlm.loss_fn(cfg, p, b, wt=jwt, dtype=jdt, chunk=8)))(p, b)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    got = lm.forward(tcfg, _port(p), tb["tokens"],
                     enc_embeds=tb.get("enc_embeds"), wt=twt, dtype=tdt,
                     chunk=8)
    d = np.abs(got.float().numpy() - np.asarray(ref, np.float32))
    if dtype == "float32":
        tol = F32_ATOL
        assert d.max() <= tol, d.max()
    else:
        tol = BF16_MAX_ATOL
        assert d.max() <= tol and d.mean() <= BF16_MEAN_ATOL, \
            (d.max(), d.mean())
    tloss = lm.loss_fn(tcfg, _port(p), tb, wt=twt, dtype=tdt, chunk=8)
    # the loss is a mean over the logits: a tenth of their tolerance
    assert abs(float(tloss) - float(jloss)) < tol / 10


@pytest.mark.parametrize("arch", ["minitron-4b", "qwen1.5-4b",
                                  "whisper-base"])
def test_loss_gradients_match_jax_grad(arch):
    cfg, tcfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    p = _ref_params(arch)
    b = _batch(arch, 2, 16)
    lfn = lambda p, b: jlm.loss_fn(cfg, p, b, wt=jtrain.qat_wt,
                                   dtype=jnp.float32, chunk=8)
    g_ref = jax.jit(jax.grad(lfn))(p, b)
    tp = _port(p)
    for _, t in tree.leaves_with_path(tp):
        t.requires_grad_()
    lm.loss_fn(tcfg, tp, {k: torch.from_numpy(v) for k, v in b.items()},
               wt=train.qat_wt, dtype=torch.float32, chunk=8).backward()
    for path, t in tree.leaves_with_path(tp):
        r = np.asarray(tree.get_path(g_ref, path))
        # f32 sums in another order, relative to the gradient's scale
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(r).max()),
                                   err_msg="/".join(path))
