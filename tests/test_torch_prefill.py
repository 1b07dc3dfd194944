"""The port's prefill into the paged protected KV cache, and the decode that
continues from it, against the reference.

Same weights (the reference's ``lm.init_params``), the same fault mask and
the same prompt go through the reference's decode-at-use ``make_prefill``
(XLA route) and the port's. Flags must be exactly equal, and so must the
page tables. In f32 the pages are byte-equal too (the int8 codes agree),
and the per-token scales, ``absmax(K)/127`` of a K that the two packages
sum in another order, agree within ``SCALE_RTOL`` (a few f32 ulps); logits
agree within ``F32_TOL``. In bf16, XLA and PyTorch round activations at
different places (see ``test_torch_serve_bf16.py``), so a K value can move
by a bf16 ulp and its int8 code with it: pages are not compared there,
and the logits get ``BF16_MAX_ATOL``/``BF16_MEAN_ATOL``. Over the 37,888
prefill logits of a smoke model the port is at most 0.086 from the
reference (mean 0.010), while the reference's own bf16 run is 0.16 from its
f32 run. The decode that continues under the chunked kernel's online
softmax is held to the reference's XLA decode within ``CHUNKED_RTOL`` of
the largest logit, the reference's own gate for that kernel.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as P
from repro.core import faults as jfaults
from repro.serving import kvcache as jkv
from repro.serving import protected as jprot
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.kernels import build, paged_attention
from repro_torch.launch import serve
from repro_torch.serving import kvcache as tkv
from repro_torch.serving import protected as tprot

F32_TOL = 1e-4
SCALE_RTOL = 2e-6
BF16_MAX_ATOL = 0.125   # two bf16 ulps at |logit| in [2, 4); |logits| <= 4.2
BF16_MEAN_ATOL = 0.02
CHUNKED_RTOL = 0.02
BATCH, PROMPT, MAX_LEN, STEPS = 2, 37, 48, 3   # 37: a ragged last page
POOL_KEYS = ("k_pages", "v_pages", "k_scale", "v_scale", "kv_table")
# a chunk of one page, so the 40-token decode context spans three chunks
ONE_PAGE_CHUNKS = tkv.KVProtectionPolicy(scheme="in-place", fused=True,
                                         attention_impl="chunked",
                                         chunk_pages=1)


def _prompt(cfg):
    return np.random.default_rng(11).integers(0, cfg.vocab, (BATCH, PROMPT),
                                              dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _reference_prefill_fn(arch, dtype):
    cfg, plan, _, _ = P._reference_model(arch)
    return jax.jit(jprot.make_prefill(cfg, plan=plan, with_flags=True,
                                      kv_policy="in-place",
                                      dtype=getattr(jnp, dtype)))


@functools.lru_cache(maxsize=None)
def reference_prefill(arch, dtype, faulted):
    """-> (exported weights, prompt, logits f32, pools as NumPy, flags)."""
    cfg, _, _, enc = P._reference_model(arch)
    exported = P.export(enc)
    if faulted:
        exported = P._flip_exported(exported, seed=23)
        enc = P._reimport(enc, exported)
    prompt = _prompt(cfg)
    cache = jkv.init_cache(cfg, BATCH, MAX_LEN, kv_policy="in-place")
    logits, cache, flags = _reference_prefill_fn(arch, dtype)(
        enc, cache, jnp.asarray(prompt))
    return (exported, prompt, np.asarray(logits.astype(jnp.float32)),
            {k: np.asarray(cache[k]) for k in POOL_KEYS},
            {k: np.asarray(v) for k, v in flags.items()})


def port_prefill(arch, dtype, exported, prompt, kv, backend):
    cfg = tconfigs.get_smoke(arch)
    enc = convert.protected_from_numpy(exported, device="cpu")
    tdt = getattr(torch, dtype)
    prefill = tprot.make_prefill(cfg, backend=backend, kv_policy=kv,
                                 dtype=tdt, with_flags=True)
    cache = tkv.init_cache(cfg, BATCH, MAX_LEN, kv_policy=kv, device="cpu")
    logits, cache, flags = prefill(enc, cache, torch.from_numpy(prompt).long())
    return enc, logits, cache, flags


@pytest.mark.parametrize("faulted", [False, True], ids=["clean", "faulted"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv,backend", [
    ("in-place", "torch"), ("in-place-chunked", "torch"),
    ("in-place-chunked", "cuda")],
    ids=["in-place", "in-place-chunked", "kernel-route"])
@pytest.mark.parametrize("arch", ["deepseek-7b", "minitron-4b",
                                  "paligemma-3b"])
def test_make_prefill_parity(arch, kv, backend, dtype, faulted):
    """On the ``cuda`` route every kernel wrapper takes its plain version
    here: the flash attention's plain version attends, the codec is the
    plain codec."""
    exported, prompt, ref_logits, ref_pools, ref_flags = reference_prefill(
        arch, dtype, faulted)
    _, logits, cache, flags = port_prefill(arch, dtype, exported, prompt, kv,
                                           backend)
    assert sorted(flags) == sorted(ref_flags)
    for k in ref_flags:
        np.testing.assert_array_equal(flags[k].numpy(), ref_flags[k],
                                      err_msg=k)
    if faulted:
        assert int(flags["layers"][:, 0].sum()) > 0
    np.testing.assert_array_equal(cache["kv_table"].numpy(),
                                  ref_pools["kv_table"])
    if dtype == "float32":
        for k in ("k_pages", "v_pages"):
            np.testing.assert_array_equal(cache[k].numpy(), ref_pools[k],
                                          err_msg=k)
        for k in ("k_scale", "v_scale"):
            np.testing.assert_allclose(cache[k].numpy(), ref_pools[k],
                                       rtol=SCALE_RTOL, atol=0, err_msg=k)
        np.testing.assert_allclose(logits.numpy(), ref_logits, rtol=F32_TOL,
                                   atol=F32_TOL)
    else:
        d = np.abs(logits.float().numpy() - ref_logits)
        assert d.max() <= BF16_MAX_ATOL and d.mean() <= BF16_MEAN_ATOL, \
            (d.max(), d.mean())


@functools.lru_cache(maxsize=None)
def reference_chain(arch, faulted):
    """Reference prefill, then (faulted: a shared fault mask XORed into the
    live pools) ``STEPS`` XLA decode steps of fixed fed tokens."""
    exported, prompt, _, pools, _ = reference_prefill(arch, "float32",
                                                      faulted)
    cfg, _, _, enc = P._reference_model(arch)
    if faulted:
        enc = P._reimport(enc, exported)
        pools = dict(pools)
        for i, k in enumerate(("k_pages", "v_pages")):
            img = pools[k]
            pools[k] = jfaults.inject(img.reshape(-1), 3e-3, 40 + i).reshape(
                img.shape)
    step = P._reference_step(arch, "in-place", "float32")
    cache = {k: jnp.asarray(v) for k, v in pools.items()}
    fed = np.random.default_rng(12).integers(0, cfg.vocab, (STEPS, BATCH, 1),
                                             dtype=np.int32)
    logits, flags = [], []
    for t in range(STEPS):
        lg, cache, fl = step(enc, cache, jnp.asarray(fed[t]),
                             jnp.full((BATCH,), PROMPT + t, jnp.int32))
        logits.append(np.asarray(lg[:, 0].astype(jnp.float32)))
        flags.append({k: np.asarray(v) for k, v in fl.items()})
    return exported, prompt, pools, fed, np.stack(logits), flags


@pytest.mark.parametrize("faulted", [False, True], ids=["clean", "faulted"])
@pytest.mark.parametrize("kv,backend", [
    ("in-place-chunked", "torch"), (ONE_PAGE_CHUNKS, "torch"),
    (ONE_PAGE_CHUNKS, "cuda")],
    ids=["chunked", "one-page-chunks", "kernel-route"])
@pytest.mark.parametrize("arch", ["deepseek-7b", "minitron-4b",
                                  "paligemma-3b"])
def test_prefill_then_chunked_decode_chain(arch, kv, backend, faulted):
    """The port prefills, then decodes under the chunked kernel's plain
    version; the reference prefills and decodes through its XLA route.
    KV and weight flags equal, logits within 2% of the largest."""
    exported, prompt, pools, fed, ref_logits, ref_flags = reference_chain(
        arch, faulted)
    cfg = tconfigs.get_smoke(arch)
    enc, _, cache, _ = port_prefill(arch, "float32", exported, prompt, kv,
                                    backend)
    for k in ("k_pages", "v_pages"):
        cache[k].copy_(torch.from_numpy(np.array(pools[k])))  # shared KV faults
    step = tprot.make_serve_step(cfg, backend=backend, kv_policy=kv,
                                 dtype=torch.float32)
    calls = build.COUNTS["chunked_page_attention"]
    for t in range(STEPS):
        lg, cache, fl = step(enc, cache, torch.from_numpy(fed[t]).long(),
                             torch.full((BATCH,), PROMPT + t,
                                        dtype=torch.int32))
        for k in ref_flags[t]:
            np.testing.assert_array_equal(fl[k].numpy(), ref_flags[t][k],
                                          err_msg=f"step {t} {k}")
        ref = ref_logits[t]
        err = np.abs(lg[:, 0].numpy() - ref).max()
        assert err <= CHUNKED_RTOL * np.abs(ref).max(), (t, err)
    assert build.COUNTS["chunked_page_attention"] == calls  # CPU: no launch
    if faulted:
        assert sum(int(f["layers_kv"][:, 0].sum()) for f in ref_flags) > 0


def test_chunked_policy_routes_decode_through_the_chunked_wrapper(
        monkeypatch):
    """``-chunked`` presets and the serve step's ``attention_impl``
    override reach the chunked kernel's table entry
    (``chunked_page_attention_paged``, which reads the pool through the
    page table) with the policy's chunk."""
    seen = []
    real = paged_attention.chunked_page_attention_paged

    def spy(*a, **kw):
        seen.append(kw["chunk_tokens"])
        return real(*a, **kw)
    monkeypatch.setattr(paged_attention, "chunked_page_attention_paged", spy)
    cfg = tconfigs.get_smoke("minitron-4b")
    from repro_torch.models import lm
    from repro_torch.protection.policy import ProtectionPolicy
    plan = ProtectionPolicy().plan(lm.param_shapes(cfg))
    enc = lm.init_params(cfg, 0, device="cpu", leaf_fn=plan.encode_leaf)
    for kv, impl, want in (("in-place-chunked", None, 256),
                           ("in-place", "chunked", 256),
                           (ONE_PAGE_CHUNKS, None, 16)):
        step = tprot.make_serve_step(cfg, plan=plan, kv_policy=kv,
                                     attention_impl=impl)
        cache = tkv.init_cache(cfg, 2, 16, kv_policy=kv, device="cpu")
        step(enc, cache, torch.zeros((2, 1), dtype=torch.long),
             torch.zeros((2,), dtype=torch.int32))
        assert seen[-cfg.n_layers:] == [want] * cfg.n_layers
    with pytest.raises(ValueError, match="needs a kv_policy"):
        tprot.make_serve_step(cfg, attention_impl="chunked")


def test_make_prefill_raises_on_unported_forms():
    """Every form of ``make_prefill`` is ported: the whole-tree decode
    ablation (``decode_at_use=False``) fills the paged cache as the
    reference's does (pages and tables equal, logits within ``F32_TOL``);
    it refuses ``act_quant`` and ``with_flags`` with the reference's
    ``ValueError``, as the decode-at-use prefill refuses an unknown
    ``act_quant``."""
    arch = "deepseek-7b"
    cfg, plan, _, jenc = P._reference_model(arch)
    prompt = _prompt(cfg)
    jcache = jkv.init_cache(cfg, BATCH, MAX_LEN, kv_policy="in-place")
    ref_logits, ref_cache = jax.jit(jprot.make_prefill(
        cfg, plan=plan, decode_at_use=False, kv_policy="in-place",
        dtype=jnp.float32))(jenc, jcache, jnp.asarray(prompt))
    enc = convert.protected_from_numpy(P.export(jenc), device="cpu")
    for backend in ("torch", "cuda"):
        prefill = tprot.make_prefill(cfg, kv_policy="in-place",
                                     decode_at_use=False, dtype=torch.float32,
                                     backend=backend)
        cache = tkv.init_cache(cfg, BATCH, MAX_LEN, kv_policy="in-place",
                               device="cpu")
        logits, cache = prefill(enc, cache, torch.from_numpy(prompt).long())
        for k in ("k_pages", "v_pages", "kv_table"):
            np.testing.assert_array_equal(cache[k].numpy(),
                                          np.asarray(ref_cache[k]), err_msg=k)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   rtol=F32_TOL, atol=F32_TOL)
    with pytest.raises(ValueError, match="act_quant"):
        tprot.make_prefill(cfg, kv_policy="in-place", decode_at_use=False,
                           act_quant="dynamic")
    with pytest.raises(ValueError, match="with_flags"):
        tprot.make_prefill(cfg, kv_policy="in-place", decode_at_use=False,
                           with_flags=True)
    with pytest.raises(ValueError, match="act_quant"):
        tprot.make_prefill(cfg, kv_policy="in-place", act_quant="sometimes")
    prefill = tprot.make_prefill(cfg, kv_policy="in-place")
    with pytest.raises(ValueError, match="paged cache"):
        prefill({}, {"k": None}, torch.zeros((1, 4), dtype=torch.long))


def test_serve_backend_defaults_to_the_plain_route_on_the_cpu(monkeypatch):
    assert serve.default_backend(torch.device("cpu")) == "torch"
    assert serve.default_backend(torch.device("cuda")) == "cuda"
    lines = []
    res = serve.serve(tconfigs.get_smoke("deepseek-7b"), batch=2, tokens=2,
                      device="cpu", log=lines.append)
    assert "backend=torch" in lines[0] and res["tokens"].shape == (2, 2)
    seen = []
    real = tprot.make_serve_step

    def spy(cfg, **kw):
        seen.append(kw["backend"])
        return real(cfg, **kw)
    monkeypatch.setattr(tprot, "make_serve_step", spy)
    serve.main(["--device", "cpu", "--tokens", "1", "--batch", "1"])
    assert seen == ["torch"]


def test_serve_prefills_a_prompt_then_decodes_from_it():
    """``serve(prompt_len=...)``: the prompt is prefilled, the decode starts
    at its end, and the prefill's weight flags count once more than the
    steps' (each call decodes every block once)."""
    cfg = tconfigs.get_smoke("minitron-4b")
    kw = dict(batch=2, tokens=3, prompt_len=21, kv_policy="in-place-chunked",
              device="cpu", log=lambda *_: None)
    clean = serve.serve(cfg, **kw)
    assert clean["prefill_logits"].shape == (2, 21, cfg.vocab_padded)
    assert clean["logits"].shape == (3, 2, cfg.vocab_padded)
    assert clean["prefill_s"] > 0 and clean["flags"]["corrected"] == 0
    hit = serve.serve(cfg, fault_rate=2e-3, correctable_only=True, **kw)
    n_blocks = sum(p.numel() for p in hit["weight_positions"].values())
    assert n_blocks > 0 and hit["flags"]["corrected"] == 4 * n_blocks
    assert hit["flags"]["due"] == 0 and hit["flags"]["kv_due"] == 0
    assert torch.equal(hit["prefill_logits"], clean["prefill_logits"])
    assert torch.equal(hit["logits"], clean["logits"])
    with pytest.raises(ValueError, match="kv_policy"):
        serve.serve(cfg, tokens=1, prompt_len=4, device="cpu",
                    log=lambda *_: None)


def test_cli_prefills_on_the_cpu(capsys):
    serve.main(["--device", "cpu", "--tokens", "2", "--batch", "2",
                "--prompt-len", "20", "--kv-policy", "in-place-chunked",
                "--backend", "cuda"])
    out = capsys.readouterr().out
    assert "prefilled 2 x 20 prompt tokens" in out and "context up to 22" in out
