"""Rules the port keeps: it imports neither JAX nor the reference, its entry
points default to the card and never carry on on the CPU unasked, its
copied configs equal the reference's, and its kernel wrappers take their
plain versions only for tensors on the CPU."""
import ast
import dataclasses
from pathlib import Path

import pytest
import torch

from repro import configs as jconfigs
from repro_torch import configs, device
from repro_torch.kernels import (ecc_decode, ecc_encode, ecc_qmatmul,
                                 flash_attention, ops, paged_attention,
                                 quant_throttle, throttle)
from repro_torch.launch import serve
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from repro_torch.serving import frontend, kvcache

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_scan_covers_the_kernel_modules():
    scanned = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for name in ("ref", "ops", "ecc_qmatmul", "build"):
        assert f"src/repro_torch/kernels/{name}.py" in scanned
    for name in ("frontend", "telemetry", "kvcache", "protected"):
        assert f"src/repro_torch/serving/{name}.py" in scanned


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_the_reference(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path}: imports {bad}"


def test_entry_points_default_to_cuda_and_raise_without_a_gpu(monkeypatch):
    assert device.DEFAULT_DEVICE == "cuda"
    assert device.resolve("cpu").type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_smoke("deepseek-7b")
    for call in (lambda: device.resolve(None),
                 lambda: lm.init_params(cfg),
                 lambda: lm.init_cache(cfg, 1, 16),
                 lambda: kvcache.init_cache(cfg, 1, 16, kv_policy="in-place"),
                 lambda: serve.serve(cfg, tokens=1, log=lambda *_: None),
                 lambda: serve.main(["--tokens", "1"]),
                 lambda: serve.burst(cfg, log=lambda *_: None),
                 lambda: serve.main(["--burst"]),
                 lambda: frontend.ServingFrontend(cfg, {}),
                 lambda: frontend.run_burst(cfg, {}, waves=[]),
                 lambda: launch_train.train(cfg, steps=1,
                                            log=lambda *_: None),
                 lambda: launch_train.main(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_healing_entry_points_default_to_cuda(monkeypatch):
    """The serve CLI's mixed-scheme and self-healing flags and the burst
    grid (``benchmarks.burst_sim``) default to the card: without a GPU
    each raises."""
    from repro_torch.benchmarks import burst_sim
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_smoke("deepseek-7b")
    for call in (lambda: serve.main(["--tokens", "1", "--policy",
                                     "attn-inplace-mlp-secded",
                                     "--scrub-every", "1", "--repair"]),
                 lambda: serve.main(["--burst", "--scrub-every", "1"]),
                 lambda: serve.serve(cfg, tokens=1, scrub_every=1,
                                     repair=True, log=lambda *_: None),
                 lambda: burst_sim.main(["--smoke"]),
                 lambda: burst_sim.run_grid(
                     cfg, {}, None, [], kv_policies=["in-place"],
                     fault_rates=[0.0], slots=2, max_len=16, n_pages=None,
                     seed=0, log=lambda *_: None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "paligemma-3b",
                                  "whisper-base", "mamba2-2.7b",
                                  "deepseek-v2-236b", "deepseek-v3-671b"])
def test_entry_points_of_every_family_default_to_cuda(arch, monkeypatch):
    """The entry points with ``--arch`` (and their functions on the arch's
    config) default to the card for the GQA 40/10 dense model, the vlm,
    the encdec, the ssm and the moe families too: without a GPU each
    raises, none carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_smoke(arch)
    for call in (lambda: lm.init_params(cfg),
                 lambda: lm.init_cache(cfg, 1, 16),
                 lambda: kvcache.init_cache(cfg, 1, 16,
                                            kv_policy="in-place-chunked"),
                 lambda: serve.serve(cfg, tokens=1, prompt_len=16,
                                     kv_policy="in-place-chunked",
                                     log=lambda *_: None),
                 lambda: serve.main(["--arch", arch, "--tokens", "1"]),
                 lambda: serve.main(["--arch", arch, "--burst"]),
                 lambda: launch_train.train(cfg, steps=1,
                                            log=lambda *_: None),
                 lambda: launch_train.main(["--arch", arch, "--steps", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_port_has_every_arch_and_family_of_the_reference():
    """The port serves every arch of ``repro.configs.ARCH_IDS``, and its
    model knows every family they use."""
    assert sorted(configs.ARCH_IDS) == sorted(jconfigs.ARCH_IDS)
    assert {jconfigs.get(a).family for a in jconfigs.ARCH_IDS} <= \
        set(lm.FAMILIES)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_copied_configs_equal_the_reference(arch):
    for mine, ref in ((configs.get(arch), jconfigs.get(arch)),
                      (configs.get_smoke(arch), jconfigs.get_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.vocab_padded == ref.vocab_padded


def _leaves(x) -> list:
    """The tensors of a nested tuple, in order."""
    if isinstance(x, tuple):
        return [t for e in x for t in _leaves(e)]
    return [x]


def test_wrappers_take_the_plain_route_for_cpu_tensors(monkeypatch):
    """On a CPU tensor each wrapper returns exactly its plain version and
    never reaches the kernel build or the launch counters."""
    from repro_torch.kernels import build

    def no_build(*_a, **_k):
        raise AssertionError("a CPU tensor reached the CUDA kernel path")
    monkeypatch.setattr(build, "entry", no_build)
    before = dict(build.COUNTS)
    g = torch.Generator().manual_seed(0)
    blocks = torch.randint(0, 256, (64, 8), generator=g, dtype=torch.uint8)
    for wrapped, plain in ((ecc_decode.ecc_decode, ecc_decode.ecc_decode_plain),
                           (ecc_encode.ecc_encode, ecc_encode.ecc_encode_plain)):
        got, want = wrapped(blocks), plain(blocks)
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    a = torch.randn(3, 16, generator=g)
    w = blocks.reshape(16, 32)
    s = torch.tensor(0.01)
    out, fl = ecc_qmatmul.ecc_qmatmul(a, w, s, with_flags=True)
    pout, pfl = ecc_qmatmul.ecc_qmatmul_plain(a, w, s, with_flags=True)
    assert torch.equal(out, pout) and torch.equal(fl, pfl)
    # every other path of the fused matmul: raw int8, requantize (scalar
    # and per-row scale, bias, out_dtype), ABFT, clamp, fault_bits
    aq = torch.randint(-127, 128, (3, 16), generator=g, dtype=torch.int8)
    rows = torch.rand(3, generator=g)
    bias = torch.randint(-99, 99, (32,), generator=g, dtype=torch.int32)
    for args, kw in (((aq, w), {}),
                     ((aq, w), dict(with_abft=True, fault_bits=1 << 9)),
                     ((aq, w, s), dict(a_scale=rows, bias=bias,
                                       with_flags=True)),
                     ((aq, w, s), dict(a_scale=s, out_dtype=torch.float16,
                                       clamp=0.5, with_abft=True)),
                     ((a, w, s), dict(with_abft=True, clamp=0.1,
                                      fault_bits=1 << 27))):
        got = ecc_qmatmul.ecc_qmatmul(*args, **kw)
        want = ecc_qmatmul.ecc_qmatmul_plain(*args, **kw)
        got, want = _leaves(got), _leaves(want)
        assert len(got) == len(want) and all(
            x.dtype == y.dtype and torch.equal(x, y)
            for x, y in zip(got, want))
    assert torch.equal(ops.qmatmul_protected(aq, w, s, s),
                       ecc_qmatmul.ecc_qmatmul_plain(aq, w).float() * (s * s))
    q = torch.randn(2, 2, 1, 8, generator=g)
    ke = torch.randint(0, 256, (2, 16, 2, 8), generator=g, dtype=torch.uint8)
    sc = torch.rand(2, 16, generator=g)
    pos = torch.tensor([3, 15])
    o, f = paged_attention.fused_page_attention(q, ke, None, sc, ke, None, sc,
                                                pos)
    po, pf = paged_attention.fused_page_attention_plain(q, ke, None, sc, ke,
                                                        None, sc, pos)
    assert torch.equal(o, po) and torch.equal(f, pf)
    o, f = paged_attention.chunked_page_attention(q, ke, None, sc, ke, None,
                                                  sc, pos, chunk_tokens=8)
    po, pf = paged_attention.chunked_page_attention_plain(
        q, ke, None, sc, ke, None, sc, pos, chunk_tokens=8)
    assert torch.equal(o, po) and torch.equal(f, pf)
    # the parity-zero scheme over check strips, per-slot rows
    ch = torch.randint(0, 256, (2, 16, 2, 1), generator=g, dtype=torch.uint8)
    pz = (q, ke, ch, sc, ke, ch, sc, pos)
    for wrapped, plain, kw in (
            (paged_attention.fused_page_attention,
             paged_attention.fused_page_attention_plain, {}),
            (paged_attention.chunked_page_attention,
             paged_attention.chunked_page_attention_plain,
             dict(chunk_tokens=8))):
        o, f = wrapped(*pz, scheme="parity-zero", per_slot=True, **kw)
        po, pf = plain(*pz, scheme="parity-zero", per_slot=True, **kw)
        assert torch.equal(o, po) and torch.equal(f, pf)
        assert tuple(f.shape) == (2, 2)
    # the table entries over a pool (4 pages of 8 tokens) and a page table
    table = torch.tensor([[3, 0], [1, 3]], dtype=torch.int32)
    pool = (ke.reshape(4, 8, 2, 8), None, sc.reshape(4, 8),
            ke.reshape(4, 8, 2, 8), None, sc.reshape(4, 8))
    for wrapped, plain in (
            (paged_attention.fused_page_attention_paged,
             paged_attention.fused_page_attention_paged_plain),
            (paged_attention.chunked_page_attention_paged,
             paged_attention.chunked_page_attention_paged_plain)):
        o, f = wrapped(q, *pool, table, pos, per_slot=True)
        po, pf = plain(q, *pool, table, pos, per_slot=True)
        assert torch.equal(o, po) and torch.equal(f, pf)
    x = torch.randn(1, 2, 20, 8, generator=g)
    assert torch.equal(flash_attention.flash_attention(x, x, x),
                       flash_attention.flash_attention_plain(x, x, x))
    w = torch.randn(13, 8, generator=g)
    got, want = (quant_throttle.quantize_throttle(w),
                 quant_throttle.quantize_throttle_plain(w))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    qb = blocks.view(torch.int8)
    assert torch.equal(throttle.throttle(qb), throttle.throttle_plain(qb))
    assert build.COUNTS == before


def test_campaign_entry_points_default_to_cuda(monkeypatch):
    """The fault campaigns, the serve CLI's smoke-check and the Table-2
    column default to the card: without a GPU each raises, even over a
    tree that sits on the CPU, unless it is given ``device="cpu"``."""
    from repro_torch.protection import campaign
    from repro_torch.training import cnn_experiments as ce
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = {"fc": {"w": torch.randn(16, 8)}}
    fwd = lambda p, x: x.reshape(x.shape[0], -1)[:, :16] @ p["fc"]["w"]  # noqa: E731
    kw = dict(rates=(1e-3,), trials=1)
    for call in (
            lambda: campaign.run_campaign(params, fwd, None, "in-place",
                                          img=8, **kw),
            lambda: campaign.run_campaign_host(params, fwd, None, "in-place",
                                               img=8, **kw),
            lambda: campaign.fidelity_campaign(params, **kw),
            lambda: campaign.due_campaign(params, **kw),
            lambda: campaign.compute_campaign(params, **kw),
            lambda: serve.fault_smoke_check(params, None, 1e-4, 0,
                                            log=lambda *_: None),
            lambda: ce.run_scheme_campaign(params, lambda p, x, wt=None:
                                           fwd(p, x), None, "in-place",
                                           img=8, **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert campaign.fidelity_campaign(params, device="cpu", **kw).grid


def test_training_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """The checkpoint save, restore and async checkpointer, the
    checkpointed train CLI and the ADMM-vs-QATT benchmark default to the
    card: without a GPU each raises unless it is given ``device="cpu"``."""
    from repro_torch.benchmarks import wot_admm_compare
    from repro_torch.training import checkpoint
    t = {"w": torch.ones(4, 8)}
    checkpoint.save(str(tmp_path), t, step=1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: checkpoint.save(str(tmp_path), t, step=2),
                 lambda: checkpoint.save(str(tmp_path), t, step=2,
                                         protected=True),
                 lambda: checkpoint.AsyncCheckpointer(str(tmp_path)),
                 lambda: checkpoint.restore(str(tmp_path), t),
                 lambda: launch_train.main(["--steps", "1", "--ckpt",
                                            str(tmp_path)]),
                 lambda: wot_admm_compare.run(steps=1, pre_steps=1),
                 lambda: wot_admm_compare.main(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    got, step = checkpoint.restore(str(tmp_path), t, device="cpu")
    assert step == 1 and torch.equal(got["w"], t["w"])
