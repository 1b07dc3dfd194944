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
