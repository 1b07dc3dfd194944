"""The port's kernel micro-benchmarks and its autotune artifact
(``repro_torch.benchmarks.kernel_bench``, the reference's
``benchmarks/kernel_bench.py``) on the CPU: the CLI's rows, the
``bench_kernels/v6`` payload round-tripped through the port's
``AutotuneTable``, and a serve routed by it. ``test_torch_gpu.py`` runs
the same benchmark on the card, where every kernel is held to its plain
version (``bitexact``) and the chunked kernel to the fp64 oracle
(``within_tol``)."""
import json

import pytest
import torch

from repro_torch import configs, tree
from repro_torch.benchmarks import kernel_bench as kb
from repro_torch.kernels import ecc_qmatmul, paged_attention
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.protection import BACKENDS, AutotuneTable, ProtectionPolicy


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    path = tmp_path_factory.mktemp("kb") / "bench_kernels_cpu.json"
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        payload = kb.main(["--device", "cpu", "--tiles-smoke", "--json",
                           str(path)])
    return path, payload, buf.getvalue()


def test_cli_prints_the_reference_rows(artifact):
    """The reference's CSV row names, one per kernel, shape and scheme,
    with the H100's bound in place of the TPU's roofline."""
    _, payload, out = artifact
    names = [line.split(",")[0] for line in out.splitlines()
             if not line.startswith("#")]
    assert names[:3] == ["kernel_ecc_decode", "kernel_ecc_qmatmul",
                         "kernel_throttle"]
    assert all("h100_bound_us=" in line for line in out.splitlines()[:3])
    want = [f"autotune_decode_{k}x{n}" for k, n in kb.AUTOTUNE_SHAPES]
    want += [f"paged_attention_{'x'.join(map(str, s))}_{sc}"
             for s in kb.ATTENTION_SHAPES
             for sc in paged_attention.KV_SCHEMES]
    want += [f"chunked_attention_1x{s}x1x128_{sc}"
             for s in kb.ATTENTION_LONG_LENGTHS_SMOKE
             for sc in paged_attention.KV_SCHEMES]
    assert names[3:] == want
    assert "# wrote " in out and "(cpu, cpu)" in out


def test_cpu_artifact_times_the_plain_route_only(artifact):
    """``--device cpu``: platform "cpu", every CUDA column null, ``best``
    "torch", the plain columns timed; each entry records the kernel's
    launch plans and no tiles (the CUDA kernel plans its own launch)."""
    _, payload, _ = artifact
    assert payload["schema"] == "bench_kernels/v6"
    assert payload["platform"] == "cpu" and payload["device"] == "cpu"
    assert [tuple(e["shape"]) for e in payload["entries"]] == \
        list(kb.AUTOTUNE_SHAPES)
    for e in payload["entries"]:
        assert e["best"] == "torch" and e["torch_us"] > 0
        for k in ("cuda_us", "fused_us", "fused_abft_us", "fused_int8_us",
                  "fused_int8_abft_us"):
            assert e[k] is None, k
        assert e["fused_ref_us"] > 0 and e["int8_ref_us"] > 0
        assert "tiles" not in e and "int8_tiles" not in e
        k, n = e["shape"]
        for key, dt in (("launch", torch.bfloat16),
                        ("int8_launch", torch.int8)):
            p = ecc_qmatmul.plan_launch(128, n, k, dt)
            assert e[key] == {"regime": p.regime, "bm": p.bm, "bn": p.bn,
                              "splits": p.splits}
        assert e["h100_bound_us"] == kb.bound_us(2 * k * n + k * n // 8)
    for r in payload["attention"]:
        assert r["fused_us"] is None and r["bitexact"] is None
        assert r["ref_us"] > 0
    for r in payload["attention_long"]:
        assert r["chunked_us"] is None and r["strip_us"] is None
        assert r["within_tol"] is True and r["chunked_plain_us"] > 0
        assert r["over_limit"] == (r["strip_smem_bytes"] >
                                   paged_attention.SMEM_LIMIT_BYTES)
    co = payload["crossover"]
    assert co["smem_limit_bytes"] == paged_attention.SMEM_LIMIT_BYTES
    assert set(co["tokens_by_scheme"].values()) == {
        paged_attention.strip_smem_crossover(128, 2)}
    assert any(r["over_limit"] for r in payload["attention_long"])


def test_artifact_round_trips_through_the_autotune_table(artifact):
    path, payload, _ = artifact
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(payload))
    table = AutotuneTable.from_json(path)
    assert len(table) == len(kb.AUTOTUNE_SHAPES)
    assert table.platform == "cpu" and table.schema == "bench_kernels/v6"
    d = table.to_dict()
    assert [e["shape"] for e in d["entries"]] == \
        [e["shape"] for e in payload["entries"]]
    assert d["attention"] == payload["attention"]
    assert d["attention_long"] == payload["attention_long"]
    assert AutotuneTable.from_dict(d).to_dict() == d
    for k, n in kb.AUTOTUNE_SHAPES:
        assert table.lookup((k, n)) in BACKENDS
        assert table.lookup_tiles((k, n)) is None


def test_serve_with_the_table_equals_serve_without(artifact):
    """``serve(..., autotune=<the artifact>)`` at smoke size on the CPU:
    every leaf the table routes takes "torch", the route the CPU serves
    anyway, so the flags and the logits equal the same serve without the
    table, and the plan says which leaves the table decided."""
    path, _, _ = artifact
    cfg = configs.get_smoke("deepseek-7b")
    pol = ProtectionPolicy(autotune=str(path))
    routed = [p for p, leaf in tree.leaves_with_path(lm.param_shapes(cfg))
              if pol.resolve_backend(tree.path_str(p), leaf.shape)[1] ==
              "autotune"]
    assert routed   # leaves within 4x of a shape's block count
    kw = dict(batch=2, tokens=3, fault_rate=1e-3, seed=3, device="cpu",
              log=lambda *_: None)
    got = serve.serve(cfg, autotune=str(path), **kw)
    want = serve.serve(cfg, **kw)
    assert got["flags"] == want["flags"] and want["flags"]["corrected"] > 0
    assert torch.equal(got["logits"], want["logits"])
    assert torch.equal(got["tokens"], want["tokens"])


def test_kernel_bench_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kb.main([])
