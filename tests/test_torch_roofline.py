"""The port's roofline, report and runner (``repro_torch.benchmarks.
roofline``, ``report``, ``run``) against the reference's
``benchmarks/roofline.py`` and ``report.py`` on the CPU: the analytic
parameter and MODEL_FLOPS counts for every arch and shape, a record's
terms at the H100's peaks against the reference's at the TPU's, the fused
and KV traffic rows, and the tables over a JSONL the port's dry-run
writes."""
import json
import math

import pytest
import torch

from benchmarks import report as jreport
from benchmarks import roofline as jroof
from repro import configs as jconfigs
from repro.models.config import SHAPES as JSHAPES
from repro_torch import configs
from repro_torch.benchmarks import kernel_bench, report, roofline
from repro_torch.launch import dryrun
from repro_torch.models.config import SHAPES


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_counts_and_model_flops_equal_reference(arch):
    """All 10 archs x every shape: the same analytic counts."""
    assert set(configs.ARCH_IDS) == set(jconfigs.ARCH_IDS)
    assert list(SHAPES) == list(JSHAPES)
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    assert roofline.param_counts(cfg) == jroof.param_counts(jcfg)
    for name in SHAPES:
        assert roofline.model_flops(cfg, SHAPES[name]) == \
            jroof.model_flops(jcfg, JSHAPES[name]), name


# counts of the size of the port's deepseek-7b train_4k cell on 16 x 16
# (a rank's FLOPs, buffer bytes and wire bytes)
RECORD = {"arch": "deepseek-7b", "shape": "train_4k", "mesh": "16x16",
          "status": "ok", "n_devices": 256, "hlo_flops": 3.466e14,
          "hlo_buffer_bytes": 9.1e12,
          "collectives": {"total_wire_bytes": 378.4e9}}


def test_analyze_scales_the_reference_terms_by_the_peaks():
    """The raw counts give each term the reference's times (TPU peak /
    H100 peak); the useful-FLOPs ratio does not depend on the card."""
    got, want = roofline.analyze(RECORD), jroof.analyze(RECORD)
    for term, ratio in (("compute_s", jroof.PEAK_FLOPS / roofline.PEAK_FLOPS),
                        ("memory_s", jroof.HBM_BW / roofline.HBM_BW),
                        ("collective_s", jroof.LINK_BW / roofline.LINK_BW)):
        assert got[term] == pytest.approx(want[term] * ratio, rel=1e-5), term
    assert got["useful_flops_ratio"] == want["useful_flops_ratio"]
    assert got["model_flops"] == want["model_flops"]
    assert (roofline.PEAK_FLOPS, roofline.PEAK_INT8, roofline.HBM_BW,
            roofline.LINK_BW) == (989e12, 1979e12, 3.35e12, 450e9)


def test_kv_traffic_rows_equal_reference(capsys):
    """Read, check and dense bytes per scheme (the port's paged cache sized
    on meta tensors) are the reference's; only the time moves with the
    HBM rate."""
    got, want = roofline.kv_traffic_rows(), jroof.kv_traffic_rows()
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        for k in ("arch", "seq", "scheme", "read_bytes_per_step",
                  "check_bytes", "dense_bf16_bytes", "vs_dense_ratio"):
            assert g[k] == w[k], (k, g, w)
        assert g["kv_roof_us"] == pytest.approx(
            g["read_bytes_per_step"] / roofline.HBM_BW * 1e6, abs=0.01)


def test_fused_vs_decode_rows_equal_reference(tmp_path, capsys):
    """Over the port's own autotune artifact's shapes, and over the default
    shapes: the traffic ratios are the reference's."""
    path = tmp_path / "bench.json"
    path.write_text(json.dumps({"entries": [
        {"shape": list(s)} for s in kernel_bench.AUTOTUNE_SHAPES]}))
    for arg in (str(path), None):
        got = roofline.fused_vs_decode_rows(arg)
        want = jroof.fused_vs_decode_rows(
            str(path) if arg else str(tmp_path / "none.json"))
        assert [r["shape"] for r in got] == [r["shape"] for r in want]
        for g, w in zip(got, want):
            assert g["traffic_ratio"] == w["traffic_ratio"]
            assert g["int8_traffic_ratio"] == w["int8_traffic_ratio"]


@pytest.fixture(scope="module")
def dryrun_jsonl(tmp_path_factory):
    path = tmp_path_factory.mktemp("roof") / "dryrun.jsonl"
    dryrun.main(["--device", "cpu", "--smoke", "--arch", "deepseek-7b",
                 "--shape", "decode_32k", "--mesh", "2x4", "--devices", "8",
                 "--out", str(path)])
    return path


def test_report_table_over_the_ports_dryrun(dryrun_jsonl):
    """``report.table`` over a JSONL of the port's dry-run at smoke size:
    a row per ok cell, its MODEL_FLOPS and useful ratio the reference's
    table's over the same records, and the memory column named for what
    the records hold (a rank's argument + output - aliased bytes), not a
    peak."""
    got = report.table(str(dryrun_jsonl), "smoke 2x4").splitlines()
    want = jreport.table(str(dryrun_jsonl), "smoke 2x4").splitlines()
    assert got[0] == want[0] == "**smoke 2x4** (1 cells ok, 0 skipped)"
    assert "args+out-alias GB" in got[2] and "peak" not in got[2]
    (row,) = [r for r in got if r.startswith("| deepseek")]
    (wrow,) = [r for r in want if r.startswith("| deepseek")]
    (rec,) = [json.loads(line)
              for line in dryrun_jsonl.read_text().splitlines()]
    cells, wcells = row.split(" | "), wrow.split(" | ")
    assert cells[:2] == wcells[:2] and cells[6:8] == wcells[6:8]
    live = (rec["memory"]["argument_size_in_bytes"] +
            rec["memory"]["output_size_in_bytes"] -
            rec["memory"]["alias_size_in_bytes"])
    assert live > 0 and cells[-1] == f"{live / 1e9:.1f} |"


def test_roofline_main_reads_the_ports_records(dryrun_jsonl, capsys):
    rows = roofline.main(["--device", "cpu", str(dryrun_jsonl)])
    out = capsys.readouterr().out
    assert [r["arch"] for r in rows] == ["deepseek-7b"]
    assert "roofline_deepseek-7b_decode_32k_2x4," in out
    assert "roofline_kv_deepseek-7b_4096_in-place," in out
    assert all(math.isfinite(r["compute_s"]) for r in rows)


@pytest.mark.parametrize("mod", ["roofline", "report", "run"])
def test_benchmarks_default_to_cuda(monkeypatch, mod):
    import importlib
    m = importlib.import_module(f"repro_torch.benchmarks.{mod}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.main([])
