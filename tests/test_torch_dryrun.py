"""The port's dry-run and its op analysis against the reference's
(``repro.launch.dryrun`` / ``hlo_analysis``), the CLIs' flags, and the
train CLI's ``--smoke``.

The reference's cells compile for 8 host devices in a subprocess; the
port's trace as rank 0 of a fake process group in this process.
"""
import ast
import json
import os
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from repro.launch import hlo_analysis as H
from repro_torch.launch import dryrun, op_analysis
from repro_torch.launch import train as launch_train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = dict(arch="deepseek-7b", shape_name="decode_32k", multi_pod=False,
            smoke=True, mesh_shape=(2, 4))
POLICY = "attn-inplace-mlp-secded"

# the int8 at-use cell (dynamic per-token scales: its row-parallel
# matmuls join their int32 accumulators over 'model') and the moe family's
# decode cells (MLA's absorbed products per (batch row, head), the routing
# per group), each on the 2x4 mesh
INT8 = dict(arch="qwen1.5-4b", shape_name="decode_32k", multi_pod=False,
            smoke=True, mesh_shape=(2, 4), act_quant="dynamic",
            decode_at_use=True)
MOE = ("deepseek-v2-236b", "deepseek-v3-671b")
CLI = ["--smoke", "--arch", "qwen1.5-4b", "--shape", "decode_32k", "--mesh",
       "2x4", "--devices", "8", "--policy", "all-in-place", "--serve-modes",
       "at-use", "--act-quant"]

_REF = """
import os, sys, json
sys.argv = ["x"]
from repro.launch import dryrun
dryrun.setup_host_devices(8)
out = {}
for pol in (None, %r):
    r = dryrun.run_cell("deepseek-7b", "decode_32k", False, smoke=True,
                        mesh_shape=(2, 4), policy=pol)
    r.pop("trace", None)
    out[str(pol)] = r
out["int8"] = dryrun.run_cell(**%r)
for arch in %r:
    out[arch] = dryrun.run_cell(arch, "decode_32k", False, smoke=True,
                                mesh_shape=(2, 4))
sys.argv = ["dryrun"] + %r + ["--out", %r]
dryrun.main()
out["cli"] = [json.loads(l) for l in open(%r)]
for r in list(out.values()):
    for x in (r if isinstance(r, list) else [r]):
        x.pop("trace", None)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    ref_out = str(tmp / "ref.jsonl")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("JAX_PLATFORMS", None)
    code = _REF % (POLICY, INT8, MOE, CLI, ref_out, ref_out)
    ref = subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                           cwd=ROOT, env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    port = {str(pol): dryrun.run_cell(**CELL, policy=pol, device="cpu")
            for pol in (None, POLICY)}
    port["int8"] = dryrun.run_cell(**INT8, device="cpu")
    for arch in MOE:
        port[arch] = dryrun.run_cell(arch, "decode_32k", False, smoke=True,
                                     mesh_shape=(2, 4), device="cpu")
    port_out = tmp / "port.jsonl"
    dryrun.main(["--device", "cpu", *CLI, "--out", str(port_out)])
    port["cli"] = [json.loads(line) for line in
                   port_out.read_text().splitlines()]
    out, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    return port, json.loads(out.strip().splitlines()[-1])


def test_op_analysis_counts_the_matmul_flops():
    """tests/test_hlo_analysis.py's matmul: 2 * 256 * 512 * 128."""
    a, b = torch.randn(256, 512), torch.randn(512, 128)
    out, st = op_analysis.compute_stats(lambda: a @ b)
    assert st["flops"] == 2 * 256 * 512 * 128
    assert torch.equal(out, a @ b)
    assert st["collectives"] == {} and st["total_wire_bytes"] == 0


@pytest.mark.parametrize("n", [1, 2, 8, 512])
@pytest.mark.parametrize("kind", op_analysis.COLLECTIVES)
def test_wire_factors_equal_reference(kind, n):
    for ob, rb in ((100.0, 0.0), (0.0, 160.0), (4096.0, 512.0)):
        assert op_analysis._wire(kind, ob, rb, n) == H._wire(kind, ob, rb, n)


def test_protection_record_equals_reference(cells):
    """The plan's per-scheme bytes on the 2x4 mesh, exactly; the
    reference's backend names "xla" / "pallas" are the port's "torch" /
    "cuda"."""
    port, ref = cells
    got, want = port[POLICY], ref[POLICY]
    assert got["status"] == "ok" and want["status"] == "ok", got.get("error")
    names = {"xla": "torch", "pallas": "cuda"}
    want_prot = dict(want["protection"])
    want_prot["by_backend"] = {names[k]: v
                               for k, v in want_prot["by_backend"].items()}
    assert got["protection"] == want_prot


def test_per_rank_flops_agree_with_reference(cells):
    """The rank's matmul FLOPs of a decode_32k step (deepseek-7b smoke, B 128
    over data 2, a 32,768-slot cache over model 4) within 1% of the
    reference's HLO count (equal on this tree: 272,105,472 each). They
    need not be equal: the port attends each rank's slots and joins the
    partial softmaxes, and GSPMD partitions the same einsums its own way;
    1% leaves room for a rank's share of a small replicated product."""
    port, ref = cells
    for pol in ("None", POLICY):
        got, want = port[pol]["hlo_flops"], ref[pol]["hlo_flops"]
        assert abs(got - want) / want < 0.01, (pol, got, want)


def test_collectives_are_named_and_keys_are_the_reference(cells):
    port, ref = cells
    for pol in ("None", POLICY):
        coll = port[pol]["collectives"]
        kinds = set(coll) - {"total_wire_bytes"}
        assert kinds and kinds <= set(op_analysis.COLLECTIVES), kinds
        assert coll["total_wire_bytes"] == sum(coll[k]["wire_bytes"]
                                               for k in kinds)
        assert all(coll[k]["count"] > 0 for k in kinds)
        assert set(port[pol]) == set(ref[pol]), \
            set(port[pol]) ^ set(ref[pol])


def test_full_size_cell_on_the_16x16_fake_mesh():
    """whisper-base at full width and depth, decode_32k (B 128, 32,768
    slots), traced as rank 0 of 256 with nothing allocated."""
    t0 = time.time()
    rec = dryrun.run_cell("whisper-base", "decode_32k", False, device="cpu")
    assert rec["status"] == "ok", rec.get("error")
    assert time.time() - t0 < 30
    assert rec["n_devices"] == 256 and rec["mesh"] == "16x16"
    assert rec["hlo_flops"] > 0 and rec["collectives"]["total_wire_bytes"] > 0
    assert rec["memory"]["argument_size_in_bytes"] > \
        rec["memory"]["alias_size_in_bytes"] > 0


def test_dryrun_cli_writes_one_record(tmp_path):
    out = tmp_path / "d.jsonl"
    dryrun.main(["--device", "cpu", "--smoke", "--arch", "deepseek-7b",
                 "--shape", "decode_32k", "--mesh", "2x4", "--devices", "8",
                 "--out", str(out)])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(recs) == 1 and recs[0]["status"] == "ok"
    assert recs[0]["cell"] == "deepseek-7b:decode_32k:2x4:decode_mode=at-use"


def test_dryrun_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--smoke", "--arch", "deepseek-7b", "--shape",
                     "decode_32k", "--mesh", "2x4", "--devices", "8",
                     "--out", os.devnull])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.run_cell(**CELL)


def _flags(path: str) -> set:
    tree = ast.parse(open(path).read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    return {c.args[0].value for c in ast.walk(main)
            if isinstance(c, ast.Call) and getattr(c.func, "attr", "") ==
            "add_argument" and c.args and isinstance(c.args[0],
                                                      ast.Constant)}


@pytest.mark.parametrize("name,extra", [("train", {"--backend", "--device"}),
                                        ("dryrun", {"--device"})])
def test_cli_flags_are_the_reference_ones(name, extra):
    """The port's CLI names the reference's flags, plus its own route and
    device flags."""
    ref = _flags(os.path.join(ROOT, "src", "repro", "launch", f"{name}.py"))
    port = _flags(os.path.join(ROOT, "src", "repro_torch", "launch",
                               f"{name}.py"))
    assert port == ref | extra, port ^ (ref | extra)


def test_train_cli_takes_smoke():
    """``python -m repro_torch.launch.train --smoke --device cpu --steps
    1`` (the reference's no-op flag, default on)."""
    out = launch_train.main(["--smoke", "--device", "cpu", "--steps", "1"])
    assert out is not None


def test_int8_cell_flops_equal_reference(cells):
    """The int8 at-use decode cell (qwen1.5-4b smoke, B 128 over data 2,
    dynamic per-token activation scales) records ``ok`` on the 2x4 mesh
    with the reference's FLOPs exactly: the sharded int8 matmuls keep the
    float cell's products (each row-parallel shard's int32 partial
    accumulator, joined over 'model'), and the absmax MAX and the
    accumulator SUM add collectives, no FLOPs."""
    port, ref = cells
    got, want = port["int8"], ref["int8"]
    assert got["status"] == "ok", got.get("error")
    assert want["status"] == "ok" and got["decode_mode"] == "at-use-int8"
    assert got["hlo_flops"] == want["hlo_flops"] == 272_105_472
    assert set(got) == set(want), set(got) ^ set(want)


# the moe decode cells' FLOPs against the reference's, per op (the ranks'
# dot shapes read from the reference's HLO and from the port's local mm /
# bmm calls): every product is the reference's but two of the second
# layer's. The port's residual stream reaches layer 2 split over 'model'
# by the batch rows (16 of the rank's 64), so its router (64 x 8) and its
# w_dkv (64 x 40) products take 16 rows there: 2 * 48 * 64 * 40 = 245,760
# FLOPs fewer. Its router is whole over 'model' where the reference's
# output is split in 4 (2 of 8 experts a rank): 2 * (64 + 16) * 64 * 8
# against 2 * 2 * 64 * 64 * 2, 49,152 more. Net: the port counts 196,608
# FLOPs fewer than the reference's 8,978,989,056 (v2) and 8,978,923,520
# (v3), 0.0022%.
MOE_FLOPS_GAP = 245_760 - 49_152


@pytest.mark.parametrize("arch", MOE)
def test_moe_decode_cell_is_ok_and_flops_are_explained(cells, arch):
    """deepseek-v2-236b and -v3-671b smoke, decode_32k on 2x4: ``ok`` (MLA's
    absorbed decode products run per (batch row, head) on local tensors,
    the expert queues per routing group), FLOPs the reference's less
    MOE_FLOPS_GAP."""
    port, ref = cells
    got, want = port[arch], ref[arch]
    assert got["status"] == "ok", got.get("error")
    assert want["status"] == "ok"
    assert want["hlo_flops"] - got["hlo_flops"] == MOE_FLOPS_GAP, \
        (got["hlo_flops"], want["hlo_flops"])
    assert got["collectives"]["total_wire_bytes"] > 0


def test_dryrun_cli_writes_the_int8_record(cells):
    """``--policy all-in-place --serve-modes at-use --act-quant`` (the
    serve modes apply under ``--policy`` only, as in the reference): the
    unprotected baseline, the float at-use cell and the ``at-use-int8``
    cell, each ``ok``; the int8 record carries its deltas against its
    float twin, and every record the reference's keys."""
    port, ref = cells
    modes = [(r.get("policy"), r.get("decode_mode")) for r in port["cli"]]
    assert modes == [(r.get("policy"), r.get("decode_mode"))
                     for r in ref["cli"]]
    assert ("all-in-place", "at-use-int8") in modes
    for got, want in zip(port["cli"], ref["cli"]):
        assert got["status"] == "ok", got.get("error")
        assert set(got) == set(want), set(got) ^ set(want)
    rec = port["cli"][modes.index(("all-in-place", "at-use-int8"))]
    assert set(rec["vs_float_at_use"]) == {"hbm_delta_bytes",
                                           "wire_delta_bytes"}
    assert rec["vs_float_at_use"]["wire_delta_bytes"] is not None
    assert rec["hlo_flops"] == 272_105_472
