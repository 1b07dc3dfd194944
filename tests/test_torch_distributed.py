"""Multi-rank parity of the port's distribution on the CPU: one gloo process
group of 8 ranks (``torch_dist_cases.py``) runs every case once, beside the
reference's sharded runs in an 8-host-device subprocess
(``torch_dist_ref.py``) on the same inputs.

Cases: the sharded QATT train cell (minitron-4b smoke, 2x4, FSDP off as
the 5 GiB rule sets it and forced on); the plan-driven decode cell
(qwen1.5-4b smoke, attn-inplace-mlp-secded, b 8 and 3, dense and paged
in-place KV, FSDP off and on, over the reference's encoded images with one
seeded fault mask XORed in, fed to both packages); the scale and throttle
collectives on shards whose absmaxes differ; GPipe over 4 stages;
``compressed_psum`` over 8 ranks; the elastic restore onto 2x2.
"""
import json
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro import protection as jprotection
from repro.models import lm as jlm
from repro.protection.tensor import is_protected_tensor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))

import torch_dist_cases  # noqa: E402  (tests/ is on the path)

DECODES_AUTO = [(b, kv) for b, kv, f in torch_dist_cases.DECODES if not f]
DECODES_FSDP = [(b, kv) for b, kv, f in torch_dist_cases.DECODES if f]


def _flat(tree, prefix):
    return {prefix + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                              for k in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _inputs() -> dict:
    rng = np.random.default_rng(27)
    data = {}
    mcfg = jconfigs.get_smoke("minitron-4b")
    data.update(_flat(jlm.init_params(mcfg, jax.random.PRNGKey(0)),
                      "params/"))
    data["tokens"] = rng.integers(0, mcfg.vocab, (8, 32)).astype(np.int32)
    data["targets"] = rng.integers(0, mcfg.vocab, (8, 32)).astype(np.int32)
    qcfg = jconfigs.get_smoke("qwen1.5-4b")
    qparams = jlm.init_params(qcfg, jax.random.PRNGKey(1))
    data.update(_flat(qparams, "qwen/"))
    data.update(_faulted_images(qparams))
    for b in (8, 3):
        data[f"dec_tokens_{b}"] = rng.integers(0, qcfg.vocab,
                                               (b, 2)).astype(np.int32)
    w = rng.standard_normal((16, 64)).astype(np.float32)
    w[:8] *= 9.0           # the data-rank-0 shards hold the larger absmax
    data["absmax_w"] = w
    data["pipe_ws"] = (rng.standard_normal((4, 16, 16)) * 0.5).astype(
        np.float32)
    data["pipe_xs"] = rng.standard_normal((8, 4, 16)).astype(np.float32)
    data["psum_g"] = rng.standard_normal((8, 128)).astype(np.float32)
    data["mm_w"] = (rng.standard_normal((64, 128)) * 0.05).astype(np.float32)
    data["mm_x"] = rng.standard_normal((8, 1, 64)).astype(np.float32)
    return data


def _faulted_images(params) -> dict:
    """The reference's images of ``params`` under attn-inplace-mlp-secded
    with one seeded NumPy fault mask XORed in (``torch_parity``'s rate and
    draw): ``qenc/<path>#enc``, ``#checks`` and ``#scale``, which both
    packages' decode cells load in place of their own encodings."""
    import torch_parity
    plan = jprotection.get_policy_preset("attn-inplace-mlp-secded").plan(
        params)
    enc = jax.jit(plan.encode_tree)(params)
    flipped = torch_parity._flip_exported(torch_parity.export(enc), seed=27)
    out = {}
    for path, pt in jax.tree_util.tree_flatten_with_path(
            enc, is_leaf=is_protected_tensor)[0]:
        if not is_protected_tensor(pt):
            continue
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        node = flipped
        for k in keys:
            node = node[k]
        name = "qenc/" + "/".join(keys)
        out[name + "#enc"] = node["enc"]
        out[name + "#scale"] = node["scale"]
        if node["checks"] is not None:
            out[name + "#checks"] = node["checks"]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("dist")
    inp = str(tmp / "in.npz")
    np.savez(inp, **_inputs())
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("JAX_PLATFORMS", None)
    ref = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dist_ref.py"), inp,
         str(tmp / "ref")], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    mp.start_processes(torch_dist_cases.run_rank,
                       args=(str(tmp / "store"), inp, str(tmp / "port.pkl"),
                             str(tmp)),
                       nprocs=torch_dist_cases.WORLD, start_method="spawn")
    out, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:] + out[-500:]
    with open(tmp / "port.pkl", "rb") as f:
        port = pickle.load(f)
    with open(tmp / "ref.json") as f:
        ref_specs = json.load(f)
    return port, dict(np.load(tmp / "ref.npz")), ref_specs


def _hold_train(port, ref, key):
    loss, uloss, rloss = (port[key + "_loss"], port["train_loss_unsharded"],
                          float(ref[key + "_loss"]))
    assert abs(loss - rloss) / abs(rloss) < 1e-4, (loss, rloss)
    assert abs(loss - uloss) / abs(uloss) < 1e-4, (loss, uloss)
    keys = [k for k in ref if k.startswith(key + "_masters/")]
    assert keys
    for k in keys:
        leaf = k[len(key + "_masters/"):]
        got = port[k]
        assert got.shape == ref[k].shape, k
        assert np.abs(got - ref[k]).max() < 5e-6, k
        assert np.abs(got - port["train_unsharded/" + leaf]).max() < 5e-6, k


def test_sharded_train_step_matches_reference_and_unsharded(runs):
    """minitron-4b smoke, microbatch 2, 2x4, (t, 32, 8), chunk 16, default
    QATT (bf16 weights and activations, f32 masters).

    The loss is within 1e-4 relative, not 1e-5: both sharded steps sum the
    bf16 projections' partial products over the 'model' shards in another
    order than one matmul does (each partial rounded to bf16 before the
    all-reduce), which moves the f32 loss by ~4e-5 relative here (the
    reference's sharded step moves it as much against its unsharded one).
    The masters (lr 1e-4 updates of values up to ~0.5) are within 5e-6
    absolute, the bound ``test_torch_train.py`` holds the unsharded bf16
    step's momentum times lr to."""
    port, ref, _ = runs
    _hold_train(port, ref, "train")


def test_fsdp_train_step_matches_reference_and_unsharded(runs):
    """The same cell with FSDP forced on (the 5 GiB rule leaves it off at
    smoke size): every weight also sharded over 'data', gathered before
    its matmul and its gradient reduce-scattered back, the embedding's
    gradient partial over the data-split tokens. Held to the reference's
    FSDP step and the port's unsharded step within the tolerances above
    (the same bf16 partial sums)."""
    port, ref, _ = runs
    assert "Shard" in port["train_fsdp_wq_placements"].split(",")[0]
    _hold_train(port, ref, "train_fsdp")


# The bf16 decode logits (|logit| up to ~4.2 here) of the port's sharded
# cells against the reference's sharded cells and the port's unsharded
# step: 0.047 at most in these cells (three bf16 ulps below 4; the
# reference's sharded logits lie as far from the port's unsharded ones),
# held to 0.0625, two ulps above 4.
LOGIT_TOL = 0.0625


def _hold_decode(port, ref, key):
    rows = [k for k in ref if k.startswith(key + "/flags/")]
    assert {r.rsplit("/", 1)[1] for r in rows} >= {"top", "layers"}
    assert sorted(k for k in port if k.startswith(key + "/flags/")) == \
        sorted(rows)
    assert sum(int(ref[r].sum()) for r in rows) > 0   # faults were seen
    for r in rows:
        np.testing.assert_array_equal(port[r], ref[r], err_msg=r)
    got, want = port[key + "/logits"], ref[key + "/logits"]
    assert got.shape == want.shape
    assert np.abs(got - want).max() < LOGIT_TOL, np.abs(got - want).max()


@pytest.mark.parametrize("b,kv", DECODES_AUTO)
def test_decode_cell_out_specs_equal_reference(runs, b, kv):
    """The logits' out-spec keys on the real data-axis size (b 8 divides 2,
    b 3 does not), and every cache leaf's spec is the reference's."""
    port, _, ref_specs = runs
    key = torch_dist_cases.decode_key(b, kv, None)
    assert port[key + "/out_specs"] == ref_specs[key]


@pytest.mark.parametrize("b,kv", DECODES_AUTO)
def test_decode_cell_flags_exact_and_logits_close(runs, b, kv):
    """Two sharded decode steps over the reference's faulted images: every
    flags row equals the reference's sharded step's and the port's
    unsharded step's (each block counted once across the shards), and the
    bf16 logits are within LOGIT_TOL of both (the row-parallel
    projections' bf16 partial sums and the slot-sharded softmax join in
    another order than one matmul or one softmax)."""
    port, ref, _ = runs
    key = torch_dist_cases.decode_key(b, kv, None)
    _hold_decode(port, ref, key)
    for r in [k for k in port if k.startswith(key + "/flags/")]:
        np.testing.assert_array_equal(
            port[r], port[r.replace("/flags/", "/flags_unsharded/")])
    got, want = port[key + "/logits"], port[key + "/logits_unsharded"]
    assert np.abs(got - want).max() < LOGIT_TOL
    assert ("Shard(dim=0)" in port[key + "/logits_placements"]) == (b == 8)


@pytest.mark.parametrize("b,kv", DECODES_FSDP)
def test_fsdp_decode_cell_matches_reference(runs, b, kv):
    """The decode cell with FSDP forced on: the encoded images also sharded
    over 'data' and gathered (the int8 bytes and checks, never the decoded
    weight) before each decode-at-use matmul. Out-specs equal, flags
    exact and logits within LOGIT_TOL of the reference's FSDP cell."""
    port, ref, ref_specs = runs
    key = torch_dist_cases.decode_key(b, kv, True)
    assert port[key + "/out_specs"] == ref_specs[key]
    assert "Shard" in port[key + "/wq_enc_placements"].split(",")[0]
    _hold_decode(port, ref, key)


def test_scale_and_throttle_use_the_global_absmax(runs):
    """Shards whose absmaxes differ (rank 0's shard holds ~9x rank 7's): the
    scale of the sharded master and its in-place throttle (pass 1, an
    all-reduce MAX, pass 2) are the whole tensor's, bit for bit."""
    port, _, _ = runs
    assert port["shard_absmax"] > 0
    assert port["scale_sharded"] == port["scale_whole"]
    np.testing.assert_array_equal(port["throttle_sharded"],
                                  port["throttle_whole"])


def test_pipeline_matches_sequential_and_reference(runs):
    port, ref, _ = runs
    assert np.abs(port["pipe"] - port["pipe_sequential"]).max() < 1e-5
    assert np.abs(port["pipe"] - ref["pipe"]).max() < 1e-5


def test_compressed_psum_matches_reference(runs):
    """8 ranks on the reference test's (8, 128) input: each rank's int8
    payload and residual are the reference's bit for bit, the means within
    f32 rounding (the int32 sums are exact; one multiply and one divide)."""
    port, ref, _ = runs
    np.testing.assert_array_equal(port["psum_q"], ref["psum_q"])
    np.testing.assert_array_equal(port["psum_res"], ref["psum_res"])
    np.testing.assert_allclose(port["psum_mean"], ref["psum_mean"],
                               rtol=2e-7, atol=0)


def test_elastic_restore_onto_2x2_is_exact(runs):
    """A protected (params, momentum) checkpoint restored onto a 2x2 mesh
    with the sharding rules' specs holds the unsharded restore's values."""
    port, _, _ = runs
    assert port["restore_step"] == 3
    assert "Shard" in port["restore_placements"]
    whole, got = port["restore_whole"], port["restore_sharded"]
    assert set(got) == set(whole) and got
    for k in whole:
        np.testing.assert_array_equal(got[k], whole[k], err_msg=k)


@pytest.mark.parametrize("mode", torch_dist_cases.GUARDS)
def test_guarded_decode_cell_matches_reference_and_unsharded(runs, mode):
    """The int8 (dynamic per-token scales at use) and the guarded (ABFT on
    every matmul leaf, each clamped at GUARD_CLAMP) decode cells of
    qwen1.5-4b smoke, b 8 on 2x4, two steps over the faulted images: the
    flags, ABFT mismatch and clamp-hit rows equal the reference's sharded
    cell's and the port's unsharded step's exactly, the logits within
    LOGIT_TOL of both. The row-parallel int8 matmuls join their int32
    accumulators before the epilogue; the guarded ones their checksums.

    These cells serve f32 activations (the cells' specs, the step built
    with ``dtype=float32`` in both packages). In bf16 the slot-sharded
    softmax join moves an activation by a bf16 ulp, and the dynamic
    quantization then moves it a whole int8 step (ROADMAP Queue 3, the
    rounding boundary): the port's own bf16 sharded and unsharded int8
    steps differed by up to 0.077 here, as far as they lie from the
    reference's sharded cell (0.075), and a clamp bound of 0.3 saw 2,761
    hits unsharded against 2,764 sharded. In f32 the logits agree within
    3e-6 and every count is held exactly. A bound sees the f32 sums'
    order too: at 0.3 one of the head's 8,192 values lay within it (3,138
    hits on the port's unsharded step, 3,137 on both sharded cells), so
    the cells clamp at 0.35, where every hit is shared."""
    port, ref, _ = runs
    key = torch_dist_cases.guard_key(mode)
    _hold_decode(port, ref, key)
    rows = [k for k in port if k.startswith(key + "/flags/")]
    if mode == "guarded":
        abft = [r for r in rows if r.endswith("_abft")]
        assert abft and sum(int(port[r][1].sum()) for r in abft) > 0, \
            "no clamp hit: the clamp is not exercised"
    for r in rows:
        np.testing.assert_array_equal(
            port[r], port[r.replace("/flags/", "/flags_unsharded/")],
            err_msg=r)
    got, want = port[key + "/logits"], port[key + "/logits_unsharded"]
    assert np.abs(got - want).max() < LOGIT_TOL


@pytest.mark.parametrize("i", range(len(torch_dist_cases.MATMULS)))
def test_sharded_guarded_matmul_equals_whole(runs, i):
    """``ProtectedWeight.matmul`` over a row-parallel, column-parallel and
    replicated image on 2x4 (the input's rows split over 'data'), float
    with ABFT and a clamp, int8 dynamic and static, int8 with ABFT and a
    clamp, per-slot rows: every count equals the view's over the whole
    image (flags once per block, mismatches and hits once per row), the
    int8 outputs bit for bit, the float ones within 2 bf16 ulps (the
    row-parallel f32 partial accumulators join in another order)."""
    port, _, _ = runs
    spec, aq, abft, clamp, per_slot = torch_dist_cases.MATMULS[i]
    (yw, gw), (ys, gs) = (port[torch_dist_cases.matmul_key(i)][k]
                          for k in ("whole", "sharded"))
    assert gs["flags"] == gw["flags"] and gw["flags"][0][0] > 0
    assert len(gs["abft"]) == len(gw["abft"])
    for (mw, hw), (ms, hs) in zip(gw["abft"], gs["abft"]):
        np.testing.assert_array_equal(ms, mw)
        np.testing.assert_array_equal(hs, hw)
    if clamp is not None:
        assert sum(int(h.sum()) for _, h in gw["abft"]) > 0
    if aq is not None:
        np.testing.assert_array_equal(ys, yw)
    else:
        np.testing.assert_allclose(ys, yw, rtol=2 ** -7, atol=1e-6)
