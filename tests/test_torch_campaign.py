"""The port's fault campaigns (``repro_torch.protection.campaign``), the
host trial pipeline and the serve CLI's smoke-check, held to the reference:
host injection byte for byte, decode flags, the ``CampaignResult`` JSON in
both directions, the ABFT detection counts on the same NumPy masks, ports
of ``tests/test_campaign.py``'s cases on its linear model, the traced-rate
injector, and the device grid against the host oracle on a CNN the port
trains.

Device grids draw from torch generators, which cannot replay
``jax.random``: they are held to the host path statistically, as the
reference holds its own device grid.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import protection as jprot
from repro.core import quant as jquant
from repro.data import synthetic as jsyn
from repro.kernels import ref as jkref
from repro.launch import serve as jserve
from repro_torch import convert, protection, tree
from repro_torch.core import faults
from repro_torch.launch import serve
from repro_torch.protection import campaign, host
from repro_torch.training import cnn_experiments as ce

N_CLASSES, IMG, BATCH = 4, 8, 128
SCHEMES = ("faulty", "parity-zero", "secded72", "in-place")


def _ndim2(path, leaf):
    return getattr(leaf, "ndim", 0) >= 2


@pytest.fixture(scope="module")
def linear_model():
    """The reference test's template-correlator classifier (no training),
    in the port."""
    _, tmpl = jsyn.image_batch(N_CLASSES, BATCH, IMG, seed=3, step=0)
    w = tmpl.reshape(N_CLASSES, -1).T / np.sqrt(tmpl[0].size)
    params = {"fc": {"w": torch.from_numpy(w.astype(np.float32))}}
    fwd = lambda p, x: x.reshape(x.shape[0], -1) @ p["fc"]["w"]  # noqa: E731
    return params, fwd, tmpl


def _run(params, fwd, tmpl, scheme, *, key, **kw):
    kw.setdefault("n_classes", N_CLASSES)
    kw.setdefault("img", IMG)
    kw.setdefault("eval_batch", BATCH)
    return protection.run_campaign(params, fwd, tmpl, scheme, key=key,
                                   device="cpu", **kw)


# ---------------------------------------------------------------------------
# a small tree in both packages: a list, a flat-padded leaf, a 1-D leaf
# ---------------------------------------------------------------------------


def _small_tree():
    rng = np.random.default_rng(11)
    return {"convs": [{"w": rng.normal(size=(3, 3, 4, 8)).astype(np.float32),
                       "b": rng.normal(size=(8,)).astype(np.float32)}
                      for _ in range(3)],
            "fc": {"w": rng.normal(size=(40, 5)).astype(np.float32)}}


@pytest.fixture(scope="module")
def encoded_pair():
    """``{scheme: (reference encoded tree, port encoded tree)}`` of the
    small tree under the CNN eval policy (predicate: >= 2 dims)."""
    p = _small_tree()
    out = {}
    for s in SCHEMES:
        jenc = jprot.ProtectionPolicy(default_scheme=s,
                                      predicate=_ndim2).encode_tree(
            jax.tree.map(jnp.asarray, p))
        tenc = protection.ProtectionPolicy(s, predicate=_ndim2).encode_tree(
            convert.params_from_numpy(p, device="cpu"))
        out[s] = (jenc, tenc)
    return out


def _protected(enc, is_pt):
    return [leaf for leaf in jax.tree_util.tree_leaves(enc, is_leaf=is_pt)
            if is_pt(leaf)]


def _port_protected(enc):
    return [leaf for _, leaf in tree.leaves_with_path(enc)
            if protection.is_protected_tensor(leaf)]


def _same_images(jenc, tenc):
    js = _protected(jenc, jprot.is_protected_tensor)
    ts = _port_protected(tenc)
    assert len(js) == len(ts) > 0
    for a, b in zip(js, ts):
        assert np.asarray(a.enc).tobytes() == b.enc.numpy().tobytes()
        assert (a.checks is None) == (b.checks is None)
        if a.checks is not None:
            assert np.asarray(a.checks).tobytes() == \
                b.checks.numpy().tobytes()


@pytest.mark.parametrize("scheme", SCHEMES)
def test_encode_and_host_injection_are_byte_equal(encoded_pair, scheme):
    """The encoded images, then the host injector's flips (leaf i of the
    tree order takes seed + i over ``enc ‖ checks``), byte for byte."""
    jenc, tenc = encoded_pair[scheme]
    _same_images(jenc, tenc)
    for rate, seed in ((1e-3, 0), (2e-2, 41)):
        _same_images(jprot.inject_tree(jenc, rate, seed),
                     protection.inject_tree(tenc, rate, seed))
    assert protection.space_overhead(tenc) == jprot.space_overhead(jenc)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_decode_tree_with_flags_equal(encoded_pair, scheme):
    jenc, tenc = encoded_pair[scheme]
    jdirty = jprot.inject_tree(jenc, 2e-2, 5)
    tdirty = protection.inject_tree(tenc, 2e-2, 5)
    jdec, jflags = jprot.decode_tree_with_flags(jdirty, jnp.float32)
    tdec, tflags = protection.decode_tree_with_flags(tdirty, torch.float32)
    assert list(tflags) == list(jflags)
    assert {p: (int(c), int(d)) for p, (c, d) in tflags.items()} == \
        {p: (int(c), int(d)) for p, (c, d) in jflags.items()}
    if scheme != "faulty":   # faulty detects nothing
        assert sum(int(c) + int(d) for c, d in tflags.values()) > 0
    for path, t in tree.leaves_with_path(tdec):
        want = np.asarray(tree.get_path(jax.tree.map(np.asarray, jdec), path))
        assert t.numpy().tobytes() == want.tobytes(), path
    # decode_tree, flags aside, and the scheme's decode alone
    for path, t in tree.leaves_with_path(
            protection.decode_tree(tdirty, torch.float32)):
        assert torch.equal(t, tree.get_path(tdec, path))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_host_trial_pipeline_matches_reference(scheme):
    from repro.protection import host as jhost
    q = np.random.default_rng(4).integers(-64, 64, size=203).astype(np.int8)
    q[7::8] = np.random.default_rng(5).integers(-127, 128, size=25)
    mine, ref = host.get_host_scheme(scheme), jhost.get_host_scheme(scheme)
    assert (mine.name, mine.needs_ecc_hw) == (ref.name, ref.needs_ecc_hw)
    a, b = mine.encode(q), ref.encode(q)
    assert a.data.tobytes() == b.data.tobytes()
    assert mine.space_overhead(a) == ref.space_overhead(b)
    for rate, seed in ((1e-2, 3), (5e-2, 9)):
        assert mine.inject(a, rate, seed).data.tobytes() == \
            ref.inject(b, rate, seed).data.tobytes()
        assert host.run_fault_trial(scheme, q, rate, seed).tobytes() == \
            jhost.run_fault_trial(scheme, q, rate, seed).tobytes()


def test_campaign_result_json_loads_in_both_packages(linear_model):
    params, fwd, tmpl = linear_model
    res = _run(params, fwd, tmpl, "secded72", rates=(1e-4, 1e-2), trials=2,
               key=41)
    d = res.to_dict()
    theirs = jprot.CampaignResult.from_json(res.to_json())
    assert theirs.to_dict() == d
    back = campaign.CampaignResult.from_json(theirs.to_json())
    assert back == res
    assert [f.name for f in dataclasses.fields(campaign.CampaignResult)] == \
        [f.name for f in dataclasses.fields(jprot.CampaignResult)]
    assert d["metric"] == "accuracy" and d["scheme"] == "secded72"
    assert abs(d["space_overhead"] - 0.125) < 1e-9
    assert d["derived"]["drop"] == list(res.drop())
    assert (d["platform"], d["device"], d["backend"]) == ("cpu", "cpu",
                                                          "torch")


# ---------------------------------------------------------------------------
# ports of tests/test_campaign.py's cases (on the port alone)
# ---------------------------------------------------------------------------


def test_zero_rate_campaign_equals_clean(linear_model):
    params, fwd, tmpl = linear_model
    for scheme in ("in-place", "secded72"):
        res = _run(params, fwd, tmpl, scheme, rates=(0.0,), trials=2, key=40)
        assert res.grid == ((res.clean, res.clean),), scheme
        assert res.drop() == (0.0,)


@pytest.mark.parametrize("kind", ["accuracy", "fidelity", "due"])
def test_vmap_and_scan_grids_identical(linear_model, kind):
    """Same key -> the batched and the one-cell-at-a-time layouts give the
    same grid, cell for cell, on a metric that actually degrades."""
    params, fwd, tmpl = linear_model
    kw = dict(rates=(1e-3, 1e-2), trials=2, key=7, device="cpu")
    grids = []
    for batch in ("vmap", "scan"):
        if kind == "accuracy":
            res = _run(params, fwd, tmpl, "faulty", batch=batch,
                       **{k: v for k, v in kw.items() if k != "device"})
        elif kind == "fidelity":
            res = protection.fidelity_campaign(params, "faulty", batch=batch,
                                               **kw)
        else:
            res = protection.due_campaign(params, "in-place", batch=batch,
                                          **kw)
        assert res.batch == batch
        grids.append(res.grid)
    assert grids[0] == grids[1]
    if kind == "fidelity":
        assert min(min(row) for row in grids[0]) < 1.0
    if kind == "due":
        assert max(max(row) for row in grids[0]) > 0


def test_fidelity_campaign_inplace_corrects_singles(linear_model):
    params, _fwd, _tmpl = linear_model
    kw = dict(rates=(2e-4,), trials=2, key=1, device="cpu")
    inplace = protection.fidelity_campaign(params, "in-place", **kw)
    faulty = protection.fidelity_campaign(params, "faulty", **kw)
    assert inplace.grid == ((1.0, 1.0),)
    assert max(faulty.grid[0]) < 1.0
    assert inplace.metric == "fidelity"


def test_fidelity_campaign_rejects_unprotected_tree():
    with pytest.raises(ValueError, match="no protected leaves"):
        protection.fidelity_campaign({"b": torch.zeros((8,))}, "in-place",
                                     device="cpu")


def test_fidelity_campaign_accepts_encoded_tree(linear_model):
    params, _fwd, _tmpl = linear_model
    enc = protection.ProtectionPolicy("secded72",
                                      predicate=_ndim2).encode_tree(params)
    res = protection.fidelity_campaign(enc, rates=(0.0,), trials=1, key=2,
                                       device="cpu")
    assert res.scheme == "secded72"
    assert res.grid == ((1.0,),)


def test_cells_draw_their_own_streams():
    """Cell (r, t)'s flips come from its own generator: the in-place DUE
    count of each cell equals the blocks its recomputed positions hit
    twice, and the corrected count those hit once or three times (a triple
    has odd parity and reads as a single: the code miscorrects it)."""
    params = {"fc": {"w": torch.randn(512, 64, generator=torch.Generator()
                                      .manual_seed(0))}}
    enc = protection.ProtectionPolicy(predicate=_ndim2).encode_tree(params)
    rates = (1e-4, 1e-3)
    due = protection.due_campaign(enc, rates=rates, trials=2, key=9,
                                  device="cpu")
    cor = protection.due_campaign(enc, rates=rates, trials=2, key=9,
                                  what="corrected", device="cpu")
    img = enc["fc"]["w"].enc
    for r, rate in enumerate(rates):
        for t in range(2):
            gen = campaign.cell_generator(9, r, t, "cpu")
            _, live = faults.inject_torch_rate(img, rate, gen, max(rates))
            _, hits = torch.unique(live // 64, return_counts=True)
            assert int(hits.max()) <= 3
            assert due.grid[r][t] == int((hits == 2).sum())
            assert cor.grid[r][t] == int((hits % 2 == 1).sum())
            assert r == 0 or due.grid[r][t] > 0


def test_due_campaign_over_kv_pools():
    """The "kv" and "both" targets count the pools' flags and carry the
    per-layer rows of one injection at the top rate."""
    from repro_torch import configs
    from repro_torch.serving import kvcache
    cfg = configs.get_smoke("deepseek-7b")
    cache = kvcache.init_cache(cfg, 2, 32, kv_policy="in-place",
                               device="cpu")
    kv = kvcache.as_protected_tree(cache, "in-place")
    res = protection.due_campaign(None, rates=(1e-3,), trials=2, key=3,
                                  target="kv", kv_tree=kv, device="cpu")
    assert res.target == "kv" and res.metric == "due_count"
    assert len(res.layer_rows) == cfg.n_layers
    assert all(len(row) == 2 for row in res.layer_rows)
    assert sum(c for c, _ in res.layer_rows) > 0
    w = {"fc": {"w": torch.randn(64, 16)}}
    both = protection.due_campaign(w, rates=(1e-3,), trials=2, key=3,
                                   what="corrected", target="both",
                                   kv_tree=kv, device="cpu")
    assert both.target == "both" and min(both.grid[0]) > 0
    with pytest.raises(ValueError, match="needs kv_tree"):
        protection.due_campaign(w, target="kv", device="cpu")


# ---------------------------------------------------------------------------
# the traced-rate injector
# ---------------------------------------------------------------------------


def test_traced_rate_injector_nests_and_counts():
    """A lower rate's draws are a prefix of a higher rate's from the same
    generator state; ``round(bits * rate)`` positions are drawn live
    before the XOR cancels repeats; the budget is ``max_rate``'s."""
    img = torch.randint(0, 256, (4096,), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(0))
    n_bits = img.numel() * 8
    draws = {}
    for rate in (1e-4, 1e-3, 5e-3):
        gen = torch.Generator().manual_seed(123)
        draws[rate] = faults.rate_positions(n_bits, rate, gen, 5e-3)
        assert draws[rate].numel() == faults.n_faults(n_bits, rate)
        # the whole budget was drawn, whatever the rate
        after = torch.randint(0, 10 ** 6, (1,), generator=gen)
        ref = torch.Generator().manual_seed(123)
        torch.randint(0, n_bits, (faults.n_faults(n_bits, 5e-3),),
                      generator=ref)
        assert int(after) == int(torch.randint(0, 10 ** 6, (1,),
                                               generator=ref))
    assert torch.equal(draws[1e-3], draws[5e-3][: draws[1e-3].numel()])
    assert torch.equal(draws[1e-4], draws[1e-3][: draws[1e-4].numel()])
    gen = torch.Generator().manual_seed(123)
    out, live = faults.inject_torch_rate(img, 1e-3, gen, 5e-3)
    uniq, cnt = torch.unique(draws[1e-3], return_counts=True)
    assert torch.equal(live, uniq[cnt % 2 == 1])
    diff = np.unpackbits((out ^ img).numpy(), bitorder="little")
    assert np.flatnonzero(diff).tolist() == live.tolist()
    with pytest.raises(ValueError, match="max_rate"):
        faults.rate_positions(n_bits, 1e-2, gen, 5e-3)


# ---------------------------------------------------------------------------
# compute faults: ABFT detection against the reference's checksums
# ---------------------------------------------------------------------------


def _reference_detection(x, w, mask, bit, target):
    """The reference's detection rule (``compute_campaign.leaf_counts``)
    over its own ``kref.abft_counts``, on given masks."""
    x, w = jnp.asarray(x), jnp.asarray(w)
    mask, bit = jnp.asarray(mask), jnp.asarray(bit)
    if target == "acc":
        acc = jquant.int8_acc(x, w)
        faulty = jnp.where(mask, acc ^ (jnp.int32(1) << bit), acc)
        row_bad, col_bad = jkref.abft_counts(x, w, faulty)
        hit = jnp.logical_or(row_bad[:, None] > 0, col_bad[None, :] > 0)
    else:
        w_f = jnp.where(mask, jax.lax.bitcast_convert_type(
            jax.lax.bitcast_convert_type(w, jnp.uint8)
            ^ (jnp.uint8(1) << bit.astype(jnp.uint8)), jnp.int8), w)
        faulty = jquant.int8_acc(x, w_f)
        row_bad, col_bad = jkref.abft_counts(x, w, faulty)
        rdet = jnp.any(jnp.logical_and(row_bad[:, None] > 0, x != 0), axis=0)
        hit = jnp.logical_or(rdet[:, None], col_bad[None, :] > 0)
    det = int(jnp.sum(jnp.logical_and(mask, hit)))
    return det, int(jnp.sum(mask)), int(jnp.sum(row_bad) + jnp.sum(col_bad))


@pytest.mark.parametrize("target", ["acc", "wdec"])
def test_compute_detection_counts_match_reference(target):
    rng = np.random.default_rng(8)
    x = rng.integers(-127, 128, size=(8, 48)).astype(np.int8)
    x[:, 5] = 0   # a probe column that perturbs no row
    w = rng.integers(-127, 128, size=(48, 24)).astype(np.int8)
    shape = (8, 24) if target == "acc" else (48, 24)
    for rate in (0.0, 0.05, 0.5):
        mask = rng.random(shape) < rate
        bit = rng.integers(0, 31 if target == "acc" else 8,
                           size=shape).astype(np.int32)
        got = campaign.leaf_counts(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(mask),
                                   torch.from_numpy(bit), target)
        assert tuple(int(v) for v in got) == \
            _reference_detection(x, w, mask, bit, target)


def test_compute_campaign_fires_no_checksum_at_rate_zero(linear_model):
    params, _fwd, _tmpl = linear_model
    for target in ("acc", "wdec"):
        res = protection.compute_campaign(params, rates=(1e-2, 1e-1),
                                          trials=2, key=4, target=target,
                                          probe_m=16, device="cpu")
        assert res.clean == 0.0 and res.metric == "abft_coverage"
        assert res.target == "compute"
        assert [r[0] for r in res.coverage_rows] == ["fc/w"]
        assert all(0.0 <= v <= 1.0 for row in res.grid for v in row)
        assert res.coverage_rows[0][2] > 0


# ---------------------------------------------------------------------------
# the quick campaign: a CNN the port trains, device grid vs host oracle
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def quick_cnn():
    return ce.train_cnn_wot("resnet18", pre_steps=40, wot_steps=10,
                            scale=0.125, img=16, device="cpu")


def test_quick_campaign_device_host_parity(quick_cnn):
    """2 rates x 2 trials on the port's WOT-trained ResNet18: the device
    campaign and the host oracle agree statistically (same grid,
    independent streams), as in the reference's test. Nothing is
    written to disk."""
    params, fwd, tmpl = quick_cnn
    rates, trials = (1e-3, 1e-2), 2
    dev = ce.run_scheme_campaign(params, fwd, tmpl, "in-place", rates=rates,
                                 trials=trials, img=16, batch="scan", key=0,
                                 device="cpu")
    hst = protection.run_campaign_host(
        params, lambda p, x: fwd(p, ce._norm(x)), tmpl,
        ce.eval_policy("in-place"), rates=rates, trials=trials, seed=0,
        img=16, device="cpu")
    assert abs(dev.clean - hst.clean) < 1e-6
    assert dev.clean > 0.6
    for r, d_dev, d_host in zip(rates, dev.drop(), hst.drop()):
        assert abs(d_dev - d_host) <= 0.25, (r, d_dev, d_host)
    assert dev.drop()[0] <= 0.15 and hst.drop()[0] <= 0.15
    assert dev.space_overhead == 0.0 == hst.space_overhead
    assert dev.compile_s > 0.0 and hst.compile_s == 0.0
    assert ce.large_count(params) == 0
    # the one-cell host oracle agrees with the host grid's cell
    acc, ovh = ce.eval_with_scheme(params, fwd, tmpl, "in-place", rates[1],
                                   0 + 1000 * 1 + 1, img=16)
    assert (acc, ovh) == (hst.grid[1][1], 0.0)


# ---------------------------------------------------------------------------
# the serve CLI's smoke-check and the Table-2 script
# ---------------------------------------------------------------------------


def test_serve_cli_smoke_check_writes_the_reference_keys(tmp_path, capsys):
    out = tmp_path / "campaign.json"
    r = serve.main(["--device", "cpu", "--tokens", "2", "--batch", "2",
                    "--fault-rate", "1e-4", "--trials", "2",
                    "--campaign-key", "5", "--campaign-out", str(out)])
    rec = json.loads(out.read_text())
    assert sorted(rec) == sorted(["trials", "campaign_key", "rates", "scheme",
                                  "batch", "fidelity_mean", "due_mean"])
    assert rec["campaign_key"] == 5 and rec["trials"] == 2
    assert rec["rates"] == [1e-5, 1e-4, 1e-3] and rec["batch"] == "scan"
    fid, due = r["smoke_check"]
    assert rec["fidelity_mean"] == list(fid.mean())
    assert rec["due_mean"] == list(due.mean())
    assert all(0.99 < m <= 1.0 for m in rec["fidelity_mean"])
    text = capsys.readouterr().out
    assert "fault smoke-check (in-place, scan campaign" in text
    # the same digest lines as the reference's
    assert jserve.fault_smoke_check.__code__.co_varnames[:4] == \
        serve.fault_smoke_check.__code__.co_varnames[:4]


def test_fault_injection_script_prints_the_reference_lines(tmp_path, capsys):
    from repro_torch.benchmarks import fault_injection
    path = tmp_path / "t2.json"
    fault_injection.main(["--device", "cpu", "--trials", "1", "--scale",
                          "0.125", "--img", "16", "--pre-steps", "2",
                          "--wot-steps", "2", "--json", str(path)])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("table2_")]
    assert [ln.split(",")[0] for ln in lines] == \
        [f"table2_resnet18_{s}" for s in SCHEMES]
    rec = json.loads(path.read_text())
    assert sorted(rec) == sorted(f"resnet18/{s}" for s in SCHEMES)
    assert jprot.CampaignResult.from_dict(rec["resnet18/in-place"]).trials == 1
    # --policy adds the reference's "policy:<preset>" row; its space
    # overhead is the reference plan's over the same ResNet18 shapes
    res = fault_injection.main(["--device", "cpu", "--trials", "1",
                                "--scale", "0.125", "--img", "16",
                                "--pre-steps", "2", "--wot-steps", "2",
                                "--policy", "all-secded72"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("table2_")]
    assert lines[-1].startswith("table2_resnet18_policy:all-secded72,")
    from repro.models import cnn as jcnn
    shapes = jax.eval_shape(lambda: jcnn.init_resnet18(
        jax.random.PRNGKey(0), n_classes=N_CLASSES, scale=0.125,
        img_size=16))
    summ = jprot.get_policy_preset("all-secded72", predicate=_ndim2).plan(
        shapes).summary()
    want = (summ["protected_bytes"] - summ["weight_bytes"]) / \
        summ["weight_bytes"]
    ovh, row, _ = res[("resnet18", "policy:all-secded72")]
    assert ovh == pytest.approx(want, rel=1e-12) and len(row) == len(
        fault_injection.RATES)
    with pytest.raises(SystemExit):
        fault_injection.main(["--device", "cpu", "--policy", "mixed"])


def test_table1_and_figure_scripts_print_the_reference_lines(tmp_path,
                                                             capsys):
    """Table 1 + Fig 1 (weight distribution) and Figs 3-4 (WOT
    convergence) at a tiny size: the reference's CSV line names, the
    percentages summing to 100, the constraint met at the end."""
    from repro_torch.benchmarks import weight_distribution, wot_training
    rows = weight_distribution.main(["--device", "cpu", "--steps", "2",
                                     "--scale", "0.125", "--img", "32",
                                     "--json", str(tmp_path / "t1.json")])
    assert [r[0] for r in rows] == ["vgg16", "resnet18", "squeezenet"]
    for _, _, n, _, _, pct, hist in rows:
        assert n > 0 and abs(sum(pct.values()) - 100.0) < 1e-6
        assert len(hist) == 8
    us, base, final, curve, n0 = wot_training.main(
        ["--device", "cpu", "--pre-steps", "3", "--wot-steps", "4",
         "--scale", "0.125", "--img", "16"])
    assert n0 > 0 and [c[0] for c in curve] == [0, 1, 2, 3]
    out = capsys.readouterr().out.splitlines()
    assert [ln.split(",")[0] for ln in out if ln.startswith("table1_")] == \
        ["table1_vgg16", "table1_resnet18", "table1_squeezenet"]
    assert any(ln.startswith("fig3_fig4_wot,") and "large_final=0" in ln
               for ln in out)
    assert sorted(json.loads((tmp_path / "t1.json").read_text())) == \
        ["resnet18", "squeezenet", "vgg16"]
