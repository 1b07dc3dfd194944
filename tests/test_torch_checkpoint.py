"""The port's checkpoints (``repro_torch.training.checkpoint``) against the
reference's: the reference's four cases ported (round trip and rotation,
the protected error bound, async, resume after a simulated failure), the
two packages' files interchangeable (arrays equal leaf for leaf, protected
and not, each restores the other's, the meta equal but ``treedef``), the
tree order of ``(params, SgdState)``, ``(params, AdamState)`` and
``AdmmState`` and its protected decisions equal to the reference's, the
async snapshot immune to the in-place train step, single flips in a stored
image corrected on restore, and the train CLI's ``--ckpt`` resume.

Weights come from the reference's ``lm.init_params`` through NumPy."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as P
from repro.core import wot as jwot
from repro.training import admm as jadmm
from repro.training import checkpoint as jck
from repro.training import optim as joptim
from repro_torch import configs, convert, tree
from repro_torch.core import quant, wot
from repro_torch.launch import train as launch_train
from repro_torch.training import admm, checkpoint, optim, train

ARCH = "deepseek-7b"


def _momentum(p):
    return jax.tree.map(lambda a: (0.01 * np.random.default_rng(a.size)
                                   .standard_normal(a.shape)).astype(
        np.float32), p)


def _state(p, m):
    """The same ``(params, SgdState)`` in both packages."""
    return ((P.jax_params(p), joptim.SgdState(P.jax_params(m))),
            (P.port_params(p), convert.sgd_state_from_numpy(m, device="cpu")))


def _files(d, step):
    d = os.path.join(d, f"step_{step:08d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    return np.load(os.path.join(d, "arrays.npz")), meta


def _equal(port_tree, other) -> bool:
    """Every leaf bit-equal, in ``repro_torch.tree`` order."""
    a = [t for _, t in tree.leaves_with_path(port_tree)]
    b = [t for _, t in tree.leaves_with_path(other)]
    return len(a) == len(b) and all(
        np.asarray(x).tobytes() == np.asarray(y).tobytes()
        for x, y in zip(a, b))


def _np(t):
    return tree.map_with_path(lambda _, x: x.numpy(), t)


# ---------------------------------------------------------------------------
# the reference's cases
# ---------------------------------------------------------------------------


def test_roundtrip_and_rotation(tmp_path):
    t = {"a": torch.arange(100, dtype=torch.float32).reshape(10, 10),
         "b": {"c": torch.ones((3,))}}
    for s in (1, 2, 3, 4):
        checkpoint.save(str(tmp_path), t, step=s, keep=2, device="cpu")
    assert checkpoint.latest_step(str(tmp_path)) == 4
    assert len(os.listdir(tmp_path)) == 2  # rotation
    restored, step = checkpoint.restore(str(tmp_path), t, device="cpu")
    assert step == 4
    assert torch.equal(restored["a"], t["a"])
    assert torch.equal(restored["b"]["c"], t["b"]["c"])


def test_protected_checkpoint_quantization_error_bounded(tmp_path):
    rng = np.random.default_rng(0)
    t = {"w": torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))}
    checkpoint.save(str(tmp_path), t, step=1, protected=True,
                    device="cpu")
    restored, _ = checkpoint.restore(str(tmp_path), t, device="cpu")
    scale = float(t["w"].abs().max()) / 127
    # int8 quantization + WOT throttle error bound
    err = (restored["w"] - t["w"]).abs().numpy()
    assert err.max() <= scale * 64  # throttled worst case
    assert np.percentile(err, 95) <= scale  # bulk within one step


def test_async_checkpointer(tmp_path):
    ck = checkpoint.AsyncCheckpointer(str(tmp_path), device="cpu")
    ck.save({"w": torch.ones((32, 32))}, 1)
    ck.wait()
    assert checkpoint.latest_step(str(tmp_path)) == 1


def test_resume_after_simulated_failure(tmp_path):
    """Train 4 steps with a checkpoint at 2, 'crash', resume from step 2:
    the resumed run's masters equal the uninterrupted run's bit for bit
    (the reference holds its own within 1e-6)."""
    cfg = configs.get_smoke(ARCH).with_(microbatch=1)
    params = P.port_params(P.reference_params(ARCH))
    opt = optim.sgd_init(params)
    step = train.make_train_step(cfg, lr=1e-3, chunk=16)

    def run(params, opt, start, end):
        for s in range(start, end):
            b = P.synthetic.token_batch(cfg.vocab_padded, 2, 16, seed=3,
                                        step=s)
            params, opt, _ = step(params, opt, {
                k: torch.from_numpy(v) for k, v in b.items()})
        return params, opt

    p, o = run(params, opt, 0, 2)
    checkpoint.save(str(tmp_path), (p, o), step=2, device="cpu")
    p_full, _ = run(p, o, 2, 4)        # uninterrupted (updates p in place)
    (p_res, o_res), s0 = checkpoint.restore(str(tmp_path), (p, o),
                                            device="cpu")
    assert s0 == 2
    p_resumed, _ = run(p_res, o_res, s0, 4)   # crash + resume
    assert _equal(p_resumed, p_full)


# ---------------------------------------------------------------------------
# the two packages' files
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("protected", [False, True])
def test_save_equals_reference_leaf_for_leaf(tmp_path, protected):
    """``(params, SgdState)`` of deepseek-7b smoke with a seeded momentum:
    every array of ``arrays.npz`` byte-equal to the reference's save, and
    ``meta.json`` equal but its free-text ``treedef``. Protected, the
    momentum of every protected weight is quantized too, as the reference
    decides (its NamedTuple field reads as "")."""
    p = P.reference_params(ARCH)
    jstate, tstate = _state(p, _momentum(p))
    jck.save(str(tmp_path / "ref"), jstate, step=3, protected=protected)
    checkpoint.save(str(tmp_path / "port"), tstate, step=3,
                    protected=protected, device="cpu")
    ra, rm = _files(str(tmp_path / "ref"), 3)
    ta, tm = _files(str(tmp_path / "port"), 3)
    assert sorted(ra.files) == sorted(ta.files)
    for k in ra.files:
        assert ra[k].dtype == ta[k].dtype and ra[k].shape == ta[k].shape, k
        assert ra[k].tobytes() == ta[k].tobytes(), k
    rm.pop("treedef")
    tm.pop("treedef")
    assert rm == tm
    n_prot = sum(1 for k, v in tm.items()
                 if k.startswith("leaf_") and v["protected"])
    assert n_prot == (18 if protected else 0)   # 9 weights + 9 momenta


@pytest.mark.parametrize("protected", [False, True])
def test_checkpoints_restore_across_packages(tmp_path, protected):
    """The reference's checkpoint restores in the port and the port's in
    the reference, to the values each package restores from its own."""
    p = P.reference_params(ARCH)
    jstate, tstate = _state(p, _momentum(p))
    jck.save(str(tmp_path / "ref"), jstate, step=1, protected=protected)
    checkpoint.save(str(tmp_path / "port"), tstate, step=1,
                    protected=protected, device="cpu")
    own_r, _ = jck.restore(str(tmp_path / "ref"), jstate)
    port_from_ref, s = checkpoint.restore(str(tmp_path / "ref"), tstate,
                                          device="cpu")
    assert s == 1
    assert isinstance(port_from_ref[1], optim.SgdState)
    assert _equal(port_from_ref, jax.tree.map(np.asarray, own_r))
    own_t, _ = checkpoint.restore(str(tmp_path / "port"), tstate,
                                  device="cpu")
    ref_from_port, _ = jck.restore(str(tmp_path / "port"), jstate)
    assert _equal(own_t, jax.tree.map(np.asarray, ref_from_port))
    if not protected:
        assert _equal(own_t, _np(tstate))


def _ref_paths(t):
    """The reference's flatten order as 'a/b' names and its protected
    decisions."""
    from repro.protection.policy import path_str
    return [(path_str(k), jwot.is_protected_weight(k, x))
            for k, x in jax.tree_util.tree_flatten_with_path(t)[0]]


def _port_paths(t):
    return [(tree.path_str(k), wot.is_protected_weight(k, x))
            for k, x in tree.leaves_with_path(t)]


def test_tree_order_and_protection_match_reference():
    """``(params, SgdState)``, ``(params, AdamState)`` and ``AdmmState``:
    the same leaves in the same order, each with the same
    ``is_protected_weight`` decision."""
    p = P.reference_params(ARCH)
    jp, tp = P.jax_params(p), P.port_params(p)
    cases = [((jp, joptim.sgd_init(jp)), (tp, optim.sgd_init(tp))),
             ((jp, joptim.adam_init(jp)), (tp, optim.adam_init(tp))),
             (jadmm.admm_init(jp), admm.admm_init(tp))]
    for jt, tt in cases:
        want = _ref_paths(jt)
        assert _port_paths(tt) == want
        assert any(d for _, d in want) and not all(d for _, d in want)
    # a tuple and a NamedTuple map back to their own types
    back = tree.map_with_path(lambda _, x: x, cases[1][1])
    assert type(back) is tuple and type(back[1]) is optim.AdamState


# ---------------------------------------------------------------------------
# the port's own properties
# ---------------------------------------------------------------------------


def test_async_snapshot_is_immune_to_the_in_place_step(tmp_path):
    """The train step updates masters and momentum in place: a save started
    just before a step must hold the values from before it."""
    cfg = configs.get_smoke(ARCH).with_(microbatch=1)
    params = P.port_params(P.reference_params(ARCH))
    opt = optim.sgd_init(params)
    step = train.make_train_step(cfg, lr=1e-2, chunk=16)
    b = {k: torch.from_numpy(v) for k, v in P.token_batch(ARCH, 2, 16).items()}
    params, opt, _ = step(params, opt, b)
    before = _np(tree.map_with_path(lambda _, x: x.clone(), (params, opt)))
    ck = checkpoint.AsyncCheckpointer(str(tmp_path), device="cpu")
    ck.save((params, opt), 1)
    params, opt, _ = step(params, opt, b)       # in place, at once
    ck.wait()
    restored, _ = checkpoint.restore(str(tmp_path), (params, opt),
                                     device="cpu")
    assert _equal(restored, before)
    assert not _equal(restored, _np((params, opt)))


def test_single_flips_in_a_stored_image_are_corrected(tmp_path):
    """Flip one bit in each of 64 blocks of every protected image on disk:
    the restore equals the clean one (the checkpoint itself is
    protected)."""
    p = P.reference_params(ARCH)
    _, tstate = _state(p, _momentum(p))
    checkpoint.save(str(tmp_path), tstate, step=1, protected=True,
                    device="cpu")
    clean, _ = checkpoint.restore(str(tmp_path), tstate, device="cpu")
    arrays, meta = _files(str(tmp_path), 1)
    arrays = {k: arrays[k].copy() for k in arrays.files}
    rng = np.random.default_rng(0)
    n = 0
    for i in range(meta["n_leaves"]):
        if not meta[f"leaf_{i}"]["protected"]:
            continue
        img = arrays[f"leaf_{i}"].reshape(-1, 8)
        blocks = rng.choice(img.shape[0], size=64, replace=False)
        img[blocks, rng.integers(0, 8, 64)] ^= np.uint8(1) << \
            rng.integers(0, 8, 64).astype(np.uint8)
        n += 1
    assert n == 18
    np.savez(os.path.join(str(tmp_path), "step_00000001", "arrays.npz"),
             **arrays)
    got, _ = checkpoint.restore(str(tmp_path), tstate, device="cpu")
    assert _equal(got, _np(clean))


def test_protected_restore_is_scale_times_throttled_q(tmp_path):
    """A protected leaf restores as f32(scale) x the throttled int8 of the
    saved value, exactly: the reference's own sequence, recomputed here
    with the port's quantizer (a tensor divisor: a true division)."""
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (24, 40)).astype(np.float32) * 3)
    checkpoint.save(str(tmp_path), {"w": w}, step=1, protected=True,
                    device="cpu")
    got, _ = checkpoint.restore(str(tmp_path), {"w": w}, device="cpu")
    scale = torch.tensor(np.float32(float(w.abs().max()) / quant.QMAX))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    q = wot.throttle_q(q.reshape(-1)).reshape(w.shape)
    assert torch.equal(got["w"], q.to(torch.float32) * scale)


def test_train_cli_resumes_from_its_checkpoint(tmp_path, capsys):
    """``--ckpt DIR --ckpt-every 2``: a 2-step run leaves step 2 under DIR;
    a 4-step run resumes from it and runs steps 2 and 3 only."""
    d = str(tmp_path / "ck")
    argv = ["--device", "cpu", "--ckpt", d, "--ckpt-every", "2"]
    first = launch_train.main(argv + ["--steps", "2"])
    assert first["start"] == 0 and len(first["losses"]) == 2
    assert checkpoint.latest_step(d) == 2
    second = launch_train.main(argv + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert second["start"] == 2 and len(second["losses"]) == 2
    assert np.isfinite(second["losses"]).all()
    assert checkpoint.latest_step(d) == 4
