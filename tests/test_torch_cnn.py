"""The paper's CNNs and their training in the port, held to the reference:
the synthetic images, leaf order and paths, the three forwards (XLA's
asymmetric SAME padding included), one QATT step (QAT, SGD, throttle) and
one Adam step from identical params, and WOT fine-tuning's constraint.

Reference weights come from the reference's ``init_*`` through NumPy
(``repro_torch.convert``): the two packages cannot share random streams.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as jsyn
from repro.models import cnn as jcnn
from repro.protection.policy import path_str as jpath_str
from repro.training import optim as joptim
from repro.training import train as jtrain
from repro_torch import configs, convert, tree
from repro_torch.data import synthetic
from repro_torch.models import cnn
from repro_torch.training import cnn_experiments as ce
from repro_torch.training import optim, train

# the forwards: f32 logits of both packages, summed in different orders
LOGIT_ATOL = 1e-4
# one training step from identical params (QATT and Adam)
STEP_ATOL = 1e-5
SCALE = 0.125


@functools.lru_cache(maxsize=None)
def _reference_params(name, n_classes=4):
    init, _ = jcnn.CNNS[name]
    p = jax.jit(functools.partial(init, n_classes=n_classes, scale=SCALE,
                                  img_size=32))(jax.random.PRNGKey(3))
    return jax.tree.map(np.asarray, p)


def _port(p_np):
    return convert.params_from_numpy(p_np, device="cpu")


def _images(n, img, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, img, img, 3)).astype(np.float32)


def test_cnn_ids_and_models_match_the_reference():
    from repro import configs as jconfigs
    assert configs.CNN_IDS == jconfigs.CNN_IDS
    assert sorted(cnn.CNNS) == sorted(jcnn.CNNS) == sorted(configs.CNN_IDS)


@pytest.mark.parametrize("img,step,with_tmpl", [(16, 0, False), (33, 5, True)])
def test_image_batch_is_byte_equal(img, step, with_tmpl):
    tmpl = None
    if with_tmpl:
        _, tmpl = jsyn.image_batch(4, 2, img, seed=9, step=0)
    ref, rt = jsyn.image_batch(4, 12, img, seed=9, step=step, templates=tmpl)
    got, gt = synthetic.image_batch(4, 12, img, seed=9, step=step,
                                    templates=tmpl)
    for k in ("images", "labels"):
        assert got[k].dtype == ref[k].dtype
        assert got[k].tobytes() == ref[k].tobytes()
    assert gt.tobytes() == rt.tobytes()


@pytest.mark.parametrize("name", sorted(jcnn.CNNS))
def test_leaf_order_and_paths_equal_jax_tree_util(name):
    """Lists walk in index order, dicts sorted, as ``jax.tree_util``
    flattens them; paths join indices as the reference's ``path_str``."""
    ref = _reference_params(name)
    want = [(jpath_str(k), v.shape) for k, v in
            jax.tree_util.tree_flatten_with_path(ref)[0]]
    mine = _port(ref)
    got = [(tree.path_str(p), tuple(t.shape))
           for p, t in tree.leaves_with_path(mine)]
    assert got == want
    # the port's own init draws its own stream into the same shapes
    init, _ = cnn.CNNS[name]
    own = init(0, n_classes=4, scale=SCALE, img_size=32, device="cpu")
    assert [(tree.path_str(p), tuple(t.shape), t.dtype)
            for p, t in tree.leaves_with_path(own)] == \
        [(p, s, torch.float32) for p, s in want]


def test_tree_walks_lists_past_ten_in_index_order():
    t = {"convs": [{"w": i} for i in range(12)], "b": 0}
    paths = [tree.path_str(p) for p, _ in tree.leaves_with_path(t)]
    assert paths == ["b"] + [f"convs/{i}/w" for i in range(12)]
    assert tree.map_with_path(lambda p, x: x, t) == t
    assert tree.unflatten_like(t, range(13)) == {
        "b": 0, "convs": [{"w": i + 1} for i in range(12)]}


@pytest.mark.parametrize("name", sorted(jcnn.CNNS))
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "qat"])
def test_cnn_forward_matches_reference(name, quantized):
    """Logits within LOGIT_ATOL at input 32 (SAME at stride 2 pads one more
    after than before) and 33 (symmetric), identity and QAT ``wt``."""
    ref = _reference_params(name)
    mine = _port(ref)
    jfwd = jax.jit(functools.partial(
        jcnn.CNNS[name][1], wt=jtrain.qat_wt if quantized else jcnn.Identity))
    wt = train.qat_wt if quantized else cnn.Identity
    for img in (32, 33):
        x = _images(3, img)
        want = np.asarray(jfwd(ref, jnp.asarray(x)))
        with torch.no_grad():
            got = cnn.CNNS[name][1](mine, torch.from_numpy(x), wt=wt).numpy()
        assert got.shape == want.shape == (3, 4)
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)


@pytest.mark.parametrize("n", [16, 17])
@pytest.mark.parametrize("k,stride", [(3, 2), (7, 2), (1, 2), (3, 1)])
def test_conv_same_padding_is_xla_s(n, k, stride):
    """XLA's SAME at stride 2 puts the larger half after at even sizes:
    padding symmetrically would shift every output."""
    rng = np.random.default_rng(k * 100 + n)
    x = rng.normal(size=(2, n, n, 3)).astype(np.float32)
    w = rng.normal(size=(k, k, 3, 5)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    want = np.asarray(jcnn.conv({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                jnp.asarray(x), stride=stride))
    got = cnn.conv({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                   torch.from_numpy(x).permute(0, 3, 1, 2), stride=stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-5)
    assert cnn._same_pad(16, 3, 2) == (0, 1)
    assert cnn._same_pad(224, 7, 2) == (2, 3)
    assert cnn._same_pad(17, 3, 2) == (1, 1)


def test_batchnorm_training_statistics_match_reference():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 6, 6, 8)).astype(np.float32) * 3 + 1
    p = {k: rng.normal(size=(8,)).astype(np.float32) for k in
         ("scale", "bias", "mean")}
    p["var"] = rng.uniform(0.5, 2, size=(8,)).astype(np.float32)
    for training in (False, True):
        want = np.asarray(jcnn.batchnorm(jax.tree.map(jnp.asarray, p),
                                         jnp.asarray(x), training))
        got = cnn.batchnorm(_port(p), torch.from_numpy(x).permute(0, 3, 1, 2),
                            training).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _batch(img, n=8, seed=1):
    b, _ = jsyn.image_batch(4, n, img, seed=seed, step=0)
    return b


def test_cnn_train_step_matches_reference():
    """One QATT step of VGG16 (QAT forward, SGD with momentum, the WOT
    throttle) from identical params and momentum: params within
    STEP_ATOL, the loss too, and the throttled weights' q byte-equal. (A
    throttle that clamps a leaf's largest value lowers its scale, so the
    leaf may quantize past the constraint again: WOT converges over steps,
    in both packages.)"""
    from repro.core import quant as jquant
    ref = _reference_params("vgg16")
    b = _batch(32)
    jstep, jeval = jtrain.make_cnn_train_step(
        lambda p, x, wt: jcnn.vgg16(p, x, wt=wt), lr=0.05)
    jp = jax.tree.map(jnp.asarray, ref)
    jp1, jo1, jloss = jstep(jp, joptim.sgd_init(jp),
                            jax.tree.map(jnp.asarray, b))
    step, ev = train.make_cnn_train_step(
        lambda p, x, wt: cnn.vgg16(p, x, wt=wt), lr=0.05)
    tb = convert.params_from_numpy(b, device="cpu")
    p0 = _port(ref)
    p1, o1, loss = step(p0, optim.sgd_init(p0), tb)
    assert abs(float(loss) - float(jloss)) <= STEP_ATOL
    jp1n = jax.tree.map(np.asarray, jp1)
    jo1n = jax.tree.map(np.asarray, jo1.momentum)
    for path, t in tree.leaves_with_path(p1):
        want = tree.get_path(jp1n, path)
        np.testing.assert_allclose(t.numpy(), want, rtol=0, atol=STEP_ATOL,
                                   err_msg=tree.path_str(path))
        np.testing.assert_allclose(tree.get_path(o1.momentum, path).numpy(),
                                   tree.get_path(jo1n, path), rtol=1e-4,
                                   atol=1e-4, err_msg=tree.path_str(path))
        if t.ndim >= 2:   # the throttled weights quantize alike
            q, _ = ce.quant.quantize(t)
            jq, _ = jquant.quantize(jnp.asarray(want))
            assert q.numpy().tobytes() == np.asarray(jq).tobytes(), path
    assert float(ev(p1, tb)) == float(jeval(jp1, jax.tree.map(jnp.asarray,
                                                              b)))


def test_adam_step_matches_reference():
    rng = np.random.default_rng(2)
    params = {"a": [rng.normal(size=(5, 8)).astype(np.float32),
                    {"w": rng.normal(size=(3,)).astype(np.float32)}]}
    grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
        np.float32), params)
    jp, js = jax.tree.map(jnp.asarray, params), None
    js = joptim.adam_init(jp)
    tp = _port(params)
    ts = optim.adam_init(tp)
    for _ in range(3):   # the bias corrections move with the count
        jp, js = joptim.adam_update(jp, jax.tree.map(jnp.asarray, grads), js,
                                    lr=1e-2, wd=1e-3)
        tp, ts = optim.adam_update(tp, _port(grads), ts, lr=1e-2, wd=1e-3)
    assert int(ts.count) == int(js.count) == 3
    assert ts.count.dtype == torch.int32
    for path, t in tree.leaves_with_path(tp):
        np.testing.assert_allclose(t.numpy(), tree.get_path(
            jax.tree.map(np.asarray, jp), path), rtol=0, atol=1e-6)
        for mine, theirs in ((ts.mu, js.mu), (ts.nu, js.nu)):
            np.testing.assert_allclose(
                tree.get_path(mine, path).numpy(),
                tree.get_path(jax.tree.map(np.asarray, theirs), path),
                rtol=1e-6, atol=1e-7)


def test_wot_finetune_meets_the_constraint_and_tracks_figures():
    """The port's pipeline at a tiny size: pretraining leaves large values
    in protected positions, WOT fine-tuning removes them all, and the
    curve has the reference's form."""
    params, fwd, tmpl = ce.pretrain("resnet18", steps=4, scale=SCALE, img=16,
                                    device="cpu")
    assert ce.large_count(params) > 0
    out, tmpl2, curve = ce.wot_finetune(params, fwd, tmpl, steps=3, img=16,
                                        track=True)
    assert ce.large_count(out) == 0
    assert [c[0] for c in curve] == [0, 1, 2]
    assert curve[0][2] is not None and curve[1][2] is None
    assert 0.0 <= ce.accuracy(out, fwd, tmpl, quantized=True, img=16) <= 1.0
    # the throttled masters still quantize to WOT-compliant q
    for _, w in tree.leaves_with_path(out):
        if w.ndim >= 2:
            assert ce.wot.satisfies_constraint(ce.quant.quantize(w)[0]
                                               .reshape(-1))


def test_entry_points_default_to_cuda(monkeypatch):
    from repro_torch.benchmarks import (fault_injection, weight_distribution,
                                        wot_training)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: cnn.init_resnet18(0, scale=SCALE),
                 lambda: ce.pretrain("squeezenet", steps=1),
                 lambda: ce.train_cnn_wot("resnet18", pre_steps=1,
                                          wot_steps=1),
                 lambda: fault_injection.main(["--trials", "1"]),
                 lambda: weight_distribution.main(["--steps", "1"]),
                 lambda: wot_training.main(["--pre-steps", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
