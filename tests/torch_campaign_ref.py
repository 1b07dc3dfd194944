"""Shared helper of ``test_torch_campaign_ref.py``: the port's host campaign
(``run_campaign_host``) against the reference's on the same VGG16 weights
(the reference's ``init_vgg16`` through NumPy), the same eval batch and
the same NumPy fault seeds.

The reference's eager encode and decode compile op by op for each leaf
shape on the CPU, so the net is VGG16 at width 1/64: every conv has 8
channels (the reference's floor), five leaf shapes in all, the (64, 4)
head flat-padded.
"""
import functools

import jax
import numpy as np

from repro import protection as jprot
from repro.data import synthetic as jsyn
from repro.models import cnn as jcnn
from repro.training import cnn_experiments as jce
from repro_torch import convert, protection
from repro_torch.models import cnn
from repro_torch.training import cnn_experiments as ce

IMG, EVAL_BATCH, RATES, TRIALS, SEED = 32, 128, (1e-3, 1e-2), 2, 5
SCALE = 1 / 64


@functools.lru_cache(maxsize=None)
def vgg():
    """(reference params, jitted reference forward, port params, templates)"""
    p = jax.jit(functools.partial(jcnn.init_vgg16, n_classes=4,
                                  scale=SCALE, img_size=IMG))(
        jax.random.PRNGKey(1))
    _, tmpl = jsyn.image_batch(4, 8, IMG, seed=0, step=0)
    jfwd = jax.jit(lambda q, x: jcnn.vgg16(q, jce._norm(x)))
    mine = convert.params_from_numpy(jax.tree.map(np.asarray, p),
                                     device="cpu")
    return p, jfwd, mine, tmpl


def check_host_grid(scheme):
    """The port's host grid equals the reference's cell for cell, with
    equal ``clean`` and ``space_overhead``."""
    p, jfwd, mine, tmpl = vgg()
    want = jprot.run_campaign_host(p, jfwd, tmpl, jce.eval_policy(scheme),
                                   rates=RATES, trials=TRIALS, seed=SEED,
                                   img=IMG, eval_batch=EVAL_BATCH)
    got = protection.run_campaign_host(
        mine, lambda q, x: cnn.vgg16(q, ce._norm(x)), tmpl,
        ce.eval_policy(scheme), rates=RATES, trials=TRIALS, seed=SEED,
        img=IMG, eval_batch=EVAL_BATCH, device="cpu")
    assert got.grid == want.grid
    assert got.clean == want.clean
    assert got.space_overhead == want.space_overhead
    assert (got.scheme, got.metric, got.batch) == (want.scheme, want.metric,
                                                   "host")
    return got
