"""Int8 gradient compression with error feedback
(``repro_torch.training.compress``) against the reference's
``repro.training.compress``, bit for bit: ``compress`` (payload, scale and
residual), ``decompress``, ``compress_tree`` over a nested tree, and the
error feedback over repeated rounds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import compress as jcompress
from repro_torch import tree
from repro_torch.training import compress


def _bits(a):
    a = np.asarray(a)
    return a.dtype, a.shape, a.tobytes()


@pytest.mark.parametrize("shape", [(7,), (33, 5), (4, 8, 16)])
def test_compress_and_decompress_are_bit_equal(shape):
    rng = np.random.default_rng(sum(shape))
    g = (rng.standard_normal(shape) * rng.uniform(0.1, 4, shape)).astype(
        np.float32)
    r = (1e-3 * rng.standard_normal(shape)).astype(np.float32)
    q, s, res = compress.compress(torch.from_numpy(g), torch.from_numpy(r))
    jq, js, jres = jcompress.compress(jnp.asarray(g), jnp.asarray(r))
    assert q.dtype == torch.int8
    assert _bits(q.numpy()) == _bits(jq)
    assert _bits(s.numpy()) == _bits(js)
    assert _bits(res.numpy()) == _bits(jres)
    assert _bits(compress.decompress(q, s).numpy()) == \
        _bits(jcompress.decompress(jq, js))


def test_compress_of_zeros_keeps_the_epsilon_scale():
    z = np.zeros((3, 8), np.float32)
    q, s, res = compress.compress(torch.from_numpy(z), torch.from_numpy(z))
    jq, js, jres = jcompress.compress(jnp.asarray(z), jnp.asarray(z))
    assert _bits(q.numpy()) == _bits(jq) and _bits(s.numpy()) == _bits(js)
    assert not res.any()


def test_compress_tree_and_error_feedback_are_bit_equal():
    """Three rounds over a nested tree, each feeding its residuals into the
    next: payloads, scales and residuals equal to the reference's."""
    rng = np.random.default_rng(0)

    def grads():
        return {"a": rng.standard_normal((16, 9)).astype(np.float32),
                "b": {"c": rng.standard_normal((5,)).astype(np.float32),
                      "d": (100 * rng.standard_normal((2, 8))).astype(
                          np.float32)}}
    to_t = lambda t: tree.map_with_path(  # noqa: E731
        lambda _, a: torch.from_numpy(a), t)
    res = jax.tree.map(np.zeros_like, grads())
    tres, jres = to_t(res), jax.tree.map(jnp.asarray, res)
    for _ in range(3):
        g = grads()
        tq, ts, tres = compress.compress_tree(to_t(g), tres)
        jq, js, jres = jcompress.compress_tree(
            jax.tree.map(jnp.asarray, g), jres)
        for got, want in ((tq, jq), (ts, js), (tres, jres)):
            for path, t in tree.leaves_with_path(got):
                assert _bits(t.numpy()) == _bits(tree.get_path(want, path))
