"""The port's fused KV write (``kernels/kv_write.py``) against the
reference's KV write: ``serving/kvcache.py::_encode_kv`` followed by
``_write_token`` (a decode token) or ``_write_pages`` (a prefill of whole
pages), on numpy inputs from a seed, under the three KV schemes. Pages and
check planes must be byte-equal, scales bit-equal, and every byte the write
does not own untouched. The ``kv_write`` wrapper on CPU tensors (the
"cuda" route of ``kvcache._write_kv`` on the CPU) must equal the plain
version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import kvcache as jkv
from repro_torch.kernels import kv_write
from repro_torch.serving import kvcache

SCHEMES = ["faulty", "parity-zero", "in-place"]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pools(rng, n_pages, ps, kv, hd, scheme):
    """K and V pools full of random bytes and scales (so bytes the write
    does not own must come back unchanged): [(pages, checks | None,
    scales)] * 2 as numpy arrays."""
    out = []
    for _ in range(2):
        pages = rng.integers(0, 256, (n_pages, ps, kv, hd), dtype=np.uint8)
        checks = (rng.integers(0, 256, (n_pages, ps, kv, hd // 8),
                               dtype=np.uint8)
                  if scheme == "parity-zero" else None)
        scales = rng.standard_normal((n_pages, ps)).astype(np.float32)
        out.append((pages, checks, scales))
    return out


def _tokens(rng, shape):
    """K and V (B, T, kv, hd) f32 with a wide spread of token absmaxes and
    values past the WOT bounds in every block."""
    x = rng.standard_normal((2, *shape)).astype(np.float32)
    x *= np.exp(rng.uniform(-3, 3, (2, *shape[:2], 1, 1))).astype(np.float32)
    return x[0], x[1]


def _reference(k, v, pools, table, pos, scheme, jdt):
    """The reference's write of K then V -> ([(pages, checks, scales)] * 2,
    [(enc, checks, scale)] * 2) as numpy."""
    pol = jkv.KVProtectionPolicy(scheme=scheme)
    written, encoded = [], []
    for x, (pg, ch, sc) in zip((k, v), pools):
        xj = jnp.asarray(x).astype(jdt)
        jch = None if ch is None else jnp.asarray(ch)
        if pos is None:
            e, c, s = jkv._encode_kv(xj, pol)
            res = jkv._write_pages(jnp.asarray(pg), jch, jnp.asarray(sc),
                                   jnp.asarray(table), e, c, s)
        else:
            e, c, s = jkv._encode_kv(xj[:, 0], pol)
            res = jkv._write_token(jnp.asarray(pg), jch, jnp.asarray(sc),
                                   jnp.asarray(table), e, c, s,
                                   jnp.asarray(pos))
        written.append([None if a is None else np.asarray(a) for a in res])
        encoded.append([None if a is None else np.asarray(a)
                        for a in (e, c, s)])
    return written, encoded


def _port_args(k, v, pools, table, tdt, pos=None):
    """The operands of ``kv_write`` as tensors, the pools copied."""
    ops = []
    for pg, ch, sc in pools:
        ops += [torch.from_numpy(pg.copy()),
                None if ch is None else torch.from_numpy(ch.copy()),
                torch.from_numpy(sc.copy())]
    return (torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt), *ops,
            torch.from_numpy(table),
            None if pos is None else torch.from_numpy(pos))


def _port(fn, k, v, pools, table, pos, scheme, tdt, copy):
    """``fn`` (kv_write or kv_write_plain) on copies of the pools ->
    (the pools as numpy after the write, the copies it returned)."""
    args = _port_args(k, v, pools, table, tdt, pos)
    got = fn(*args, scheme=scheme, copy=copy)
    pools_out = [[None if a is None else a.numpy() for a in args[i:i + 3]]
                 for i in (2, 5)]
    return pools_out, got


def _assert_written(got, want):
    for side_got, side_want in zip(got, want):
        pg, ch, sc = side_got
        wpg, wch, wsc = side_want
        np.testing.assert_array_equal(pg, wpg)
        assert (ch is None) == (wch is None)
        if ch is not None:
            np.testing.assert_array_equal(ch, wch)
        assert sc.tobytes() == np.asarray(wsc, np.float32).tobytes()


def _decode_case(seed, kv, hd, ps=8):
    """Four rows through a shuffled table: rows 0 and 1 share their first
    page (row 0 writes into it, row 1 past it), row 2 is idle on its
    parking page (its whole row points there) and row 3 writes at a ragged
    position of its last page."""
    rng = np.random.default_rng(seed)
    b, npg = 4, 4
    n_pages = b + b * npg + 2
    table = (rng.permutation(n_pages - b)[: b * npg] + b).reshape(b, npg)
    table = table.astype(np.int32)
    table[1, 0] = table[0, 0]
    table[2, :] = 2                                 # parking page of slot 2
    pos = np.array([5, 2 * ps + 3, 0, npg * ps - 2], np.int32)
    k, v = _tokens(rng, (b, 1, kv, hd))
    return rng, n_pages, table, pos, k, v


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("kv,hd", [(2, 16), (4, 32), (1, 128)])
def test_decode_write_matches_the_reference(kv, hd, scheme, dtype):
    rng, n_pages, table, pos, k, v = _decode_case(kv * hd, kv, hd)
    pools = _pools(rng, n_pages, 8, kv, hd, scheme)
    jdt, tdt = DTYPES[dtype]
    want, enc = _reference(k, v, pools, table, pos, scheme, jdt)
    for fn in (kv_write.kv_write_plain, kv_write.kv_write):
        got, copies = _port(fn, k, v, pools, table, pos, scheme, tdt, True)
        _assert_written(got, want)
        for i, (e, c, s) in enumerate(enc):   # (B, 1, ...) copies
            np.testing.assert_array_equal(copies[3 * i].numpy()[:, 0], e)
            if c is None:
                assert copies[3 * i + 1] is None
            else:
                np.testing.assert_array_equal(copies[3 * i + 1].numpy()[:, 0],
                                              c)
            assert copies[3 * i + 2].numpy()[:, 0].tobytes() == \
                np.asarray(s, np.float32).tobytes()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("s", [37, 16])
def test_prefill_write_matches_the_reference(s, scheme, dtype):
    """A prompt of ``s`` tokens zero-padded to whole pages (as
    ``paged_gqa_prefill`` pads it) and written from position 0 through a
    shuffled table; the copies are the reference's encoded tokens."""
    rng = np.random.default_rng(s + len(scheme))
    b, kv, hd, ps, npg = 3, 2, 32, 8, 6
    n_pages = b * npg + 3
    table = (rng.permutation(n_pages)[: b * npg]).reshape(b, npg)
    table = table.astype(np.int32)
    k, v = _tokens(rng, (b, s, kv, hd))
    pad = (-s) % ps
    k = np.pad(k, ((0, 0), (0, pad), (0, 0), (0, 0)))
    v = np.pad(v, ((0, 0), (0, pad), (0, 0), (0, 0)))
    pools = _pools(rng, n_pages, ps, kv, hd, scheme)
    jdt, tdt = DTYPES[dtype]
    want, enc = _reference(k, v, pools, table, None, scheme, jdt)
    for fn in (kv_write.kv_write_plain, kv_write.kv_write):
        got, copies = _port(fn, k, v, pools, table, None, scheme, tdt, True)
        _assert_written(got, want)
        for i, (e, c, sc) in enumerate(enc):
            np.testing.assert_array_equal(copies[3 * i].numpy(), e)
            if c is not None:
                np.testing.assert_array_equal(copies[3 * i + 1].numpy(), c)
            assert copies[3 * i + 2].numpy().tobytes() == \
                np.asarray(sc, np.float32).tobytes()
        assert fn(*_port_args(k, v, pools, table, tdt),
                  scheme=scheme) is None       # no copy asked: None


def test_zero_and_tiny_tokens_take_the_eps_scale():
    """An all-zero token takes the eps clamp (scale 1e-12 / 127, q 0); a
    token of subnormal-small values quantizes against it too."""
    rng, n_pages, table, pos, k, v = _decode_case(7, 2, 16)
    k[0] = 0.0
    v[1] = 1e-30
    for scheme in SCHEMES:
        pools = _pools(rng, n_pages, 8, 2, 16, scheme)
        want, _ = _reference(k, v, pools, table, pos, scheme, jnp.float32)
        got, _ = _port(kv_write.kv_write, k, v, pools, table, pos, scheme,
                       torch.float32, False)
        _assert_written(got, want)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_write_kv_routes_by_the_policy_backend(backend, monkeypatch):
    """``kvcache._write_kv`` takes the wrapper on the "cuda" route and the
    plain version on "torch"; on CPU tensors both write the same bytes."""
    rng, n_pages, table, pos, k, v = _decode_case(11, 2, 16)
    pools = _pools(rng, n_pages, 8, 2, 16, "in-place")
    want, _ = _reference(k, v, pools, table, pos, "in-place", jnp.float32)
    called = []
    for name in ("kv_write", "kv_write_plain"):
        real = getattr(kv_write, name)
        monkeypatch.setattr(kv_write, name,
                            lambda *a, _f=real, _n=name, **kw:
                            called.append(_n) or _f(*a, **kw))
    lc = {"k_pages": torch.from_numpy(pools[0][0].copy()),
          "k_scale": torch.from_numpy(pools[0][2].copy()),
          "v_pages": torch.from_numpy(pools[1][0].copy()),
          "v_scale": torch.from_numpy(pools[1][2].copy()),
          "kv_table": torch.from_numpy(table)}
    policy = kvcache.KVProtectionPolicy(scheme="in-place", backend=backend)
    kvcache._write_kv(lc, torch.from_numpy(k), torch.from_numpy(v), policy,
                      pos=torch.from_numpy(pos))
    assert called[0] == ("kv_write" if backend == "cuda"
                         else "kv_write_plain")
    _assert_written([[lc["k_pages"].numpy(), None, lc["k_scale"].numpy()],
                     [lc["v_pages"].numpy(), None, lc["v_scale"].numpy()]],
                    want)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    rng, n_pages, table, pos, k, v = _decode_case(3, 2, 16)
    pools = _pools(rng, n_pages, 8, 2, 16, "in-place")
    args = list(_port_args(k, v, pools, table, torch.float32))
    pos_t = torch.from_numpy(pos)
    with pytest.raises(ValueError):      # a decode write of two tokens
        two = torch.cat([args[0], args[0]], 1)
        kv_write.kv_write(two, two, *args[2:-1], pos_t)
    with pytest.raises(ValueError):      # a prefill of part of a page
        kv_write.kv_write(*args[:-1], None)
    with pytest.raises(ValueError):      # check planes under in-place
        bad = list(args)
        bad[3] = torch.zeros((n_pages, 8, 2, 2), dtype=torch.uint8)
        kv_write.kv_write(*bad[:-1], pos_t)
    with pytest.raises(ValueError):
        kv_write.kv_write(*args[:-1], pos_t, scheme="secded72")
    with pytest.raises(ValueError):      # head_dim not a multiple of 8
        kv_write.kv_write(args[0][..., :12], args[1][..., :12], *args[2:-1],
                          pos_t)
