"""The port's request front-end against the reference's, on the CPU in f32.

Same weights (the reference's smoke deepseek-7b, encoded by the reference
and carried across), the same seeded waves and, where faults are tested,
the same NumPy-drawn fault masks XORed into both front-ends' live pools
before chosen steps. f32 on both sides, so a greedy argmax cannot split on
a bf16 rounding: the results, the deterministic telemetry views and the
per-request KV flags must be EQUAL. The reference runs its XLA route (its
fused and chunked KV kernels are Pallas, which does not run on this JAX);
the port's ``in-place-chunked`` front-end is held to the reference's
``in-place`` one, whose init event differs only in ``fused`` and
``attention_impl``.
"""
import dataclasses
import functools
import json

import hypothesis as hyp
import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as P
from repro.serving import frontend as jfe
from repro.serving import kvcache as jkv
from repro.serving import protected as jprot
from repro.serving import telemetry as jtel
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.serving import frontend, kvcache, protected, telemetry

ARCH = "deepseek-7b"
SLOTS, MAX_LEN = 2, 32
# port KV preset -> the reference preset its front-end is held to
REF_KV = {"in-place": "in-place", "parity-zero": "parity-zero",
          "in-place-chunked": "in-place"}
# init fields that name the attention path, not the served result
PATH_FIELDS = ("fused", "attention_impl")


@functools.lru_cache(maxsize=None)
def _ref_step(kv):
    """The reference's jitted f32 serve step with per-slot flags; built
    once per module run and KV preset (the jit compile dominates)."""
    cfg, plan, _, _ = P._reference_model(ARCH)
    kvp = dataclasses.replace(jkv.get_kv_policy(kv), per_slot_flags=True)
    return kvp, jax.jit(jprot.make_serve_step(
        cfg, plan=plan, with_flags=True, kv_policy=kvp, dtype=jnp.float32))


@pytest.fixture(scope="module")
def rig():
    cfg, plan, _, enc = P._reference_model(ARCH)
    port_enc = convert.protected_from_numpy(P.export(enc), device="cpu")
    return cfg, plan, enc, port_enc


def _small_waves(vocab, maker, seed=11):
    """The reference suite's ``_small_waves``."""
    return maker(seed=seed, n_waves=2, wave_size=3, vocab=vocab,
                 prompt_len=(3, 6), max_new=(2, 4), gap_steps=4)


def _masks(cache_shapes, steps, seed=5, rate=3e-3):
    """{step: {pool key: uint8 XOR mask}} drawn with NumPy."""
    rng = np.random.default_rng(seed)
    out = {}
    for t in steps:
        out[t] = {}
        for key, shape in cache_shapes.items():
            bits = rng.random((*shape, 8)) < rate
            out[t][key] = np.packbits(bits, axis=-1, bitorder="little")[
                ..., 0]
    return out


def _ref_burst(rig, kv, waves, *, masks=None, prefix_sharing=False,
               max_len=MAX_LEN, slots=SLOTS):
    """The reference's ``run_burst`` loop with the fault injection replaced
    by the given XOR masks (applied before the step they are keyed by)."""
    cfg, plan, enc, _ = rig
    kvp, step = _ref_step(REF_KV[kv])
    col = jtel.TelemetryCollector()
    fe = jfe.ServingFrontend(cfg, enc, plan=plan, slots=slots,
                             max_len=max_len, kv_policy=kvp, serve_step=step,
                             collector=col, dtype=jnp.float32,
                             prefix_sharing=prefix_sharing)
    pending = sorted(waves, key=lambda r: (r.arrival_step, r.rid))
    i = 0
    for _ in range(10_000):
        while i < len(pending) and pending[i].arrival_step <= fe.step_no:
            fe.submit(pending[i])
            i += 1
        if i >= len(pending) and not fe.queue.peek() and fe.active == 0:
            break
        if masks and fe.step_no in masks:
            fe.cache = {**fe.cache, **{
                k: fe.cache[k] ^ jnp.asarray(m)
                for k, m in masks[fe.step_no].items()}}
        fe.step()
    return col.events, jtel.summarize(col.events), fe.results


def _port_burst(rig, kv, waves, *, masks=None, prefix_sharing=False,
                max_len=MAX_LEN, slots=SLOTS, backend="torch"):
    cfg, _, _, port_enc = rig

    def apply(fe):
        for k, m in (masks or {}).get(fe.step_no, {}).items():
            fe.cache[k] ^= torch.from_numpy(m)

    return frontend.run_burst(
        tconfigs.get_smoke(ARCH), port_enc, waves=waves, slots=slots,
        max_len=max_len, kv_policy=kv, dtype=torch.float32,
        prefix_sharing=prefix_sharing, before_step=apply, backend=backend,
        device="cpu")


def _assert_views_equal(ref_events, port_events, kv):
    ref = jtel.deterministic_view(ref_events)
    got = telemetry.deterministic_view(port_events)
    assert len(ref) == len(got)
    assert ref[0]["event"] == got[0]["event"] == "init"
    if REF_KV[kv] != kv:
        for f in PATH_FIELDS:
            ref[0].pop(f)
            got[0].pop(f)
    assert got == ref


# ---------------------------------------------------------------------------
# host side: queue, allocator, waves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prompt_len,max_new", [
    (3, 4), (28, 4), (30, 8), (40, 20), (1, 1), (64, 1), (20, 44)])
def test_request_queue_rejects_what_the_reference_rejects(prompt_len,
                                                         max_new):
    prompt = tuple(range(1, prompt_len + 1))
    for kw in (dict(max_total_tokens=32, max_pages=2, page_size=16),
               dict(max_total_tokens=64, max_pages=2, page_size=16),
               dict(max_total_tokens=64, max_pages=8, page_size=8)):
        ref = jfe.RequestQueue(**kw).push(jfe.Request(0, prompt, max_new))
        got = frontend.RequestQueue(**kw).push(
            frontend.Request(0, prompt, max_new))
        assert got == ref
    for bad in (dict(prompt=(), max_new=2), dict(prompt=(1,), max_new=0)):
        with pytest.raises(ValueError) as ref_err:
            jfe.Request(rid=0, **bad)
        with pytest.raises(ValueError, match=str(ref_err.value)):
            frontend.Request(rid=0, **bad)


def _alloc_state(a):
    return (a.free_count, a.live_count, a.live_pages(), a.free_pages(),
            {p: a.refcount(p) for p in range(a.n_pages)})


_OPS = st.lists(st.tuples(st.sampled_from(["alloc", "retain", "free",
                                           "free_any", "can"]),
                          st.integers(0, 12), st.integers(0, 3)),
                max_size=60)


@hyp.given(ops=_OPS)
@hyp.settings(max_examples=60, deadline=None)
def test_page_allocator_replays_equal_to_the_reference(ops):
    """A drawn op sequence replayed on both allocators leaves equal state
    after every op and raises the same errors; the port's allocator keeps
    the reference's conservation invariant throughout."""
    ref, got = jkv.PageAllocator(12, reserved=2), kvcache.PageAllocator(
        12, reserved=2)
    for op, x, n in ops:
        live = ref.live_pages()
        if op == "alloc":
            args = (n,)
        elif op == "can":
            args = (x,)
        elif op == "free_any":          # may hit parking, free or bad ids
            args = ((x,) * max(1, n),)
        else:
            args = ((live[x % len(live)],) * max(1, n) if live else (x,),)
        op = "free" if op == "free_any" else op
        outcomes = []
        for a in (ref, got):
            try:
                outcomes.append(("ok", getattr(a, op)(*args)))
            except ValueError as e:
                outcomes.append(("err", str(e)))
        assert outcomes[0] == outcomes[1], (op, args)
        assert _alloc_state(got) == _alloc_state(ref)
        assert got.free_count + got.live_count == 12 - 2


def test_make_waves_equal_the_reference():
    for kw in (dict(seed=11, n_waves=2, wave_size=3, vocab=512,
                    prompt_len=(3, 6), max_new=(2, 4), gap_steps=4),
               dict(seed=0, n_waves=3, wave_size=1, vocab=512,
                    prompt_len=(0, 0), max_new=(2, 4), gap_steps=20,
                    shared_prefix_len=16)):
        ref, got = jfe.make_waves(**kw), frontend.make_waves(**kw)
        assert [dataclasses.astuple(r) for r in ref] == \
            [dataclasses.astuple(r) for r in got]


# ---------------------------------------------------------------------------
# the burst: results, telemetry and per-request flags equal the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv", ["in-place", "parity-zero",
                                "in-place-chunked"])
def test_burst_matches_the_reference(rig, kv):
    cfg = rig[0]
    waves = _small_waves(cfg.vocab, frontend.make_waves)
    ref_ev, ref_sum, ref_res = _ref_burst(rig, kv, _small_waves(
        cfg.vocab, jfe.make_waves))
    ev, summ, res = _port_burst(rig, kv, waves)
    assert res == ref_res and len(res) == 6
    _assert_views_equal(ref_ev, ev, kv)
    assert summ["pool"]["leaked_pages"] == 0
    # the kernel route: on the CPU every wrapper takes its plain version
    _, _, res_k = _port_burst(rig, kv, waves, backend="cuda")
    assert res_k == ref_res


def _pool_shapes(kv):
    """Shapes of the front-end's encoded pools (and check planes)."""
    cache = kvcache.init_paged_cache(
        tconfigs.get_smoke(ARCH), SLOTS, MAX_LEN, kv,
        n_pages=SLOTS + SLOTS * kvcache.pages_per_seq(MAX_LEN, 16),
        device="cpu")
    return {k: tuple(v.shape) for k, v in cache.items()
            if k.endswith(("_pages", "_checks"))}


@pytest.mark.parametrize("kv", ["in-place", "parity-zero",
                                "in-place-chunked"])
def test_burst_fault_masks_attribute_per_request_as_the_reference(rig, kv):
    cfg = rig[0]
    masks = _masks(_pool_shapes(kv), steps=(3, 7, 12, 16))
    ref_ev, _, ref_res = _ref_burst(rig, kv, _small_waves(
        cfg.vocab, jfe.make_waves), masks=masks)
    ev, summ, res = _port_burst(rig, kv, _small_waves(
        cfg.vocab, frontend.make_waves), masks=masks)
    fin = {e["rid"]: (e["kv_corrected"], e["kv_due"])
           for e in ev if e["event"] == "finish"}
    ref_fin = {e["rid"]: (e["kv_corrected"], e["kv_due"])
               for e in ref_ev if e["event"] == "finish"}
    assert fin == ref_fin
    assert sum(c for c, _ in fin.values()) > 0
    if kv == "parity-zero":
        assert all(d == 0 for _, d in fin.values())
    assert res == ref_res
    _assert_views_equal(ref_ev, ev, kv)


def _cow_waves(vocab, maker, seed=11):
    """The reference suite's ``_cow_waves``: one 16-token prompt ending on
    a page boundary, three staggered single-request waves."""
    return maker(seed=seed, n_waves=3, wave_size=1, vocab=vocab,
                 prompt_len=(0, 0), max_new=(2, 4), gap_steps=20,
                 shared_prefix_len=16)


def _savings_waves(vocab, maker, seed=11):
    """The reference suite's ``_savings_waves``: a publisher, then two
    concurrent sharers of a 32-token prefix."""
    reqs = maker(seed=seed, n_waves=3, wave_size=1, vocab=vocab,
                 prompt_len=(1, 2), max_new=(2, 4), gap_steps=40,
                 shared_prefix_len=32)
    return [reqs[0]] + [dataclasses.replace(r, arrival_step=40)
                        for r in reqs[1:]]


@pytest.mark.parametrize("waves,max_len", [(_cow_waves, 32),
                                           (_savings_waves, 48)],
                         ids=["cow", "savings"])
def test_prefix_sharing_burst_matches_the_reference(rig, waves, max_len):
    cfg = rig[0]
    ref_ev, ref_sum, ref_res = _ref_burst(
        rig, "in-place", waves(cfg.vocab, jfe.make_waves),
        prefix_sharing=True, max_len=max_len)
    ev, summ, res = _port_burst(rig, "in-place",
                                waves(cfg.vocab, frontend.make_waves),
                                prefix_sharing=True, max_len=max_len)
    pick = lambda evs: [e for e in jtel.deterministic_view(evs)
                        if e["event"] in ("admit", "cow")]
    assert pick(ev) == pick(ref_ev)
    assert res == ref_res
    _assert_views_equal(ref_ev, ev, "in-place")
    assert summ["sharing"] == ref_sum["sharing"]
    # sharing never changes the tokens
    _, _, solo = _port_burst(rig, "in-place",
                             waves(cfg.vocab, frontend.make_waves),
                             max_len=max_len)
    assert solo == res


def test_summarize_equals_the_reference_outside_wall_fields(rig, tmp_path):
    cfg = rig[0]
    ev, summ, _ = _port_burst(rig, "parity-zero", _small_waves(
        cfg.vocab, frontend.make_waves), masks=_masks(
            _pool_shapes("parity-zero"), steps=(5,)))
    ref = jtel.summarize(ev)
    for s in (summ, ref):
        s["throughput"].pop("tokens_per_s")
        s.pop("ttft_s")
        s.pop("per_token_ms")
    assert summ == ref
    # the reference's loader reads the port's summary file
    telemetry.write_summary(telemetry.summarize(ev), str(tmp_path / "s.json"))
    loaded = jtel.load_summary(str(tmp_path / "s.json"))
    assert loaded["schema"] == jtel.SUMMARY_SCHEMA
    assert loaded["requests"] == summ["requests"]


def test_burst_telemetry_files_and_cli(tmp_path):
    """``--burst --burst-out`` on the CPU writes the JSONL stream (equal to
    the returned events), the per-request CSV and the summary."""
    from repro_torch.launch import serve
    out = serve.main(["--device", "cpu", "--burst", "--batch", "2",
                      "--tokens", "4", "--kv-policy", "parity-zero",
                      "--fault-rate", "1e-3", "--burst-out",
                      str(tmp_path)])
    streamed = [json.loads(l) for l in
                (tmp_path / "telemetry.jsonl").read_text().splitlines()]
    assert streamed == out["events"]
    rows = (tmp_path / "requests.csv").read_text().splitlines()
    assert len(rows) == 1 + out["summary"]["requests"]["submitted"] == 5
    assert json.loads((tmp_path / "summary.json").read_text()) == \
        out["summary"]
    assert out["summary"]["pool"]["leaked_pages"] == 0


def test_self_healing_raises_until_ported(rig):
    cfg, _, _, port_enc = rig
    tcfg = tconfigs.get_smoke(ARCH)
    for kw in (dict(scrub_every=2), dict(repair_kit=object())):
        with pytest.raises(NotImplementedError, match="self-healing"):
            frontend.ServingFrontend(tcfg, port_enc, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="self-healing"):
        frontend.run_burst(tcfg, port_enc, waves=[], repair=True,
                           device="cpu")
    fe = frontend.ServingFrontend(tcfg, port_enc, device="cpu")
    with pytest.raises(NotImplementedError, match="self-healing"):
        fe.start_migration(None)


def test_guarded_per_slot_abft_rows_equal_the_reference(rig):
    """With a guarded plan and a per-slot KV policy the serve step's ABFT
    rows are per slot: ``top_abft`` (2, B) and ``layers_abft`` (L, 2, B),
    equal to the reference's."""
    cfg, plan, enc, port_enc = rig
    scales = P.calibrated_model(ARCH)[3]
    jplan = plan.with_abft(True, clamps={p: s * 12 for p, s in
                                         scales.items()})
    tplan = P.port_plan(ARCH).with_abft(True, clamps={
        p: s * 12 for p, s in scales.items()})
    jkvp = dataclasses.replace(jkv.get_kv_policy("in-place"),
                               per_slot_flags=True)
    jstep = jax.jit(jprot.make_serve_step(cfg, plan=jplan, with_flags=True,
                                          kv_policy=jkvp, dtype=jnp.float32))
    tcfg = tconfigs.get_smoke(ARCH)
    tstep = protected.make_serve_step(
        tcfg, plan=tplan, kv_policy=dataclasses.replace(
            kvcache.get_kv_policy("in-place"), per_slot_flags=True),
        dtype=torch.float32)
    b = 3
    jcache = jkv.init_cache(cfg, b, MAX_LEN, kv_policy=jkvp)
    tcache = kvcache.init_cache(tcfg, b, MAX_LEN, kv_policy="in-place",
                                device="cpu")
    toks = P.seeded_tokens(cfg, (3, b, 1), 4)
    for t in range(3):
        pos = np.array([t, t, 0], np.int32)
        _, jcache, jfl = jstep(enc, jcache, jnp.asarray(toks[t]),
                               jnp.asarray(pos))
        _, tcache, tfl = tstep(port_enc, tcache,
                               torch.from_numpy(toks[t]).long(),
                               torch.from_numpy(pos))
        assert tfl["top_abft"].shape == (2, b)
        assert tfl["layers_abft"].shape == (tcfg.n_layers, 2, b)
        assert tfl["layers_kv"].shape == (tcfg.n_layers, 2, b)
        P.assert_flag_dict_equal({k: np.asarray(v) for k, v in jfl.items()},
                                 {k: v.numpy() for k, v in tfl.items()})
    assert int(tfl["top_abft"][1].sum()) > 0   # tight clamps do bite
