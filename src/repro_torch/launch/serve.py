"""Protected-serving driver: batched decode with ECC-encoded weights.

Counterpart of ``python -m repro.launch.serve``: build a protection
policy, encode the weights leaf by leaf as they are drawn, report coverage,
optionally inject memory faults, and decode-serve a batch — faults are
corrected at the point of use.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \\
      --tokens 16 --batch 4 [--scheme in-place] [--backend torch|cuda] \\
      [--kv-policy in-place-fused|in-place-chunked] [--prompt-len 512] \\
      [--fault-rate 1e-4] [--abft] [--act-clamp] [--device cuda|cpu] \\
      [--burst [--burst-out DIR]]

The backend defaults to the kernels (``cuda``) on the card and to the
plain route (``torch``) on the CPU. With ``--prompt-len`` a random prompt
drawn from the seed is prefilled into the paged KV cache first (needs a
``--kv-policy``), and decoding continues from it; the ``-chunked`` KV
presets serve contexts past the strip kernel's shared-memory wall.

``--abft`` verifies ABFT checksums inside every protected matmul;
``--act-clamp`` calibrates per-leaf activation bounds from a seeded batch
and clamps each matmul's output to them; mismatches and clamp hits are
counted over the run. :func:`serve` also serves the int8 path
(``act_quant="static"`` from the same calibration, or ``"dynamic"``),
which the CLI does not offer, as the reference's does not.

``--burst`` replays a seeded two-wave workload through the request
front-end (:mod:`repro_torch.serving.frontend`: continuous batching over
the paged pool, per-request fault attribution) instead of the fixed batch,
and prints the telemetry roll-up; ``--burst-out DIR`` also writes the
telemetry JSONL, the per-request CSV and the summary JSON. :func:`burst`
is the same path as a function.

The CLI serves the smoke configs (``configs.get_smoke``), as the reference
CLI does; :func:`serve` and :func:`burst` take any config, e.g. the
full-width ``configs.get("deepseek-7b")``. The fault smoke-check campaigns
and scrubbing are not ported yet.
"""
from __future__ import annotations

import argparse
import os
import statistics
import time

import torch

from repro_torch import configs
from repro_torch import device as device_mod
from repro_torch.models import lm
from repro_torch.core import quant
from repro_torch.protection import backends, policy as policy_mod, schemes
from repro_torch.serving import kvcache, protected


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


default_backend = device_mod.default_backend


def serve(cfg, *, batch: int = 4, tokens: int = 16, prompt_len: int = 0,
          fault_rate: float = 0.0, correctable_only: bool = False,
          seed: int = 0, scheme: str = "in-place", backend=None,
          kv_policy=None, device=None, dtype=torch.bfloat16, weights=None,
          abft: bool = False, act_clamp: bool = False, act_quant=None,
          scales=None, log=print) -> dict:
    """Serve ``tokens`` greedy decode steps of a batch.

    The weights are drawn at random from ``seed`` and encoded leaf by leaf,
    unless ``weights`` gives an encoded tree to serve (e.g. the deployed
    trained masters, ``ProtectionPolicy(...).encode_tree(params)``; it is
    not modified).

    Without a prompt the batch decodes from position 0. With ``prompt_len``
    a random prompt of that many tokens per row, drawn from ``seed``, is
    prefilled into the paged KV cache (``kv_policy`` required) and the
    decode continues from position ``prompt_len``. ``backend`` defaults to
    :func:`default_backend` of the device.

    With ``correctable_only`` the injector keeps at most one flip in each
    64-bit code block (weights and KV), so an in-place run must give the
    clean run's logits bit for bit.

    ``abft`` checks every protected matmul's accumulator against its ABFT
    checksums; ``act_clamp`` clamps each matmul's output to the absmax its
    activations reached on a calibration batch ((2, 16) tokens drawn from
    ``seed + 7``), run on the clean weights before any fault is injected;
    ``scales`` (``{leaf path: a_scale}``, as
    :func:`~repro_torch.serving.protected.calibrate_act_scales` returns
    them) skips the calibration. ``act_quant`` ("static" from the same
    scales, or "dynamic") serves the projections over the int8 path.

    Returns a dict with ``tokens`` (T, B) and ``logits`` (T, B, V) of every
    step, the run's fault accounting ``flags`` (weight corrected/DUE from
    the ``top`` and ``layers`` rows, KV from ``layers_kv``, prefill
    included), the run's ABFT totals ``abft`` (``mismatches``,
    ``clamp_hits``; the ``*_abft`` rows), the flipped bit positions of each
    injected image (``weight_positions``, ``kv_positions``), the calibrated
    ``scales`` (or None), and the timings ``seconds``,
    ``tok_per_s`` and ``step_ms`` of the decode (host clock, each step
    ended by a device sync). With a prompt it also holds ``prompt`` (B, S),
    ``prefill_logits`` (B, S, V), ``prefill_s`` and ``prefill_tok_per_s``.
    """
    dev = device_mod.resolve(device)
    if backend is None:
        backend = default_backend(dev)
    log(f"[serve] {cfg.name} (d_model {cfg.d_model}, {cfg.n_layers} layers), "
        f"scheme={scheme}, backend={backend}, fault_rate={fault_rate}"
        f"{' (correctable only)' if correctable_only else ''}, device={dev}")
    kvp = kvcache.get_kv_policy(kv_policy)
    if prompt_len and kvp is None:
        raise ValueError("a prompt is prefilled into the paged KV cache: "
                         "pass a kv_policy")
    if dev.type == "cuda" and (backend == "cuda" or (kvp and kvp.fused)):
        from repro_torch.kernels import build
        t0 = time.time()
        build.load_all()
        log(f"[serve] CUDA kernels ready in {time.time() - t0:.1f}s")
    policy = policy_mod.ProtectionPolicy(default_scheme=scheme,
                                         backend=backend)
    plan = policy.plan(lm.param_shapes(cfg))
    log("[serve] " + plan.coverage().summary().replace("\n", "\n[serve] "))
    s = plan.summary()
    log(f"[serve] plan: backends {s['by_backend']}, {s['n_flat_padded']} "
        f"flat-padded leaves")
    if weights is None:
        t0 = time.time()
        enc = lm.init_params(cfg, seed, device=dev, leaf_fn=plan.encode_leaf)
        _sync(dev)
        log(f"[serve] drew and encoded the weights in "
            f"{time.time() - t0:.1f}s")
    else:
        enc = weights
    if scales is None and (act_clamp or act_quant == "static"):
        gen_c = torch.Generator(device=dev)
        gen_c.manual_seed(seed + 7)
        cal = torch.randint(0, cfg.vocab, (2, 16), generator=gen_c,
                            device=dev)
        t0 = time.time()
        scales = protected.calibrate_act_scales(cfg, enc, cal,
                                                plan=plan, backend=backend,
                                                dtype=dtype)
        log(f"[serve] calibrated {len(scales)} activation scales in "
            f"{time.time() - t0:.2f}s")
    if act_quant == "static":
        plan = plan.with_act_quant("static", scales, clamp=act_clamp)
    elif act_quant is not None:
        plan = plan.with_act_quant(act_quant)
    if abft or act_clamp:
        clamps = None
        if act_clamp and act_quant != "static":
            clamps = {p: v * quant.QMAX for p, v in scales.items()}
        # use-time knobs only: the encoded images stay valid
        plan = plan.with_abft(abft, clamps=clamps)
    if abft or act_clamp or act_quant:
        s = plan.summary()
        log(f"[serve] ABFT guard: {s['n_abft']} checksum-verified leaves, "
            f"{s['n_clamped']} activation-clamped; activation quant "
            f"{s['act_quant'] or 'none'}")
    weight_positions: dict = {}
    if fault_rate:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        enc, weight_positions = policy_mod.inject_tree_device(
            enc, fault_rate, gen, one_per_block=correctable_only)
        n = sum(int(p.numel()) for p in weight_positions.values())
        log(f"[serve] injected {n} bit flips into the resident weight images")

    aq = "plan" if act_quant else None
    step = protected.make_serve_step(cfg, plan=plan, backend=backend,
                                     kv_policy=kvp, dtype=dtype,
                                     act_quant=aq)
    max_len = prompt_len + tokens if prompt_len else max(64, tokens * 2)
    cache = kvcache.init_cache(cfg, batch, max_len, kv_policy=kvp,
                               dtype=dtype, device=dev)
    if kvp is not None:
        kb = kvcache.kv_bytes(cache)
        log(f"[serve] paged KV cache ({kvp.scheme}, page_size={kvp.page_size}"
            f", attention {kvp.attention_impl if kvp.fused else 'reference'}"
            f"): stored {kb['stored']}B + scales {kb['scales']}B")
    tok = torch.zeros((batch, 1), dtype=torch.long, device=dev)
    kv_positions: dict = {}
    out_tok, out_logits, step_flags, step_s = [], [], [], []
    extra: dict = {}
    if prompt_len:
        gen_p = torch.Generator(device=dev)
        gen_p.manual_seed(seed + 1)
        prompt = torch.randint(0, cfg.vocab, (batch, prompt_len),
                               generator=gen_p, device=dev)
        prefill = protected.make_prefill(cfg, plan=plan, backend=backend,
                                         kv_policy=kvp, dtype=dtype,
                                         with_flags=True, act_quant=aq)
        _sync(dev)
        t0 = time.time()
        plogits, cache, pflags = prefill(enc, cache, prompt)
        _sync(dev)
        dt = time.time() - t0
        step_flags.append(pflags)
        tok = plogits[:, -1:].argmax(dim=-1)
        extra = {"prompt": prompt.cpu(), "prefill_logits": plogits,
                 "prefill_s": dt, "prefill_tok_per_s": batch * prompt_len / dt}
        log(f"[serve] prefilled {batch} x {prompt_len} prompt tokens in "
            f"{dt:.2f}s ({batch * prompt_len / dt:.1f} tok/s)")
    _sync(dev)
    t_run = time.time()
    for t in range(tokens):
        t_step = time.time()
        if kvp is not None and fault_rate and t == tokens // 2 and t > 0:
            # hit the LIVE pools mid-run: later steps decode a faulted history
            gen_kv = torch.Generator(device=dev)
            gen_kv.manual_seed(seed + 3)
            dirty, kv_positions = policy_mod.inject_tree_device(
                kvcache.as_protected_tree(cache, kvp), fault_rate, gen_kv,
                one_per_block=correctable_only)
            cache = kvcache.from_protected_tree(cache, dirty)
            log(f"[serve] injected faults into the live KV pools at step {t}")
        pos = torch.full((batch,), prompt_len + t, dtype=torch.int32,
                         device=dev)
        logits, cache, flags = step(enc, cache, tok, pos)
        tok = logits.argmax(dim=-1)
        out_tok.append(tok[:, 0])
        out_logits.append(logits[:, 0])
        step_flags.append(flags)
        _sync(dev)
        step_s.append(time.time() - t_step)
    dt = time.time() - t_run
    acc = {"corrected": 0, "due": 0, "kv_corrected": 0, "kv_due": 0}
    guard = {"mismatches": 0, "clamp_hits": 0}
    for flags in step_flags:
        for k, v in flags.items():
            pair = v.reshape(-1, 2).sum(dim=0).tolist()
            if k.endswith("_abft"):  # (mismatches, clamp hits), not ECC
                guard["mismatches"] += pair[0]
                guard["clamp_hits"] += pair[1]
                continue
            pre = "kv_" if k == "layers_kv" else ""
            acc[pre + "corrected"] += pair[0]
            acc[pre + "due"] += pair[1]
    ms = [1e3 * x for x in step_s]
    log(f"[serve] {tokens} steps x batch {batch} in {dt:.2f}s "
        f"({tokens * batch / dt:.1f} tok/s, median step "
        f"{statistics.median(ms):.2f} ms, context up to "
        f"{prompt_len + tokens})")
    log(f"[serve] decode-at-use fault accounting over the run: "
        f"{acc['corrected']} corrected, {acc['due']} DUE "
        f"(detected-uncorrectable)")
    if kvp is not None:
        log(f"[serve] KV decode-at-use accounting: {acc['kv_corrected']} "
            f"corrected, {acc['kv_due']} DUE")
    if abft or act_clamp:
        log(f"[serve] ABFT compute-fault accounting: {guard['mismatches']} "
            f"checksum mismatches, {guard['clamp_hits']} activation clamp "
            f"hits")
    toks = torch.stack(out_tok).cpu()
    log(f"[serve] sample continuation: {toks[:, 0].tolist()}")
    return {"tokens": toks, "logits": torch.stack(out_logits),
            "flags": acc, "abft": guard, "scales": scales,
            "weight_positions": weight_positions,
            "kv_positions": kv_positions, "seconds": dt,
            "tok_per_s": tokens * batch / dt, "step_ms": ms, **extra}


def burst(cfg, *, batch: int = 4, tokens: int = 16, seed: int = 0,
          waves=None, slots=None, max_len=None,
          kv_policy="in-place", scheme: str = "in-place", backend=None,
          device=None, weights=None, fault_rate: float = 0.0,
          correctable_only: bool = False,
          prefix_sharing: bool = False, out_dir=None, before_step=None,
          after_step=None, log=print) -> dict:
    """Serve a seeded burst through the request front-end and roll it up.

    The workload defaults to the reference CLI's: ``make_waves(seed,
    n_waves=2, wave_size=batch, prompt_len=(4, 8), max_new=(4, tokens),
    gap_steps=6)`` on ``slots = max(2, batch // 2)`` slots with ``max_len =
    max(32, 2 * tokens)``; ``waves``, ``slots`` and ``max_len`` override
    it. Weights are drawn from ``seed`` and encoded under ``scheme`` unless
    ``weights`` gives an encoded tree (not modified). ``fault_rate`` is
    injected once into the resident weights before serving (at most one
    flip per block with ``correctable_only``), and into the live KV pools
    every 4 steps, as the reference CLI injects both. ``out_dir`` gets
    ``telemetry.jsonl``, ``requests.csv`` and ``summary.json``;
    ``before_step(fe)`` / ``after_step(fe)`` reach the front-end around
    each step (:func:`~repro_torch.serving.frontend.run_burst`).

    Returns ``{"events", "summary", "results", "seconds", "weights",
    "weight_positions"}``: the telemetry events, the roll-up, ``{rid:
    tokens}``, the wall time of the burst and the (injected) weights.
    """
    from repro_torch.serving import frontend, telemetry

    dev = device_mod.resolve(device)
    if backend is None:
        backend = default_backend(dev)
    kvp = kvcache.get_kv_policy(kv_policy or "in-place")
    if waves is None:
        waves = frontend.make_waves(seed=seed, n_waves=2, wave_size=batch,
                                    vocab=cfg.vocab, prompt_len=(4, 8),
                                    max_new=(4, tokens), gap_steps=6)
    slots = max(2, batch // 2) if slots is None else slots
    max_len = max(32, tokens * 2) if max_len is None else max_len
    log(f"[serve] burst: {cfg.name} (d_model {cfg.d_model}, {cfg.n_layers} "
        f"layers), {len(waves)} requests on {slots} slots, max_len "
        f"{max_len}, KV {kv_policy}, scheme={scheme}, backend={backend}, "
        f"device={dev}")
    if dev.type == "cuda" and (backend == "cuda" or kvp.fused):
        from repro_torch.kernels import build
        build.load_all()
    plan = policy_mod.ProtectionPolicy(default_scheme=scheme,
                                       backend=backend).plan(
        lm.param_shapes(cfg))
    enc = weights
    if enc is None:
        t0 = time.time()
        enc = lm.init_params(cfg, seed, device=dev, leaf_fn=plan.encode_leaf)
        _sync(dev)
        log(f"[serve] drew and encoded the weights in "
            f"{time.time() - t0:.1f}s")
    weight_positions: dict = {}
    if fault_rate:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        enc, weight_positions = policy_mod.inject_tree_device(
            enc, fault_rate, gen, one_per_block=correctable_only)
        log("[serve] injected faults into the resident weight images")
    tpath = None
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tpath = os.path.join(out_dir, "telemetry.jsonl")
    _sync(dev)
    t0 = time.time()
    events, summ, results = frontend.run_burst(
        cfg, enc, plan=plan, waves=waves, slots=slots, max_len=max_len,
        kv_policy=kvp, fault_rate=fault_rate, fault_seed=seed,
        correctable_only=correctable_only, telemetry_path=tpath,
        prefix_sharing=prefix_sharing,
        before_step=before_step, after_step=after_step, backend=backend,
        device=dev)
    _sync(dev)
    dt = time.time() - t0
    r, t, d, p = (summ["requests"], summ["throughput"], summ["due"],
                  summ["pool"])
    log(f"[serve] burst ({kv_policy} KV): {r['finished']}/{r['submitted']} "
        f"requests in {summ['steps']} steps "
        f"({t['tokens_per_step']:.2f} tok/step); "
        f"{summ['gen_tokens']} tokens in {dt:.2f}s of wall "
        f"({summ['gen_tokens'] / dt:.2f} tok/s)")
    log(f"[serve] TTFT p50/p95/p99: {summ['ttft_steps']['p50']}/"
        f"{summ['ttft_steps']['p95']}/{summ['ttft_steps']['p99']} steps; "
        f"per-token p99 {summ['per_token_ms']['p99']:.2f}ms")
    log(f"[serve] KV faults: {d['corrected_total']} corrected, "
        f"{d['total']} DUE ({d['requests_with_due']} requests); "
        f"pages leaked {p['leaked_pages']}")
    if out_dir:
        telemetry.write_requests_csv(events,
                                     os.path.join(out_dir, "requests.csv"))
        telemetry.write_summary(summ, os.path.join(out_dir, "summary.json"))
        log(f"[serve] wrote {out_dir}/telemetry.jsonl, requests.csv, "
            f"summary.json")
    return {"events": events, "summary": summ, "results": results,
            "seconds": dt, "weights": enc,
            "weight_positions": weight_positions}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b", choices=configs.ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--fault-rate", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scheme", default="in-place",
                    choices=sorted(set(schemes.scheme_ids()) |
                                   set(schemes.ALIASES)))
    ap.add_argument("--prompt-len", type=int, default=0,
                    help="prefill a random prompt of this many tokens into "
                         "the paged KV cache first (needs --kv-policy)")
    ap.add_argument("--backend", default=None,
                    choices=sorted(backends.BACKENDS),
                    help="default: cuda (the kernels) on the card, torch on "
                         "the CPU")
    ap.add_argument("--kv-policy", default=None,
                    choices=sorted(kvcache.KV_POLICY_PRESETS),
                    help="serve against the paged protected KV cache under "
                         "this preset; with --fault-rate, faults are also "
                         "injected into the live cache pools mid-run")
    ap.add_argument("--abft", action="store_true",
                    help="verify ABFT checksums inside every protected "
                         "matmul (row/col sums vs the accumulator, same "
                         "kernel pass); mismatches surface on the *_abft "
                         "flags rows")
    ap.add_argument("--act-clamp", action="store_true",
                    help="calibrate per-leaf activation absmax bounds from "
                         "a seeded batch and fuse the range clamps into "
                         "the matmul epilogue; clamp hits ride the *_abft "
                         "flags rows")
    ap.add_argument("--burst", action="store_true",
                    help="serve a seeded burst workload through the "
                         "request-level front-end (continuous batching, "
                         "admission control, telemetry summary) instead of "
                         "the fixed-batch loop; uses --kv-policy (default "
                         "in-place), --fault-rate for the weights and the "
                         "live KV pools, and --seed for the workload")
    ap.add_argument("--burst-out", default=None, metavar="DIR",
                    help="with --burst: write telemetry JSONL + requests "
                         "CSV + summary JSON here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain route")
    args = ap.parse_args(argv)
    if args.burst:
        return burst(configs.get_smoke(args.arch), batch=args.batch,
                     tokens=args.tokens, seed=args.seed,
                     kv_policy=args.kv_policy or "in-place",
                     scheme=args.scheme, backend=args.backend,
                     device=args.device, fault_rate=args.fault_rate,
                     out_dir=args.burst_out)
    return serve(configs.get_smoke(args.arch), batch=args.batch,
                 tokens=args.tokens, prompt_len=args.prompt_len,
                 fault_rate=args.fault_rate, seed=args.seed,
                 scheme=args.scheme, backend=args.backend,
                 kv_policy=args.kv_policy, device=args.device,
                 abft=args.abft, act_clamp=args.act_clamp)


if __name__ == "__main__":
    main()
