"""On-card smoke test of the PyTorch + CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
kernel against its plain PyTorch version on the card at the shapes the
full-width deepseek-7b serve paths give it (the two attention kernels also
against an fp64 oracle), holds the kernel route against the plain route end
to end on a depth-cut (2-layer) full-width model, and then drives the
port's two serving paths through its own entry point
``repro_torch.launch.serve.serve`` on full-width deepseek-7b (30 layers,
d_model 4096, vocab 102400) at batch 4:

* decode-at-use serving from position 0 (``in-place-fused`` KV, 16 greedy
  steps): clean, with injected memory faults (the corrected and DUE counts
  must equal the injected single- and double-flip blocks), and with
  correctable faults only (the logits must equal the clean run's bit for
  bit);
* long-context serving (``in-place-chunked`` KV): a 2,048-token prompt per
  row is prefilled into the paged ECC KV cache through the flash kernel,
  then 16 steps decode through the chunked kernel at a 2,064-token
  context, clean and with correctable weight faults only (prefill logits,
  decode logits and tokens must equal the clean run's bit for bit, and
  each flipped block is counted once per call: 17 times);
* the training path (QAT with WOT throttling, then deploy and serve):
  ``repro_torch.launch.train.train`` runs QATT steps of full-width
  deepseek-7b cut to 8 layers (batch 8 x 2,048 tokens in 8 microbatches,
  the throttle through the ``quantize_throttle`` kernel); the last update
  runs unthrottled and its masters are throttled on both routes (masters,
  q and scales bit-equal, the WOT constraint on every leaf); the trained
  masters are deployed (quantize-throttle and in-place encode) on both
  routes, byte-equal, and served 8 greedy steps at batch 4 under
  ``in-place-fused``, clean and with correctable weight faults only
  (bit-equal logits and tokens);
* guarded int8 serving (``in-place-fused``, 16 greedy steps, batch 4):
  static activation scales calibrated through the cache-less prefill
  (flash kernel, float ``ecc_qmatmul``), then static int8 serving through
  the requantize epilogue with activation clamps and ABFT (clean, and with
  correctable weight faults only: bit-equal), dynamic int8 with ABFT, the
  CLI's float path with ``--abft --act-clamp``, and a 4 x 512-token int8
  prefill under ``in-place-chunked``: no ABFT mismatch anywhere; the kernel
  and plain routes of the int8 paths compared on a 2-layer full-width
  model;
* burst serving through the request front-end
  (``repro_torch.launch.serve.burst``: continuous batching over the paged
  pool on 8 slots, two waves of twelve requests): clean twice (equal
  deterministic telemetry), ``parity-zero-fused`` and
  ``parity-zero-chunked`` with live KV flips (per-slot flags attributed
  exactly, no DUE), ``in-place-chunked`` with prefix sharing and
  copy-on-write (tokens of the run without sharing, the pool back at its
  start), and ``in-place-fused`` with correctable KV flips only (tokens of
  the clean run); with TTFT, TPOT, tok/s and a profile of eight steps.

Phase 2 also holds the parity-zero decode and the per-slot flags of both
paged-attention kernels to their plain versions at the burst's shapes, and
phase 3 runs a 2-layer burst on both routes with the same pool flips.

Launch counts are set to 0 just before each path and read just after.
Every phase raises on failure and the script exits nonzero; it prints no
result without a CUDA device. Its last lines are the kernels JSON (per
kernel: launches on the main paths, max abs error against the plain
version, times and bound) and ``{"ok": true, "device": {...}}``.

Times are CUDA-event medians over repeats with the 50 MB L2 cache flushed
before each repeat and the card kept busy while the host enqueues. Kernel
entries report the work one call of the serve path gives the kernel: one
decode step (ecc_decode, ecc_qmatmul, the two decode attentions), one
deploy (ecc_encode: every protected leaf once), one prefill (flash_attention)
or one train step (quantize_throttle: every protected leaf of the 8-layer
model once): the sum over the launches of that call. ``bound_ms`` is
max(bytes / 3.35 TB/s, ops / peak) with each input read once and each
output written once (H100 SXM data-sheet rates: HBM 3.35 TB/s, dense bf16
989 TFLOP/s, dense int8 1,979 TOP/s).
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12

# tolerances (stated here, used below)
QMM_RTOL = 2e-4     # |kernel - plain| <= QMM_RTOL * (|a| @ |w|) + 1e-6: both
#                     sum exact bf16 products in f32, in different orders
# fused_page_attention is held to its plain version bit for bit: it mirrors
# the plain version's op order and rounds scores, probabilities and outputs
# to bf16 where it does, so the two differ at most in f32 summation order,
# which those roundings absorb at these inputs (max abs err 0 in every
# run). A dropped bf16 rounding would change some outputs by an ulp.
E2E_MAX_ATOL = 0.25  # 2-layer logits, bf16 activations: the kernel rounds
E2E_MEAN_ATOL = 0.02  # each projection once from f32, cuBLAS rounds its own
# chunked_page_attention: kernel and plain version are f32 to the end in
# the same op order (sums in another order) and round the output to bf16
# once, so they differ by at most one bf16 ulp of the output (2^-7 |o|)
# plus f32 noise; both are held to the fp64 oracle within 2% of
# max|oracle| (the reference's gate for its chunked kernel).
CHUNKED_RTOL, CHUNKED_ATOL = 2.0 ** -7, 1e-5
ORACLE_RTOL = 0.02
# flash_attention: same op order; f32 sums in another order can move a
# probability across a bf16 rounding boundary before PV (one ulp, 2^-8 p)
# and the output rounds once (one ulp of |o|).
FLASH_RTOL, FLASH_ATOL = 2.0 ** -6, 2e-3
# the burst routes in f32 at 2 layers: the routes' K/V differ by int8
# rounding (an f32 last-ulp difference in k can cross a quantization
# boundary: one LSB of the token's absmax/127), which moved logits of
# |logit| <= 5 by up to 0.015 on the card; greedy tokens may split only
# where the top two logits lie this close
ROUTE_F32_ATOL = 0.05
# The training phase keeps every width and cuts deepseek-7b to 8 layers:
# at 30 layers the f32 masters, the momentum and one gradient set alone
# take 82.9 GB (12 B per parameter), more than the card's 80 GB.
TRAIN_LAYERS = 8
# The burst phase (9): eight slots of 16-token pages, 128 tokens each.
BURST_SLOTS, BURST_MAX_LEN = 8, 128


def fail(msg: str):
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    raise SystemExit(1)


def log(msg: str):
    print(f"[chip_smoke] {msg}", flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device: nothing to check", flush=True)
        raise SystemExit(2)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build  # noqa: E402
    from repro_torch.configs import get as get_config  # noqa: E402

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.time()
    build.load_all()
    log(f"built the CUDA kernels in {time.time() - t0:.1f}s")
    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / "chip_smoke_build.log", "w") as fh:
        for src, text in build.BUILD_LOG.items():
            fh.write(f"=== {src}.cu ===\n{text}\n")

    t0 = time.time()
    entries = phase_kernels(torch, dev)
    log(f"phase 2 (kernels) took {time.time() - t0:.0f}s")
    t0 = time.time()
    phase_routes(torch, dev)
    log(f"phase 3 (routes) took {time.time() - t0:.0f}s")
    t0 = time.time()
    decode_counts = phase_full(torch, dev, build)
    log(f"phase 4 (decode path) took {time.time() - t0:.0f}s")
    t0 = time.time()
    long_counts = phase_long(torch, dev, build)
    log(f"phase 5 (long-context path) took {time.time() - t0:.0f}s")
    t0 = time.time()
    phase_profile(torch)
    log(f"phase 6 (profiles) took {time.time() - t0:.0f}s")
    t0 = time.time()
    train_cfg = get_config("deepseek-7b").with_(n_layers=TRAIN_LAYERS)
    train_counts, trained = phase_train(torch, dev, build, train_cfg)
    log(f"phase 7 (training, deploy, serve) took {time.time() - t0:.0f}s")
    t0 = time.time()
    phase_train_profile(torch, dev, train_cfg, trained)
    del trained
    log(f"phase 7 profile took {time.time() - t0:.0f}s")
    t0 = time.time()
    guarded_counts = phase_guarded(torch, dev, build)
    log(f"phase 8 (guarded int8 path) took {time.time() - t0:.0f}s")
    t0 = time.time()
    burst_counts = phase_burst(torch, dev, build)
    log(f"phase 9 (burst serving) took {time.time() - t0:.0f}s")
    counts = {k: decode_counts[k] + long_counts[k] + train_counts[k]
              + guarded_counts[k] + burst_counts[k] for k in build.COUNTS}
    if sorted(entries) != sorted(counts):
        fail(f"kernels checked {sorted(entries)} != kernels counted "
             f"{sorted(counts)}")
    for path, cnt, needed in (
            ("decode", decode_counts, ("ecc_decode", "ecc_encode",
                                       "ecc_qmatmul", "fused_page_attention",
                                       "throttle")),
            ("long-context", long_counts,
             ("ecc_decode", "ecc_encode", "ecc_qmatmul", "flash_attention",
              "chunked_page_attention", "throttle")),
            ("training", train_counts,
             ("quantize_throttle", "throttle", "ecc_encode", "ecc_decode",
              "ecc_qmatmul", "fused_page_attention")),
            ("guarded int8", guarded_counts,
             ("ecc_decode", "ecc_encode", "ecc_qmatmul", "flash_attention",
              "fused_page_attention", "chunked_page_attention",
              "throttle")),
            ("burst", burst_counts,
             ("ecc_decode", "ecc_encode", "ecc_qmatmul",
              "fused_page_attention", "chunked_page_attention",
              "throttle"))):
        missing = [k for k in needed if cnt[k] <= 0]
        if missing:
            fail(f"kernels never launched on the {path} path: {missing}")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        fail(f"kernels never launched on the main paths: {missing}")
    line = [{"name": name, "route": "cuda", "launches": counts[name], **e}
            for name, e in entries.items()]
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


class Timer:
    REPS = 10

    def __init__(self, torch, dev):
        self.torch = torch
        self.flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)

    def ms(self, fn) -> float:
        """Median CUDA-event time of ``fn`` over repeats, L2 flushed. A
        ~1 ms device sleep ahead of the start event keeps the card busy
        while the host enqueues ``fn``, so a small kernel's time is not its
        wrapper's host latency."""
        torch = self.torch
        fn()
        times = []
        for _ in range(self.REPS):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def bound_ms(nbytes: float, ops: float = 0.0, peak: float = BF16_FLOPS):
    """Least time for the work: bytes at the HBM rate or operations at the
    tensor-core peak (bf16 unless ``peak`` says otherwise), whichever is
    longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def wot_blocks(torch, dev, nblk, gen):
    """Random WOT-compliant int8 blocks as (nblk, 8) uint8: bytes 0..6 in
    [-64, 63], byte 7 anywhere in [-127, 127]."""
    q = torch.randint(-64, 64, (nblk, 8), generator=gen, device=dev,
                      dtype=torch.int8)
    q[:, 7] = torch.randint(-127, 128, (nblk,), generator=gen, device=dev,
                            dtype=torch.int8)
    return q.view(torch.uint8)


def flip_blocks(torch, blocks, n_single, n_double, gen):
    """Flip one bit in each of ``n_single`` blocks and two distinct bits in
    each of ``n_double`` more, spread evenly over a contiguous (nblk, 8)
    uint8 tensor, in place. -> (n_single, n_double)."""
    dev = blocks.device
    n = n_single + n_double
    idx = torch.arange(n, device=dev) * max(1, blocks.shape[0] // n)
    b1 = torch.randint(0, 64, (n,), generator=gen, device=dev)
    b2 = (b1 + torch.randint(1, 64, (n,), generator=gen, device=dev)) % 64
    mask = torch.ones_like(b1) << b1
    mask[n_single:] ^= torch.ones_like(b2[n_single:]) << b2[n_single:]
    words = blocks.view(torch.int64)[:, 0]
    words[idx] ^= mask
    return n_single, n_double


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version at full-width shapes
# ---------------------------------------------------------------------------


def phase_kernels(torch, dev):
    from repro_torch.configs import get
    from repro_torch.core import ecc
    from repro_torch.kernels import (ecc_decode, ecc_encode, ecc_qmatmul,
                                     paged_attention)
    from repro_torch.models import lm
    from repro_torch.serving import kvcache

    cfg = get("deepseek-7b")
    timer = Timer(torch, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    out = {}

    # -- exhaustive single and double flips of 64 random blocks -------------
    base = ecc.encode64(wot_blocks(torch, dev, 64, gen))
    w = base.contiguous().view(torch.int64)[:, 0]
    bits = torch.arange(64, device=dev)
    i, j = torch.triu_indices(64, 64, 1, device=dev)
    one = torch.ones((), dtype=torch.int64, device=dev)
    singles = w[:, None] ^ (one << bits)[None, :]
    doubles = w[:, None] ^ ((one << i) ^ (one << j))[None, :]
    cases = torch.cat([singles, doubles], 1).reshape(-1, 1).view(torch.uint8)
    kd, kf = ecc_decode.ecc_decode(cases)
    pd, pf = ecc_decode.ecc_decode_plain(cases)
    if not (torch.equal(kd, pd) and torch.equal(kf, pf)):
        fail("ecc_decode disagrees with its plain version on the 64 single "
             "and 2016 double flips")
    nc = 64 * (64 + 2016)
    if int((kf == 1).sum()) != 64 * 64 or int((kf == 2).sum()) != 64 * 2016:
        fail("ecc_decode: single/double flips not all flagged")
    restored = ecc.restore_sign_bits(base)
    if not torch.equal(kd.view(64, 2080, 8)[:, :64], restored[:, None].expand(
            64, 64, 8)):
        fail("ecc_decode did not correct every single flip")
    if not torch.equal(ecc_encode.ecc_encode(restored),
                       ecc_encode.ecc_encode_plain(restored)):
        fail("ecc_encode disagrees with its plain version on 64 blocks")
    log(f"ecc_decode/ecc_encode: {nc} exhaustive flip cases agree")

    # -- kernel 1: decode of the embedding table, once per step --------------
    nblk = cfg.vocab_padded * cfg.d_model // 8
    enc = ecc.encode64(wot_blocks(torch, dev, nblk, gen))
    ns, nd = flip_blocks(torch, enc, 1000, 1000, gen)
    kd, kf = ecc_decode.ecc_decode(enc)
    pd, pf = ecc_decode.ecc_decode_plain(enc)
    if not (torch.equal(kd, pd) and torch.equal(kf, pf)):
        fail("ecc_decode disagrees with its plain version (embedding)")
    if int((kf & 1).sum()) != ns or int((kf >> 1).sum()) != nd:
        fail("ecc_decode flag counts != injected single/double blocks")
    bms, by = bound_ms(8 * nblk + 8 * nblk + nblk)
    out["ecc_decode"] = dict(
        source="src/repro_torch/csrc/ecc_codec.cu",
        replaces="src/repro/kernels/ecc_decode.py:73",
        max_abs_err=0.0,
        ms=timer.ms(lambda: ecc_decode.ecc_decode(enc)),
        plain_ms=timer.ms(lambda: ecc_decode.ecc_decode_plain(enc)),
        bound_ms=bms, bound_by=by, library_ms=None)
    log(f"ecc_decode ({nblk} blocks): {out['ecc_decode']}")
    del enc, kd, kf, pd, pf

    # -- kernel 2: encode of every protected leaf, once per deploy ----------
    shapes = lm.param_shapes(cfg)
    leaves = [s.shape for s in (shapes["embed"], shapes["head"],
                                *shapes["layers"]["attn"].values(),
                                *shapes["layers"]["mlp"].values())]
    nmax = max(math.prod(s) // 8 for s in leaves)
    raw = wot_blocks(torch, dev, nmax, gen)
    kt = pt = 0.0
    nbytes = 0
    for s in leaves:
        n = math.prod(s) // 8
        x = raw[:n]
        if not torch.equal(ecc_encode.ecc_encode(x),
                           ecc_encode.ecc_encode_plain(x)):
            fail(f"ecc_encode disagrees with its plain version at {s}")
        kt += timer.ms(lambda: ecc_encode.ecc_encode(x))
        pt += timer.ms(lambda: ecc_encode.ecc_encode_plain(x))
        nbytes += 16 * n
    bms, by = bound_ms(nbytes)
    out["ecc_encode"] = dict(
        source="src/repro_torch/csrc/ecc_codec.cu",
        replaces="src/repro/kernels/ecc_encode.py:49", max_abs_err=0.0,
        ms=kt, plain_ms=pt, bound_ms=bms, bound_by=by, library_ms=None)
    log(f"ecc_encode ({len(leaves)} leaves): {out['ecc_encode']}")
    # the kernel route also encodes each new KV token (one K and one V
    # slab of (batch, kv, hd) per layer): 60 launches per step
    tok = raw[: 4 * cfg.n_kv_heads * cfg.head_dim // 8]
    if not torch.equal(ecc_encode.ecc_encode(tok),
                       ecc_encode.ecc_encode_plain(tok)):
        fail("ecc_encode disagrees with its plain version on a KV token")
    km = timer.ms(lambda: ecc_encode.ecc_encode(tok))
    pm = timer.ms(lambda: ecc_encode.ecc_encode_plain(tok))
    log(f"ecc_encode KV token ({tok.shape[0]} blocks) x{2 * cfg.n_layers} "
        f"per step: kernel {km:.4f} ms, plain {pm:.4f} ms, bound "
        f"{bound_ms(16 * tok.shape[0])[0]:.6f} ms each")
    del raw

    # -- kernel 3: every projection and the head, 211 launches per step -----
    d, f, v, nl = cfg.d_model, cfg.d_ff, cfg.vocab_padded, cfg.n_layers
    b = 4
    per_step = [((d, d), 4 * nl), ((d, f), 2 * nl), ((f, d), nl), ((d, v), 1)]
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound": 0.0}
    err = 0.0
    scale = torch.tensor(0.02, dtype=torch.float32, device=dev)
    for (k, n), count in per_step:
        a = torch.randn((b, k), generator=gen, device=dev).to(torch.bfloat16)
        w_enc = ecc.encode64(wot_blocks(torch, dev, k * n // 8, gen))
        ns, nd = flip_blocks(torch, w_enc, 50, 20, gen)
        w_enc = w_enc.view(k, n)
        ko, kfl = ecc_qmatmul.ecc_qmatmul(a, w_enc, scale, with_flags=True)
        po, pfl = ecc_qmatmul.ecc_qmatmul_plain(a, w_enc, scale,
                                                with_flags=True)
        if kfl.tolist() != pfl.tolist() or kfl.tolist() != [ns, nd]:
            fail(f"ecc_qmatmul flags {kfl.tolist()} vs plain {pfl.tolist()} "
                 f"vs injected {[ns, nd]} at {(b, k, n)}")
        dec = ecc.decode64(w_enc.reshape(k, n // 8, 8))[0].reshape(k, n)
        w_bf = (dec.view(torch.int8).float() * scale).to(torch.bfloat16)
        mag = a.float().abs() @ w_bf.float().abs()
        e = (ko - po).abs()
        if bool((e > QMM_RTOL * mag + 1e-6).any()):
            fail(f"ecc_qmatmul out of tolerance at {(b, k, n)}: max "
                 f"{float(e.max())}")
        err = max(err, float(e.max()))
        km = timer.ms(lambda: ecc_qmatmul.ecc_qmatmul(a, w_enc, scale))
        pm = timer.ms(lambda: ecc_qmatmul.ecc_qmatmul_plain(a, w_enc, scale))
        lm_ = timer.ms(lambda: torch.matmul(a, w_bf))
        bb, _ = bound_ms(b * k * 2 + k * n + b * n * 4 + 4, 2 * b * k * n)
        log(f"ecc_qmatmul {(b, k, n)} x{count}: kernel {km:.4f} ms, plain "
            f"{pm:.4f} ms, torch.matmul(bf16 decoded) {lm_:.4f} ms, bound "
            f"{bb:.4f} ms, max abs err {float(e.max()):.3g}")
        tot["ms"] += count * km
        tot["plain_ms"] += count * pm
        tot["library_ms"] += count * lm_
        tot["bound"] += count * bb
        del a, w_enc, dec, w_bf, mag, ko, po
    out["ecc_qmatmul"] = dict(
        source="src/repro_torch/csrc/ecc_qmatmul.cu",
        replaces="src/repro/kernels/ecc_qmatmul.py:393", max_abs_err=err,
        ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound"],
        bound_by="bytes", library_ms=tot["library_ms"])
    log(f"ecc_qmatmul (per step, 211 launches): {out['ecc_qmatmul']}")
    check_qmatmul_paths(torch, dev, cfg, timer, gen)

    # -- kernel 4: fused page attention, 30 launches per step ---------------
    h, kvh, hd, s = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 64
    policy = kvcache.get_kv_policy("in-place-fused")
    kf_ = torch.randn((b, s, kvh, hd), generator=gen, device=dev)
    vf_ = torch.randn((b, s, kvh, hd), generator=gen, device=dev)
    ke, _, ksc = kvcache._encode_kv(kf_, policy)
    ve, _, vsc = kvcache._encode_kv(vf_, policy)
    ke, ve = ke.contiguous(), ve.contiguous()
    flip_blocks(torch, ke.view(-1, 8), 40, 10, gen)
    flip_blocks(torch, ve.view(-1, 8), 40, 10, gen)
    q = torch.randn((b, h, 1, hd), generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.tensor([63, 40, 15, 0], dtype=torch.int32, device=dev)
    args = (q, ke, None, ksc, ve, None, vsc, pos)
    ko, kfl = paged_attention.fused_page_attention(*args)
    po, pfl = paged_attention.fused_page_attention_plain(*args)
    if kfl.tolist() != pfl.tolist():
        fail(f"fused_page_attention flags {kfl.tolist()} vs plain "
             f"{pfl.tolist()}")
    e = float((ko.float() - po.float()).abs().max())
    if not torch.equal(ko, po):
        fail(f"fused_page_attention differs from its plain version in "
             f"{int((ko != po).sum())} outputs: max abs err {e}")
    kd_, vd_ = _decoded_bf16(torch, ke, ksc), _decoded_bf16(torch, ve, vsc)
    # timed with every row at pos S - 1, where the bound's bytes and
    # operations (all B * S tokens) are the work the kernel does
    args = args[:-1] + (torch.full((b,), s - 1, dtype=torch.int32,
                                   device=dev),)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    nbytes = (q.numel() * 2 + 2 * ke.numel() + 2 * ksc.numel() * 4 + 4 * b
              + q.numel() * 2 + b * kvh * 2 * 4)
    bb, by = bound_ms(nbytes, 4 * b * h * s * hd)
    out["fused_page_attention"] = dict(
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:175", max_abs_err=e,
        ms=cfg.n_layers * timer.ms(
            lambda: paged_attention.fused_page_attention(*args)),
        plain_ms=cfg.n_layers * timer.ms(
            lambda: paged_attention.fused_page_attention_plain(*args)),
        bound_ms=cfg.n_layers * bb, bound_by=by,
        library_ms=cfg.n_layers * timer.ms(lambda: sdpa(q, kd_, vd_)))
    log(f"fused_page_attention (per step, 30 launches of B={b} H={h} S={s}): "
        f"{out['fused_page_attention']}")
    del args, ke, ve, kd_, vd_
    out["chunked_page_attention"] = check_chunked(torch, dev, cfg, timer, gen)
    # the parity-zero decode and the per-slot flags of kernels 4 and 5, at
    # the shapes of the burst phase (phase 9)
    for name, pz in check_parity_zero(torch, dev, cfg, timer, gen).items():
        out[name]["parity_zero"] = pz
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"],
                                       pz["max_abs_err"])
    out["flash_attention"] = check_flash(torch, dev, cfg, timer, gen)
    out["quantize_throttle"] = check_quant_throttle(torch, dev, timer, gen)
    out["throttle"] = check_throttle(torch, dev, timer, gen)
    return out


def _decoded_bf16(torch, enc, sc):
    """Encoded (B, S, KV, hd) strip -> dequantized bf16 (B, KV, S, hd)."""
    from repro_torch.core import ecc
    b, s, kv, hd = enc.shape
    qv = ecc.decode64(enc.view(b, s, kv, hd // 8, 8))[0].view(torch.int8)
    return (qv.reshape(b, s, kv, hd).float() * sc[..., None, None]).to(
        torch.bfloat16).transpose(1, 2)


def _bits(torch, t):
    """A tensor's bit pattern, for bit-for-bit comparison."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[
        t.element_size()])


def _clamp_gap(torch, y, q=0.9, slack=0.0):
    """A clamp bound at or above the ``q`` quantile of |y|, in the middle
    of the first gap between neighbouring values wider than ``slack`` (the
    most the kernel's and the plain version's float outputs differ), so
    summation-order noise cannot move a value across it."""
    v = y.float().abs().flatten().sort().values
    i = int(q * (v.numel() - 1))
    wide = ((v[i + 1:] - v[i:-1]) > slack).nonzero()
    if not wide.numel():
        fail(f"no gap wider than {slack} above the {q} quantile")
    j = i + int(wide[0])
    return float((v[j] + v[j + 1]) / 2)


def check_qmatmul_paths(torch, dev, cfg, timer, gen):
    """ecc_qmatmul's int8, requantize, ABFT, clamp and fault_bits paths
    against the plain version on the card, at the full-width shapes: M = 4
    against wq, w_up, w_down and the head, M = 2,048 against w_up (the int8
    prefill, 64 row chunks), and a ragged (37, 1037, 1000); every weight
    carries 50 single- and 20 double-flip blocks. Raw int8 (with and
    without ABFT); the requantize epilogue with a scalar and a per-row
    a_scale, with and without bias, to bf16 and to f32 (ABFT on), and with
    a clamp; float bf16 with ABFT and a clamp. int32 accumulators and
    requantized outputs must be bit-equal, the float output within
    QMM_RTOL; flags, per-row mismatches and clamp hits, and the column
    count equal, and no mismatch. Then ``fault_bits`` at every bit 0..30
    on the int paths and 23..30 on the float path at the wq shape:
    rows[0, 0] == 1 and col_mm == 1 on both. Timed per decode step (211
    launches) and per prefill launch for five variants; the library call
    is ``torch._int_mm`` on the decoded int8 weight where its shape rules
    allow (M > 16), else ``torch.matmul`` of the decoded bf16 weight."""
    from repro_torch.core import ecc
    from repro_torch.kernels import ecc_qmatmul as Q
    d, f, v, nl = cfg.d_model, cfg.d_ff, cfg.vocab_padded, cfg.n_layers
    per_step = {(d, d): 4 * nl, (d, f): 2 * nl, (f, d): nl, (d, v): 1}
    ws = torch.tensor(0.02, dtype=torch.float32, device=dev)
    sc = torch.tensor(0.02, dtype=torch.float32, device=dev)
    f32, bf16 = torch.float32, torch.bfloat16
    timing = {}
    for name, m, k, n in (("wq", 4, d, d), ("w_up", 4, d, f),
                          ("w_down", 4, f, d), ("head", 4, d, v),
                          ("w_up prefill", 2048, d, f),
                          ("ragged", 37, 1037, 1000)):
        w_enc = ecc.encode64(wot_blocks(torch, dev, k * n // 8, gen))
        ns, nd = flip_blocks(torch, w_enc, 50, 20, gen)
        w_enc = w_enc.view(k, n)
        aq = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                           dtype=torch.int8)
        af = torch.randn((m, k), generator=gen, device=dev)
        af[0] *= 64   # |acc[0, 0]| away from [1, 2): a flip of bit 30
        af = af.to(bf16)  # must not make inf or NaN, which no check sees
        rows = 0.005 + 0.045 * torch.rand((m, 1), generator=gen, device=dev)
        bias = torch.randint(-5000, 5000, (n,), generator=gen, device=dev,
                             dtype=torch.int32)
        c_req = _clamp_gap(torch, Q.ecc_qmatmul_plain(
            aq, w_enc, ws, a_scale=sc, out_dtype=f32))
        po = Q.ecc_qmatmul_plain(af, w_enc, ws)
        c_flt = _clamp_gap(torch, po, slack=4 * float(
            (Q.ecc_qmatmul(af, w_enc, ws) - po).abs().max()))
        del po
        cases = {"int8": ((aq, w_enc), {}),
                 "int8+abft": ((aq, w_enc), dict(with_abft=True))}
        for form, a_s in (("scalar", sc), ("rows", rows)):
            for b in (None, bias):
                for odt in (bf16, f32):
                    key = (f"requant {form}{'' if b is None else '+bias'} "
                           f"{str(odt)[6:]}+abft")
                    cases[key] = ((aq, w_enc, ws), dict(
                        a_scale=a_s, bias=b, out_dtype=odt, with_abft=True))
        cases["requant rows bf16+abft+clamp"] = ((aq, w_enc, ws), dict(
            a_scale=rows[:, 0], with_abft=True, clamp=c_req))
        cases["float+abft+clamp"] = ((af, w_enc, ws), dict(
            with_abft=True, clamp=c_flt))
        dec = ecc.decode64(w_enc.reshape(k, n // 8, 8))[0].reshape(k, n)
        w_q = dec.view(torch.int8)
        w_bf = (w_q.float() * ws).to(bf16)
        for case, (args, kw) in cases.items():
            got = Q.ecc_qmatmul(*args, with_flags=True, **kw)
            want = Q.ecc_qmatmul_plain(*args, with_flags=True, **kw)
            where = f"ecc_qmatmul {case} at {(m, k, n)}"
            if got[1].tolist() != want[1].tolist() or \
                    got[1].tolist() != [ns, nd]:
                fail(f"{where}: flags {got[1].tolist()} vs plain "
                     f"{want[1].tolist()} vs injected {[ns, nd]}")
            if len(got) == 3:
                (gr, gc), (pr, pc) = got[2], want[2]
                if not torch.equal(gr, pr) or int(gc) != int(pc):
                    fail(f"{where}: ABFT/clamp counts differ from the plain "
                         f"version (rows {int((gr != pr).sum())} differ, "
                         f"col {int(gc)} vs {int(pc)})")
                if int(gr[:, 0].sum()) or int(gc):
                    fail(f"{where}: ABFT false positive on a clean product")
                if "clamp" in kw and not int(gr[:, 1].sum()):
                    fail(f"{where}: the clamp was never hit")
            if case.startswith("float"):
                mag = args[0].float().abs() @ w_bf.float().abs()
                e = (got[0] - want[0]).abs()
                if bool((e > QMM_RTOL * mag + 1e-6).any()):
                    fail(f"{where}: out of tolerance, max {float(e.max())}")
            elif not torch.equal(_bits(torch, got[0]), _bits(torch, want[0])):
                fail(f"{where}: {int((got[0] != want[0]).sum())} outputs "
                     f"differ from the plain version")
        log(f"ecc_qmatmul {name} {(m, k, n)}: {len(cases)} int8 / requantize "
            f"/ guarded float cases equal the plain version (flags "
            f"{[ns, nd]}, no ABFT mismatch)")
        if name == "wq":
            _check_fault_bits(torch, Q, aq, af, w_enc, ws, sc, gen)
        if name == "ragged":
            continue
        variants = {
            "float": ((af, w_enc, ws), {}),
            "float+abft+clamp": ((af, w_enc, ws),
                                 dict(with_abft=True, clamp=c_flt)),
            "requant": ((aq, w_enc, ws), dict(a_scale=sc)),
            "requant+abft+clamp": ((aq, w_enc, ws), dict(
                a_scale=sc, with_abft=True, clamp=c_req)),
            "int8": ((aq, w_enc), {})}
        for var, (args, kw) in variants.items():
            km = timer.ms(lambda: Q.ecc_qmatmul(*args, with_flags=True, **kw))
            pm = timer.ms(lambda: Q.ecc_qmatmul_plain(*args, with_flags=True,
                                                      **kw))
            integer = not var.startswith("float")
            if integer and m > 16:
                lib, lib_name = (lambda: torch._int_mm(aq, w_q)), "_int_mm"
            else:
                lib, lib_name = (lambda: torch.matmul(af, w_bf)), "matmul"
            lm_ = timer.ms(lib)
            out_bytes = {"int8": 4, "requant": 2, "requant+abft+clamp": 2}.get(
                var, 4)
            bb, by = bound_ms(k * n + m * k * (1 if integer else 2)
                              + m * n * out_bytes, 2 * m * k * n,
                              INT8_OPS if integer else BF16_FLOPS)
            if m == 4:
                t = timing.setdefault(var, {"ms": 0.0, "plain_ms": 0.0,
                                            "library_ms": 0.0,
                                            "bound_ms": 0.0,
                                            "bound_by": by,
                                            "library": lib_name})
                count = per_step[(k, n)]
                t["ms"] += count * km
                t["plain_ms"] += count * pm
                t["library_ms"] += count * lm_
                t["bound_ms"] += count * bb
            else:
                timing[f"{var} (M=2048, w_up)"] = {
                    "ms": km, "plain_ms": pm, "library_ms": lm_,
                    "bound_ms": bb, "bound_by": by, "library": lib_name}
            log(f"ecc_qmatmul {var} {(m, k, n)}: kernel {km:.4f} ms, plain "
                f"{pm:.4f} ms, {lib_name} {lm_:.4f} ms, bound {bb:.4f} ms "
                f"({by})")
        del w_enc, dec, w_q, w_bf, aq, af, cases, variants
    for var, t in timing.items():
        log(f"ecc_qmatmul {var}"
            f"{'' if 'M=2048' in var else ' (per decode step, 211 launches)'}"
            f": {t}")
    with open(OUT_DIR / "chip_smoke_qmatmul.json", "w") as fh:
        json.dump(timing, fh, indent=1)


def _check_fault_bits(torch, Q, aq, af, w_enc, ws, sc, gen):
    """fault_bits at every int bit on the raw int8 and requantize paths (at
    the given full-width wq shape) and at every exponent bit on the float
    path (at tests/test_abft.py's (16, 64, 64), then at the wq shape): the
    kernel and the plain version give equal counts, and the flip is found
    on row 0 and by the column check -- except that at the wq shape the
    float row check (over all of N = 4,096, within 1e-4 of the |a|·|w|
    checksum, as the reference's XLA route checks) cannot see a change of
    one element by a factor 2 to 16 (bits 23-25); there only the column
    check is required, and the row results are logged."""
    from repro_torch.core import ecc
    k = n = 64
    w_small = ecc.encode64(wot_blocks(torch, af.device, k * n // 8, gen))
    a_small = torch.randn((16, k), generator=gen, device=af.device)
    a_small[0] *= 64
    small = (a_small.to(torch.bfloat16), w_small.view(k, n), ws)
    paths = (("int8", (aq, w_enc), {}, range(31), True),
             ("requant", (aq, w_enc, ws), dict(a_scale=sc), range(31), True),
             ("float (16, 64, 64)", small, {}, range(23, 31), True),
             (f"float {(*af.shape, w_enc.shape[1])}", (af, w_enc, ws), {},
              range(23, 31), False))
    for name, args, kw, bits, need_row in paths:
        row_hits = []
        for bit in bits:
            res = [fn(*args, with_abft=True, fault_bits=1 << bit, **kw)[1]
                   for fn in (Q.ecc_qmatmul, Q.ecc_qmatmul_plain)]
            (rows, col_mm), (prow, pcol) = res
            if not torch.equal(rows, prow) or int(col_mm) != int(pcol):
                fail(f"ecc_qmatmul {name}: fault_bits 1 << {bit}: counts "
                     f"{rows[:, 0].tolist()}/{int(col_mm)} differ from the "
                     f"plain version's {prow[:, 0].tolist()}/{int(pcol)}")
            if int(col_mm) != 1 or int(rows[1:, 0].sum()) or (
                    need_row and int(rows[0, 0]) != 1):
                fail(f"ecc_qmatmul {name}: fault_bits 1 << {bit} not found "
                     f"(rows {rows[:, 0].tolist()}, col {int(col_mm)})")
            row_hits.append(int(rows[0, 0]))
        log(f"ecc_qmatmul fault_bits, {name}: bits {bits.start}..."
            f"{bits.stop - 1} all found by the column check, kernel equal to "
            f"the plain version; row 0 flagged per bit {row_hits}")


def check_chunked(torch, dev, cfg, timer, gen):
    """chunked_page_attention at the long-context path's decode shape (B 4,
    S 2,064 = 129 pages) and at B 1, S 16,384, KV 32, hd 128, bf16 q, with
    single- and double-flip blocks and ragged positions: flags equal to
    the plain version's, output within CHUNKED_* of it and within 2% of
    max|oracle| of the fp64 oracle. Timed at the path's last step (every
    row at pos S - 1), 30 launches per decode step."""
    from repro_torch.kernels import paged_attention
    from repro_torch.serving import kvcache
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    policy = kvcache.get_kv_policy("in-place-chunked")
    chunk = policy.chunk_pages * policy.page_size
    err = 0.0
    entry = None
    for b, s, ragged in ((4, 2064, (2063, 1500, 700, 0)), (1, 16384, (16000,))):
        ke, _, ksc = kvcache._encode_kv(
            torch.randn((b, s, kvh, hd), generator=gen, device=dev), policy)
        ve, _, vsc = kvcache._encode_kv(
            torch.randn((b, s, kvh, hd), generator=gen, device=dev), policy)
        ke, ve = ke.contiguous(), ve.contiguous()
        flip_blocks(torch, ke.view(-1, 8), 300, 100, gen)
        flip_blocks(torch, ve.view(-1, 8), 300, 100, gen)
        q = torch.randn((b, h, 1, hd), generator=gen, device=dev).to(
            torch.bfloat16)
        pos = torch.tensor(ragged, dtype=torch.int32, device=dev)
        args = (q, ke, None, ksc, ve, None, vsc, pos)
        ko, kfl = paged_attention.chunked_page_attention(*args,
                                                         chunk_tokens=chunk)
        po, pfl = paged_attention.chunked_page_attention_plain(
            *args, chunk_tokens=chunk)
        if kfl.tolist() != pfl.tolist() or kfl.tolist()[0] == 0:
            fail(f"chunked_page_attention flags {kfl.tolist()} vs plain "
                 f"{pfl.tolist()} at B={b} S={s}")
        e = (ko.float() - po.float()).abs()
        if bool((e > CHUNKED_RTOL * po.float().abs() + CHUNKED_ATOL).any()):
            fail(f"chunked_page_attention out of tolerance of its plain "
                 f"version at B={b} S={s}: max abs err {float(e.max())}")
        oracle = paged_attention.oracle_page_attention(*args)
        oerr = float(abs(ko.double().cpu().numpy() - oracle).max())
        otol = ORACLE_RTOL * float(abs(oracle).max())
        if oerr > otol:
            fail(f"chunked_page_attention {oerr} from the fp64 oracle at "
                 f"B={b} S={s} (> {otol})")
        err = max(err, float(e.max()))
        # the path's last decode step: every row at pos S - 1
        last = (q, ke, None, ksc, ve, None, vsc,
                torch.full((b,), s - 1, dtype=torch.int32, device=dev))
        km = timer.ms(lambda: paged_attention.chunked_page_attention(
            *last, chunk_tokens=chunk))
        pm = timer.ms(lambda: paged_attention.chunked_page_attention_plain(
            *last, chunk_tokens=chunk))
        kd_ = _decoded_bf16(torch, ke, ksc)
        vd_ = _decoded_bf16(torch, ve, vsc)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lm_ = timer.ms(lambda: sdpa(q, kd_, vd_))
        nbytes = (2 * q.numel() * 2 + 2 * b * s * kvh * hd + 2 * b * s * 4
                  + 4 * b + b * kvh * 2 * 4)
        bb, by = bound_ms(nbytes, 4 * b * h * s * hd)
        log(f"chunked_page_attention B={b} S={s} (chunk {chunk}): flags "
            f"{kfl.tolist()}, max abs err vs plain {float(e.max()):.3g}, vs "
            f"fp64 oracle {oerr:.3g} (gate {otol:.3g}); per launch kernel "
            f"{km:.4f} ms, plain {pm:.4f} ms, sdpa(decoded) {lm_:.4f} ms, "
            f"bound {bb:.5f} ms")
        if entry is None:
            n = cfg.n_layers
            entry = dict(source="src/repro_torch/csrc/chunked_attention.cu",
                         replaces="src/repro/kernels/paged_attention.py:313",
                         ms=n * km, plain_ms=n * pm, bound_ms=n * bb,
                         bound_by=by, library_ms=n * lm_)
        del ke, ve, kd_, vd_, args, last
    entry["max_abs_err"] = err
    log(f"chunked_page_attention (per step, 30 launches of B=4 H={h} "
        f"S=2064): {entry}")
    return entry


def _flip_check_bytes(torch, ch, every, gen):
    """Flip one random bit of every ``every``-th check byte, in place."""
    flat = ch.view(-1)
    idx = torch.arange(0, flat.numel(), every, device=ch.device)
    bits = torch.randint(0, 8, idx.shape, generator=gen, device=ch.device)
    flat[idx] ^= (torch.ones_like(bits) << bits).to(torch.uint8)


def _bad_bytes_truth(torch, clean, flipped, ch_clean, ch_flipped):
    """Per-byte parity failures from the flips themselves: a byte is bad
    when an odd number of its bits flipped XOR its check bit flipped
    (independent of the decode under test). -> (B, S, KV, hd) bool."""
    from repro_torch.core import ecc
    par = ecc.byte_parity(clean ^ flipped).bool()
    d = (ch_clean ^ ch_flipped).to(torch.int32)
    shifts = torch.arange(8, dtype=torch.int32, device=d.device)
    chk = ((d[..., None] >> shifts) & 1).bool().reshape(par.shape)
    return par ^ chk


def check_parity_zero(torch, dev, cfg, timer, gen):
    """Both paged-attention kernels under ``scheme="parity-zero"`` at the
    burst phase's shapes (B = BURST_SLOTS, S = BURST_MAX_LEN, KV 32, hd
    128, bf16 q), data bytes AND check bytes flipped, ragged positions:
    per-slot (2, B) rows and totals equal to the plain version's, the
    corrected count equal to the bad bytes of valid tokens (counted from
    the flips), DUE 0; the strip kernel bit-equal to its plain version,
    the chunked kernel within CHUNKED_* of it and ORACLE_RTOL of the fp64
    oracle. Timed per decode step (30 launches) at the path's last step
    (every row at pos S - 1), as rows 4-5."""
    from repro_torch.kernels import paged_attention
    from repro_torch.serving import kvcache
    b, s = BURST_SLOTS, BURST_MAX_LEN
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    policy = kvcache.get_kv_policy("parity-zero")
    strips, truth = [], 0
    pos = torch.tensor([127, 100, 64, 33, 16, 15, 1, 0][:b],
                       dtype=torch.int32, device=dev)
    valid = torch.arange(s, device=dev)[None, :] <= pos[:, None]
    for every in (97, 131):
        e, c, sc = kvcache._encode_kv(
            torch.randn((b, s, kvh, hd), generator=gen, device=dev), policy)
        e, c = e.contiguous(), c.contiguous()
        e0, c0 = e.clone(), c.clone()
        flip_blocks(torch, e.view(-1, 8), 300, 100, gen)
        _flip_check_bytes(torch, c, every, gen)
        bad = _bad_bytes_truth(torch, e0, e, c0, c)
        truth += int((bad.sum((-2, -1)) * valid).sum())
        strips += [e, c, sc]
    q = torch.randn((b, h, 1, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    args = (q, strips[0], strips[1], strips[2], strips[3], strips[4],
            strips[5], pos)
    chunk = min(kvcache.get_kv_policy("parity-zero-chunked").chunk_pages *
                policy.page_size, s)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kd_ = _decoded_parity_bf16(torch, *strips[0:3])
    vd_ = _decoded_parity_bf16(torch, *strips[3:6])
    last = args[:-1] + (torch.full((b,), s - 1, dtype=torch.int32,
                                   device=dev),)
    nbytes = (2 * q.numel() * 2 + 2 * b * s * kvh * hd
              + 2 * b * s * kvh * hd // 8 + 2 * b * s * 4 + 4 * b
              + b * kvh * 2 * 4)
    bb, by = bound_ms(nbytes, 4 * b * h * s * hd)
    n = cfg.n_layers
    out = {}
    for name, fn, plain, kw in (
            ("fused_page_attention", paged_attention.fused_page_attention,
             paged_attention.fused_page_attention_plain, {}),
            ("chunked_page_attention", paged_attention.chunked_page_attention,
             paged_attention.chunked_page_attention_plain,
             dict(chunk_tokens=chunk))):
        ko, rows = fn(*args, scheme="parity-zero", per_slot=True, **kw)
        po, prow = plain(*args, scheme="parity-zero", per_slot=True, **kw)
        _, tot = fn(*args, scheme="parity-zero", **kw)
        if not torch.equal(rows, prow) or rows.shape != (2, b):
            fail(f"{name} parity-zero per-slot rows {rows.tolist()} vs plain "
                 f"{prow.tolist()}")
        if tot.tolist() != rows.sum(1).tolist() or \
                tot.tolist() != [truth, 0] or truth == 0:
            fail(f"{name} parity-zero totals {tot.tolist()}: per-slot sum "
                 f"{rows.sum(1).tolist()}, bad bytes of valid tokens "
                 f"{truth}, DUE must be 0")
        e = (ko.float() - po.float()).abs()
        if name == "fused_page_attention":
            if not torch.equal(ko, po):
                fail(f"{name} parity-zero differs from its plain version in "
                     f"{int((ko != po).sum())} outputs: max abs err "
                     f"{float(e.max())}")
        else:
            if bool((e > CHUNKED_RTOL * po.float().abs()
                     + CHUNKED_ATOL).any()):
                fail(f"{name} parity-zero out of tolerance of its plain "
                     f"version: max abs err {float(e.max())}")
            oracle = paged_attention.oracle_page_attention(
                *args, scheme="parity-zero")
            oerr = float(abs(ko.double().cpu().numpy() - oracle).max())
            if oerr > ORACLE_RTOL * float(abs(oracle).max()):
                fail(f"{name} parity-zero {oerr} from the fp64 oracle")
        # timed at the path's last step (every row at pos S - 1), where
        # the bound's bytes and operations (all B * S tokens) are the work
        run = lambda f=fn, k=kw: f(*last, scheme="parity-zero",
                                   per_slot=True, **k)
        prun = lambda f=plain, k=kw: f(*last, scheme="parity-zero",
                                       per_slot=True, **k)
        out[name] = dict(
            ms=n * timer.ms(run), plain_ms=n * timer.ms(prun),
            bound_ms=n * bb, bound_by=by, max_abs_err=float(e.max()),
            library_ms=n * timer.ms(lambda: sdpa(q, kd_, vd_)))
        log(f"{name} parity-zero (per step, 30 launches of B={b} H={h} "
            f"S={s}): rows {rows.tolist()}, {truth} bad bytes of valid "
            f"tokens; {out[name]}")
    return out


def _decoded_parity_bf16(torch, enc, ch, sc):
    """Parity-zero (B, S, KV, hd) strip -> dequantized bf16 (B, KV, S, hd)."""
    from repro_torch.core import ecc
    qv = ecc.decode_parity8(enc, ch)[0].view(torch.int8)
    return (qv.float() * sc[..., None, None]).to(torch.bfloat16).transpose(
        1, 2)


def check_flash(torch, dev, cfg, timer, gen):
    """flash_attention at the prefill's shape (B 4, H 32, S 2,048, hd 128,
    bf16; 30 launches per prefill) and at a ragged S, against its plain
    version; library yardstick SDPA with ``is_causal=True``."""
    from repro_torch.kernels import flash_attention
    h, hd = cfg.n_heads, cfg.head_dim
    err = 0.0
    entry = None
    for b, s in ((4, 2048), (1, 1000)):
        q, k, v = (torch.randn((b, h, s, hd), generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(3))
        ko = flash_attention.flash_attention(q, k, v)
        po = flash_attention.flash_attention_plain(q, k, v)
        e = (ko.float() - po.float()).abs()
        if bool((e > FLASH_RTOL * po.float().abs() + FLASH_ATOL).any()):
            fail(f"flash_attention out of tolerance of its plain version at "
                 f"{(b, h, s, hd)}: max abs err {float(e.max())}")
        err = max(err, float(e.max()))
        log(f"flash_attention {(b, h, s, hd)}: max abs err vs plain "
            f"{float(e.max()):.3g}, mean {float(e.mean()):.3g}")
        if entry is None:
            sdpa = torch.nn.functional.scaled_dot_product_attention
            km = timer.ms(lambda: flash_attention.flash_attention(q, k, v))
            pm = timer.ms(lambda: flash_attention.flash_attention_plain(q, k,
                                                                        v))
            lm_ = timer.ms(lambda: sdpa(q, k, v, is_causal=True))
            ops = 4 * b * h * hd * s * (s + 1) // 2   # QK^T and PV, causal
            bb, by = bound_ms(4 * b * h * s * hd * 2, ops)
            n = cfg.n_layers
            entry = dict(source="src/repro_torch/csrc/flash_attention.cu",
                         replaces="src/repro/kernels/flash_attention.py:87",
                         ms=n * km, plain_ms=n * pm, bound_ms=n * bb,
                         bound_by=by, library_ms=n * lm_)
            log(f"flash_attention per launch: kernel {km:.4f} ms, plain "
                f"{pm:.4f} ms, sdpa(causal) {lm_:.4f} ms, bound {bb:.4f} ms "
                f"({ops / km / 1e9:.1f} TFLOP/s achieved)")
        del q, k, v, ko, po, e
    entry["max_abs_err"] = err
    log(f"flash_attention (per prefill, 30 launches of (4, 32, 2048, 128)): "
        f"{entry}")
    return entry


def _tie_blocks(torch, dev, nblk, gen):
    """f32 (nblk, 8) blocks whose quantization lands on exact rounding
    ties: absmax 127 * 2^-7 makes the scale 2^-7, so w / scale = k + 0.5
    exactly; positions 0..3 hold 63.5, -64.5, -63.5 (around the WOT
    bounds) and -0.0."""
    k = torch.randint(-127, 127, (nblk, 8), generator=gen, device=dev).float()
    k += 0.5
    k[:, 0], k[:, 1], k[:, 2], k[:, 3] = 63.5, -64.5, -63.5, -0.0
    k[0, 4] = 127.0
    return k * 2.0 ** -7


def train_leaf_shapes(cfg):
    """Shapes of the protected leaves of ``cfg``'s parameter tree (the
    leaves the QATT throttle and the deploy encode visit)."""
    from repro_torch import tree
    from repro_torch.core import wot
    from repro_torch.models import lm
    return [s.shape for path, s in tree.leaves_with_path(lm.param_shapes(cfg))
            if wot.is_protected_weight(path, s)]


def check_quant_throttle(torch, dev, timer, gen):
    """quantize_throttle against its plain version, byte-equal q and
    bit-equal scale: at the embedding leaf (52,428,800 blocks), a ragged
    size, exact rounding ties and an all-zero leaf (the eps clamp). Timed
    summed over the protected leaves one throttled train step of the
    training phase visits (the 8-layer full-width model); one call is two
    launches (absmax pass, quantize pass)."""
    from repro_torch.configs import get
    from repro_torch.core import wot
    from repro_torch.kernels import quant_throttle as qt
    cfg = get("deepseek-7b")
    emb = cfg.vocab_padded * cfg.d_model // 8
    cases = (("embedding", lambda: 0.02 * torch.randn(
                 (emb, 8), generator=gen, device=dev)),
             ("ragged", lambda: torch.randn((1_000_003, 8), generator=gen,
                                            device=dev)),
             ("ties", lambda: _tie_blocks(torch, dev, 1_000_000, gen)),
             ("zeros", lambda: torch.zeros((4096, 8), device=dev)))
    for name, make in cases:
        w = make()
        kq, ks = qt.quantize_throttle(w)
        pq, ps = qt.quantize_throttle_plain(w)
        if not torch.equal(kq, pq) or \
                ks.view(torch.int32).item() != ps.view(torch.int32).item():
            fail(f"quantize_throttle differs from its plain version on the "
                 f"{name} input ({w.shape[0]} blocks): "
                 f"{int((kq != pq).sum())} q bytes, scale {ks.item()!r} vs "
                 f"{ps.item()!r}")
        if int(wot.count_large_in_protected(kq.reshape(-1))):
            fail(f"quantize_throttle output breaks the WOT constraint "
                 f"({name})")
        if name == "embedding":
            bb, _ = bound_ms(9 * w.numel())
            km = timer.ms(lambda: qt.quantize_throttle(w))
            pm = timer.ms(lambda: qt.quantize_throttle_plain(w))
            lm_ = timer.ms(lambda: torch.linalg.vector_norm(w, float("inf")))
            log(f"quantize_throttle embedding leaf {tuple(w.shape)}: kernel "
                f"{km:.4f} ms, plain {pm:.4f} ms, vector_norm(inf) {lm_:.4f} "
                f"ms, bound {bb:.4f} ms")
        del w, kq, pq
    log("quantize_throttle: q byte-equal and scale bit-equal to the plain "
        "version on the embedding, ragged, ties and all-zero inputs")
    leaves = train_leaf_shapes(cfg.with_(n_layers=TRAIN_LAYERS))
    nmax = max(math.prod(s) for s in leaves)
    raw = 0.02 * torch.randn((nmax // 8, 8), generator=gen, device=dev)
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0}
    for s in leaves:
        w = raw[: math.prod(s) // 8]
        tot["ms"] += timer.ms(lambda: qt.quantize_throttle(w))
        tot["plain_ms"] += timer.ms(lambda: qt.quantize_throttle_plain(w))
        tot["library_ms"] += timer.ms(
            lambda: torch.linalg.vector_norm(w, float("inf")))
        tot["bytes"] += 9 * w.numel()
    del raw
    bb, by = bound_ms(tot["bytes"])
    entry = dict(source="src/repro_torch/csrc/quant_throttle.cu",
                 replaces="src/repro/kernels/quant_throttle.py:65",
                 max_abs_err=0.0, ms=tot["ms"], plain_ms=tot["plain_ms"],
                 bound_ms=bb, bound_by=by, library_ms=tot["library_ms"])
    log(f"quantize_throttle (per train step: {len(leaves)} protected leaves "
        f"of the {TRAIN_LAYERS}-layer model, one call = two launches each; "
        f"library = vector_norm(inf), pass 1 only): {entry}")
    return entry


def check_throttle(torch, dev, timer, gen):
    """throttle against its plain version (byte-equal) at the decode KV
    write (4 x 32 x 128 values = 2,048 blocks) and the prefill's (4 x
    2,048 x 32 x 128), and at ragged sizes, with the int8 extremes at
    every position. Timed per decode step of the slice-1 path: K and V of
    each of the 30 layers, 60 launches. Library: one ``torch.clamp`` with
    (8,) bound tensors."""
    from repro_torch.configs import get
    from repro_torch.kernels import throttle as thr
    cfg = get("deepseek-7b")
    tok = 4 * cfg.n_kv_heads * cfg.head_dim // 8
    lo = torch.tensor([-64] * 7 + [-128], dtype=torch.int8, device=dev)
    hi = torch.tensor([63] * 7 + [127], dtype=torch.int8, device=dev)
    entry = None
    for nblk in (tok, 2048 * tok, tok - 1, 2048 * tok + 1):
        q = torch.randint(-128, 128, (nblk, 8), generator=gen, device=dev,
                          dtype=torch.int8)
        q[0] = torch.tensor([-128, 127, -65, 64, -64, 63, 0, -128])
        kq, pq = thr.throttle(q), thr.throttle_plain(q)
        if not torch.equal(kq, pq) or not torch.equal(
                kq, torch.clamp(q, min=lo, max=hi)):
            fail(f"throttle differs from its plain version at {nblk} blocks")
        if nblk in (tok, 2048 * tok):
            km = timer.ms(lambda: thr.throttle(q))
            pm = timer.ms(lambda: thr.throttle_plain(q))
            lm_ = timer.ms(lambda: torch.clamp(q, min=lo, max=hi))
            bb, by = bound_ms(2 * q.numel())
            what = "decode KV write" if nblk == tok else "prefill KV write"
            log(f"throttle {what} ({nblk} blocks): kernel {km:.5f} ms, plain "
                f"{pm:.5f} ms, clamp {lm_:.5f} ms, bound {bb:.6f} ms")
            if entry is None:
                n = 2 * cfg.n_layers
                entry = dict(source="src/repro_torch/csrc/throttle.cu",
                             replaces="src/repro/kernels/throttle.py:35",
                             max_abs_err=0.0, ms=n * km, plain_ms=n * pm,
                             bound_ms=n * bb, bound_by=by, library_ms=n * lm_)
        del q, kq, pq
    log(f"throttle (per decode step, 60 launches of {tok} blocks): {entry}")
    return entry


# ---------------------------------------------------------------------------
# phase 3: kernel route against plain route, full width, depth cut to 2
# ---------------------------------------------------------------------------


def phase_routes(torch, dev):
    from repro_torch.configs import get
    from repro_torch.models import lm
    from repro_torch.protection import policy as policy_mod
    from repro_torch.serving import kvcache, protected

    cfg = get("deepseek-7b").with_(n_layers=2)
    pol = policy_mod.ProtectionPolicy(backend="cuda")
    plan = pol.plan(lm.param_shapes(cfg))
    enc = lm.init_params(cfg, 7, device=dev, leaf_fn=plan.encode_leaf)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    enc, _ = policy_mod.inject_tree_device(enc, 1e-5, gen)
    results = {}
    for route, kvp in (("cuda", "in-place-fused"), ("torch", "in-place")):
        step = protected.make_serve_step(cfg, backend=route, kv_policy=kvp)
        cache = kvcache.init_cache(cfg, 4, 64, kv_policy=kvp, device=dev)
        tok = torch.zeros((4, 1), dtype=torch.long, device=dev)
        logits, flags = [], []
        for t in range(2):
            pos = torch.full((4,), t, dtype=torch.int32, device=dev)
            lg, cache, fl = step(enc, cache, tok, pos)
            tok = torch.full_like(tok, 11 + t)  # same tokens on both routes
            logits.append(lg.float())
            flags.append({k: v.tolist() for k, v in fl.items()})
        results[route] = (torch.stack(logits), flags)
    (lk, fk), (lp, fp) = results["cuda"], results["torch"]
    if fk != fp:
        fail(f"routes disagree on flags: cuda {fk} vs torch {fp}")
    diff = (lk - lp).abs()
    log(f"2-layer full width, cuda vs torch route: flags equal {fk[0]['top']} "
        f"top; logits max abs diff {float(diff.max()):.4g}, mean "
        f"{float(diff.mean()):.4g} (|logits| max {float(lp.abs().max()):.3g})")
    if float(diff.max()) > E2E_MAX_ATOL or float(diff.mean()) > E2E_MEAN_ATOL:
        fail("kernel route logits out of tolerance of the plain route")

    # the long-context path: prefill a ragged prompt, then chunked decode
    # steps (kernel route: flash prefill, chunked kernel; plain route:
    # chunked_causal_attention prefill, decode-then-attend)
    prompt_len, steps = 1000, 3
    gen.manual_seed(8)
    prompt = torch.randint(0, cfg.vocab, (4, prompt_len), generator=gen,
                           device=dev)
    results = {}
    for route, kvp in (("cuda", "in-place-chunked"), ("torch", "in-place")):
        prefill = protected.make_prefill(cfg, backend=route, kv_policy=kvp,
                                         with_flags=True)
        step = protected.make_serve_step(cfg, backend=route, kv_policy=kvp)
        cache = kvcache.init_cache(cfg, 4, prompt_len + steps, kv_policy=kvp,
                                   device=dev)
        lg, cache, fl = prefill(enc, cache, prompt)
        logits = [lg.float()]
        flags = [{k: v.tolist() for k, v in fl.items()}]
        for t in range(steps):
            tok = torch.full((4, 1), 21 + t, dtype=torch.long, device=dev)
            pos = torch.full((4,), prompt_len + t, dtype=torch.int32,
                             device=dev)
            lg, cache, fl = step(enc, cache, tok, pos)
            logits.append(lg.float())
            flags.append({k: v.tolist() for k, v in fl.items()})
        results[route] = (logits, flags)
        del cache
    (lk, fk), (lp, fp) = results["cuda"], results["torch"]
    if fk != fp:
        fail(f"prefill/chunked routes disagree on flags: cuda {fk} vs torch "
             f"{fp}")
    for name, a, b in (("prefill", lk[0], lp[0]),
                       ("chunked decode", torch.cat(lk[1:]),
                        torch.cat(lp[1:]))):
        diff = (a - b).abs()
        log(f"2-layer full width {name} ({prompt_len}-token prompt), cuda vs "
            f"torch route: logits max abs diff {float(diff.max()):.4g}, mean "
            f"{float(diff.mean()):.4g} (|logits| max "
            f"{float(b.abs().max()):.3g}); flags equal "
            f"(prefill weight rows {fk[0]['layers']})")
        if float(diff.max()) > E2E_MAX_ATOL or \
                float(diff.mean()) > E2E_MEAN_ATOL:
            fail(f"kernel route {name} logits out of tolerance of the plain "
                 f"route")
    route_bursts(torch, dev, cfg, enc)
    del enc


def _pool_flipper(torch, dev, keys, every=4, n=400, seed=100, extra=()):
    """A ``before_step`` hook flipping ``n`` seeded bits of each pool in
    ``keys`` (encoded pages and check planes) every ``every`` steps, in the
    front-end's cache and in each cache of ``extra``: the same bits on
    every cache and every front-end it is given to."""
    from repro_torch.core import faults

    def flip(fe):
        if fe.step_no % every:
            return
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + fe.step_no)
        for key in keys:
            pos = torch.randint(0, fe.cache[key].numel() * 8, (n,),
                                generator=gen, device=dev)
            for cache in (fe.cache, *extra):
                faults.flip_positions_(cache[key].view(-1), pos)
    return flip


def _row_recorder(store: list):
    """An ``after_step`` hook keeping each step's per-slot KV rows
    (n_layers, 2, B) and the slots that served a request."""
    def rec(fe):
        store.append((fe.last_flags["layers_kv"].cpu(), fe.last_active))
    return rec


def route_bursts(torch, dev, cfg, enc):
    """The burst path on both routes at 2 full-width layers, in f32, in
    lockstep: one front-end drives the plain route (``parity-zero``, decode
    then attend) and, with the same tokens and positions and its own copy
    of the page tables, the kernel route (``parity-zero-fused`` or
    ``-chunked``) on a cache of its own; the same flips hit both caches'
    pages and check planes every 4 steps. At every step the kernel route's
    (n_layers, 2, B) KV rows must equal the plain route's, its logits lie
    within ROUTE_F32_ATOL of them, and its greedy token equal the plain
    route's wherever the plain route's top logit leads the kernel route's
    pick by more than ROUTE_F32_ATOL (a split inside that is a near-tie,
    counted). Lockstep, because the two routes' K/V differ by int8
    rounding (a last-ulp difference in k crosses a quantization boundary)
    and two free-running bursts part at the first near-tie."""
    import dataclasses

    from repro_torch.serving import frontend, kvcache, protected
    waves = frontend.make_waves(seed=1, n_waves=2, wave_size=12,
                                prompt_len=(8, 24), max_new=(4, 8),
                                gap_steps=8, vocab=cfg.vocab)
    keys = ("k_pages", "v_pages", "k_checks", "v_checks")
    per_slot = lambda name: dataclasses.replace(
        kvcache.get_kv_policy(name), per_slot_flags=True)
    plain_step = protected.make_serve_step(
        cfg, backend="torch", kv_policy=per_slot("parity-zero"),
        dtype=torch.float32)
    npg = kvcache.pages_per_seq(BURST_MAX_LEN, 16)
    for name in ("parity-zero-fused", "parity-zero-chunked"):
        kstep = protected.make_serve_step(cfg, backend="cuda",
                                          kv_policy=per_slot(name),
                                          dtype=torch.float32)
        kcache = kvcache.init_paged_cache(
            cfg, BURST_SLOTS, BURST_MAX_LEN, name,
            n_pages=BURST_SLOTS * (1 + npg), device=dev)
        st = {"steps": 0, "ties": 0, "max_diff": 0.0, "corrected": 0}

        def lockstep(weights, cache, tokens, pos):
            kcache["kv_table"].copy_(cache["kv_table"])
            lk, _, fk = kstep(weights, kcache, tokens, pos)
            lp, cache, fp = plain_step(weights, cache, tokens, pos)
            if not torch.equal(fk["layers_kv"], fp["layers_kv"]):
                fail(f"route bursts: {name} per-slot KV rows "
                     f"{fk['layers_kv'].sum(0).tolist()} differ from the "
                     f"plain route's {fp['layers_kv'].sum(0).tolist()} at "
                     f"step {st['steps']}")
            lk, lp = lk[:, -1].float(), lp[:, -1].float()
            st["max_diff"] = max(st["max_diff"],
                                 float((lk - lp).abs().max()))
            pick_k, pick_p = lk.argmax(-1), lp.argmax(-1)
            for i in (pick_k != pick_p).nonzero().flatten().tolist():
                lead = float(lp[i, pick_p[i]] - lp[i, pick_k[i]])
                if lead > ROUTE_F32_ATOL:
                    fail(f"route bursts: {name} picks token {int(pick_k[i])}"
                         f" where the plain route's {int(pick_p[i])} leads "
                         f"by {lead:.4g} (step {st['steps']}, slot {i})")
                st["ties"] += 1
            st["steps"] += 1
            st["corrected"] += int(fp["layers_kv"][:, 0].sum())
            return lp[:, None], cache, fp

        _, summ, _ = frontend.run_burst(
            cfg, enc, waves=waves, slots=BURST_SLOTS, max_len=BURST_MAX_LEN,
            kv_policy="parity-zero", serve_step=lockstep,
            dtype=torch.float32, backend="torch", device=dev,
            before_step=_pool_flipper(torch, dev, keys, extra=(kcache,)))
        if st["max_diff"] > ROUTE_F32_ATOL or st["corrected"] == 0 or \
                summ["due"]["total"]:
            fail(f"route bursts: {name} logits {st['max_diff']:.4g} from "
                 f"the plain route (> {ROUTE_F32_ATOL}?), {st['corrected']} "
                 f"corrected bytes, DUE {summ['due']['total']}")
        log(f"2-layer full-width burst in lockstep, {name} (cuda) vs "
            f"parity-zero (torch), f32: {st['steps']} steps, per-slot KV rows"
            f" equal at every step ({st['corrected']} corrected bytes), "
            f"logits within {st['max_diff']:.4g}, greedy tokens equal but "
            f"for {st['ties']} near-ties within {ROUTE_F32_ATOL}")
        del kcache


# ---------------------------------------------------------------------------
# phase 4: the main path — full-width deepseek-7b, clean and faulted
# ---------------------------------------------------------------------------


def phase_full(torch, dev, build):
    """Three 16-step runs: clean; faulted at ``rate`` (corrected and DUE
    counts against the injected single- and double-flip blocks); and
    faulted at ``rate`` with at most one flip per code block, which must
    give the clean run's logits and tokens bit for bit."""
    from repro_torch.configs import get
    from repro_torch.launch.serve import serve

    cfg = get("deepseek-7b")
    tokens, batch, rate = 16, 4, 1e-6
    kw = dict(backend="cuda", kv_policy="in-place-fused", batch=batch,
              tokens=tokens, device="cuda", log=log)
    build.reset_counts()
    clean = serve(cfg, **kw)
    torch.cuda.empty_cache()
    faulted = serve(cfg, fault_rate=rate, **kw)
    torch.cuda.empty_cache()
    fixed = serve(cfg, fault_rate=rate, correctable_only=True, **kw)
    counts = dict(build.COUNTS)
    log(f"launch counts over the three runs: {counts}")

    lg = clean["logits"]
    if lg.shape != (tokens, batch, cfg.vocab_padded) or \
            not bool(torch.isfinite(lg.float()).all()):
        fail(f"clean logits: shape {tuple(lg.shape)} or non-finite values")
    if clean["flags"] != {"corrected": 0, "due": 0, "kv_corrected": 0,
                          "kv_due": 0}:
        fail(f"clean run reported faults: {clean['flags']}")

    def block_counts(positions):
        hist = {1: 0, 2: 0, "3+": 0}
        for pos in positions.values():
            _, c = torch.unique(pos // 64, return_counts=True)
            hist[1] += int((c == 1).sum())
            hist[2] += int((c == 2).sum())
            hist["3+"] += int((c >= 3).sum())
        return hist

    wh = block_counts(faulted["weight_positions"])
    kh = block_counts(faulted["kv_positions"])
    fl = faulted["flags"]
    log(f"faulted run: weight blocks with 1/2/3+ flips {wh}, KV {kh}; "
        f"reported {fl}")
    if wh["3+"]:
        fail("a weight block took 3+ flips: its accounting is undefined")
    if fl["corrected"] != tokens * wh[1] or fl["due"] != tokens * wh[2]:
        fail(f"weight fault accounting {fl['corrected']}/{fl['due']} != "
             f"{tokens}x injected single/double blocks {wh[1]}/{wh[2]}")

    ch = block_counts(fixed["weight_positions"])
    ckh = block_counts(fixed["kv_positions"])
    ff = fixed["flags"]
    log(f"correctable-only run: weight blocks with 1/2/3+ flips {ch}, KV "
        f"{ckh}; reported {ff}")
    if ch[1] == 0 or ckh[1] == 0 or ch[2] or ch["3+"] or ckh[2] or ckh["3+"]:
        fail("the correctable-only run did not inject exactly one flip into "
             "each hit block of the weights and the KV pools")
    if ff["corrected"] != tokens * ch[1] or ff["due"] or ff["kv_due"]:
        fail(f"correctable-only accounting {ff} != {tokens} x {ch[1]} "
             f"corrected weight blocks and no DUE")
    if not (torch.equal(fixed["logits"], clean["logits"])
            and torch.equal(fixed["tokens"], clean["tokens"])):
        d = (fixed["logits"].float() - clean["logits"].float()).abs().max()
        fail(f"every flip was correctable, yet the logits differ from the "
             f"clean run (max abs diff {float(d)})")
    log("correctable-only run: logits and greedy tokens equal the clean run "
        "bit for bit")
    runs = (("clean", clean), ("faulted", faulted),
            ("correctable-only", fixed))
    for name, r in runs:
        log(f"full width {name}: {r['tok_per_s']:.1f} tok/s, median "
            f"{statistics.median(r['step_ms']):.2f} ms/step, first step "
            f"{r['step_ms'][0]:.2f} ms")
    with open(OUT_DIR / "chip_smoke_serve.json", "w") as fh:
        json.dump({n: {"tok_per_s": r["tok_per_s"], "step_ms": r["step_ms"],
                       "flags": r["flags"]} for n, r in runs}, fh, indent=1)
    return counts


# ---------------------------------------------------------------------------
# phase 5: the long-context path — prefill + chunked decode, full width
# ---------------------------------------------------------------------------


def phase_long(torch, dev, build):
    """Two runs of a 2,048-token prompt per row plus 16 decode steps under
    ``in-place-chunked``: clean, and with at most one flip per weight code
    block at ``rate`` (the KV pools take correctable flips mid-run too).
    The faulted run must give the clean run's prefill logits, decode logits
    and tokens bit for bit, and count each flipped weight block once per
    call: 1 prefill + 16 steps = 17 times."""
    from repro_torch.configs import get
    from repro_torch.launch.serve import serve

    cfg = get("deepseek-7b")
    prompt_len, tokens, batch, rate = 2048, 16, 4, 1e-6
    kw = dict(backend="cuda", kv_policy="in-place-chunked", batch=batch,
              tokens=tokens, prompt_len=prompt_len, device="cuda", log=log)
    torch.cuda.empty_cache()
    build.reset_counts()
    clean = serve(cfg, **kw)
    clean_counts = dict(build.COUNTS)
    torch.cuda.empty_cache()
    fixed = serve(cfg, fault_rate=rate, correctable_only=True, **kw)
    counts = dict(build.COUNTS)
    log(f"launch counts over the two long-context runs: {counts} (clean run "
        f"alone: {clean_counts})")
    per_run = {"flash_attention": cfg.n_layers,
               "chunked_page_attention": cfg.n_layers * tokens}
    for k, n in per_run.items():
        if clean_counts[k] != n or counts[k] != 2 * n:
            fail(f"{k}: {clean_counts[k]} launches in the clean run, "
                 f"{counts[k]} in both; expected {n} per run")

    pl = clean["prefill_logits"]
    if pl.shape != (batch, prompt_len, cfg.vocab_padded) or \
            not bool(torch.isfinite(pl.float()).all()) or \
            not bool(torch.isfinite(clean["logits"].float()).all()):
        fail(f"prefill logits {tuple(pl.shape)} or decode logits not finite")
    if clean["flags"] != {"corrected": 0, "due": 0, "kv_corrected": 0,
                          "kv_due": 0}:
        fail(f"clean long-context run reported faults: {clean['flags']}")
    singles = {}
    for name, pos in fixed["weight_positions"].items():
        _, c = torch.unique(pos // 64, return_counts=True)
        if c.numel() and int(c.max()) > 1:
            fail(f"{name}: a weight block took more than one flip")
        singles[name] = int(c.numel())
    n_single = sum(singles.values())
    ff = fixed["flags"]
    log(f"long-context correctable-only run: {n_single} single-flip weight "
        f"blocks; reported {ff}")
    calls = 1 + tokens
    if n_single == 0 or ff["corrected"] != calls * n_single or ff["due"] or \
            ff["kv_due"] or ff["kv_corrected"] == 0:
        fail(f"long-context accounting {ff} != {calls} x {n_single} "
             f"corrected weight blocks and no DUE")
    for name in ("prefill_logits", "logits", "tokens"):
        if not torch.equal(fixed[name], clean[name]):
            fail(f"every flip was correctable, yet the {name} differ from "
                 f"the clean run")
    log("long-context correctable-only run: prefill logits, decode logits "
        "and tokens equal the clean run bit for bit")
    for name, r in (("clean", clean), ("correctable-only", fixed)):
        log(f"long context {name}: prefill {batch} x {prompt_len} tokens in "
            f"{r['prefill_s']:.3f} s ({r['prefill_tok_per_s']:.1f} tok/s); "
            f"decode at context {prompt_len + 1}..{prompt_len + tokens}: "
            f"{r['tok_per_s']:.2f} tok/s, median "
            f"{statistics.median(r['step_ms']):.2f} ms/step")
    with open(OUT_DIR / "chip_smoke_long.json", "w") as fh:
        json.dump({n: {"prefill_s": r["prefill_s"],
                       "prefill_tok_per_s": r["prefill_tok_per_s"],
                       "tok_per_s": r["tok_per_s"], "step_ms": r["step_ms"],
                       "flags": r["flags"]}
                   for n, r in (("clean", clean),
                                ("correctable-only", fixed))}, fh, indent=1)
    return counts


# ---------------------------------------------------------------------------
# phase 6: where the time goes (torch.profiler)
# ---------------------------------------------------------------------------


def _profile_table(torch, prof, wall_ms, what, fname, rows=18, ranges=()):
    """Log the device-busy share of a profiled window and print its top
    ops; -> the device-side (kernel) events. An operator row's self device
    time repeats its kernels' rows, so only kernel rows are summed; so
    does the device-side row of a ``record_function`` range (its name in
    ``ranges``), which is left out."""
    avg = prof.key_averages()
    kernels = [e for e in avg
               if e.device_type == torch.autograd.DeviceType.CUDA and
               e.key not in ranges]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"profile, {what}: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms "
        f"wall ({100 * busy_ms / wall_ms:.1f}%), "
        f"{sum(e.count for e in kernels)} kernel launches")
    table = avg.table(sort_by="self_device_time_total", row_limit=25)
    with open(OUT_DIR / fname, "w") as fh:
        fh.write(table)
    for line in table.splitlines()[:rows]:
        print(line, flush=True)
    return kernels


def phase_profile(torch):
    """Profile 4 decode steps of the full-width kernel route, built as
    ``serve`` builds it, and then one full-width prefill of a 2,048-token
    prompt per row (batch 4, ``in-place-chunked``) with 2 chunked decode
    steps (after the timed runs; the launch counts are already read).
    Prints the device-busy share of each profiled window's wall time, the
    ops with the most device time, and the prefill's device time split
    into projections, attention, KV encode and decode, and the rest."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get
    from repro_torch.models import lm
    from repro_torch.protection import policy as policy_mod
    from repro_torch.serving import kvcache, protected

    cfg, dev, batch = get("deepseek-7b"), torch.device("cuda"), 4
    torch.cuda.empty_cache()
    plan = policy_mod.ProtectionPolicy(backend="cuda").plan(
        lm.param_shapes(cfg))
    enc = lm.init_params(cfg, 0, device=dev, leaf_fn=plan.encode_leaf)
    step = protected.make_serve_step(cfg, plan=plan, backend="cuda",
                                     kv_policy="in-place-fused")
    cache = kvcache.init_cache(cfg, batch, 64, kv_policy="in-place-fused",
                               device=dev)
    tok = torch.zeros((batch, 1), dtype=torch.long, device=dev)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.time()
        for t in range(4):
            pos = torch.full((batch,), t, dtype=torch.int32, device=dev)
            logits, cache, _ = step(enc, cache, tok, pos)
            tok = logits.argmax(dim=-1)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0)
    _profile_table(torch, prof, wall_ms, "4 full-width decode steps",
                   "chip_smoke_profile.txt")
    del cache

    prompt_len = 2048
    kvp = "in-place-chunked"
    prefill = protected.make_prefill(cfg, plan=plan, backend="cuda",
                                     kv_policy=kvp)
    step = protected.make_serve_step(cfg, plan=plan, backend="cuda",
                                     kv_policy=kvp)
    cache = kvcache.init_cache(cfg, batch, prompt_len + 2, kv_policy=kvp,
                               device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                           device=dev)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.time()
        logits, cache = prefill(enc, cache, prompt)
        torch.cuda.synchronize()
        pre_ms = 1e3 * (time.time() - t0)
        tok = logits[:, -1:].argmax(dim=-1)
        for t in range(2):
            pos = torch.full((batch,), prompt_len + t, dtype=torch.int32,
                             device=dev)
            logits, cache, _ = step(enc, cache, tok, pos)
            tok = logits.argmax(dim=-1)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0)
    kernels = _profile_table(
        torch, prof, wall_ms, f"one full-width prefill ({pre_ms:.0f} ms of "
        f"wall) + 2 chunked decode steps", "chip_smoke_prefill_profile.txt")
    split = {"projections (qmatmul_kernel)": 0.0,
             "prefill attention (flash_kernel)": 0.0,
             "decode attention (chunked_attention_kernel)": 0.0,
             "KV encode (encode_kernel)": 0.0,
             "KV and embedding decode (decode_kernel)": 0.0, "other": 0.0}
    for e in kernels:
        t = e.self_device_time_total / 1e3
        key = next((k for k in split if k.split("(")[-1].rstrip(")") in
                    e.key), "other")
        split[key] += t
    log("profile split (device ms over the window): " + ", ".join(
        f"{k} {v:.2f}" for k, v in split.items()))


# ---------------------------------------------------------------------------
# phase 7: the training path — QATT steps, throttle, deploy, serve
# ---------------------------------------------------------------------------


def event_ms(torch, fn):
    """CUDA-event time of one call of ``fn`` (work of tens of ms and more,
    where the host's enqueue is hidden)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b), out


def phase_train(torch, dev, build, cfg, *, batch=8, seq=2048, steps=4,
                serve_tokens=8, rate=1e-6):
    """QAT training with WOT throttling of ``cfg`` through the port's
    ``launch.train.train`` on the kernel route, then deploy and serve.

    ``steps - 1`` throttled steps (the first a warm-up), then a last
    update with ``wot_throttle=False`` whose masters are throttled through
    both routes: masters, int8 q and scales must be bit-equal, and every
    leaf's q must meet the WOT constraint. The trained masters are deployed
    (quantize-throttle + in-place encode) on both routes, byte-equal, and
    ``serve_tokens`` greedy steps at batch 4 under ``in-place-fused`` are
    served from the deployed weights clean and with correctable weight
    faults only: bit-equal logits and tokens, each flipped block counted
    once per step. -> (launch counts over the path, the trained params)."""
    from repro_torch import tree
    from repro_torch.core import wot
    from repro_torch.data import synthetic
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import train
    from repro_torch.protection.policy import ProtectionPolicy
    from repro_torch.training import train as train_mod

    lr, tok_per_step = 1e-4, batch * seq
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.reset_counts()
    out = train(cfg, steps=steps - 1, batch=batch, seq=seq, lr=lr, seed=0,
                chunk=2048, backend="cuda", device=dev, log=log)
    params, opt = out["params"], out["opt_state"]
    losses, step_ms = list(out["losses"]), list(out["step_ms"])
    # the last step: the update without the throttle, then both routes
    b = synthetic.token_batch(cfg.vocab_padded, batch, seq, seed=0,
                              step=steps - 1)
    b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    step = train_mod.make_train_step(cfg, lr=lr, wot_throttle=False,
                                     chunk=2048, backend="cuda")
    torch.cuda.synchronize()
    upd_ms, (params, opt, loss) = event_ms(torch,
                                           lambda: step(params, opt, b))
    losses.append(float(loss))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    moved = n_w = 0
    thr_ms = {"cuda": 0.0, "torch": 0.0}
    with torch.no_grad():
        for path, w in tree.leaves_with_path(params):
            if not wot.is_protected_weight(path, w):
                continue
            res = {}
            for route in ("cuda", "torch"):   # w itself is not modified
                ms, res[route] = event_ms(torch, lambda: wot.throttle_tensor(
                    w, backend=route, with_q=True))
                thr_ms[route] += ms
            (kw, kq, ks), (pw, pq, ps) = res["cuda"], res["torch"]
            name = tree.path_str(path)
            same_scale = torch.equal(ks.view(torch.int32),
                                     ps.view(torch.int32))
            if not (torch.equal(kw.view(torch.int32), pw.view(torch.int32))
                    and torch.equal(kq, pq) and same_scale):
                fail(f"throttle of {name}: the kernel route differs from the "
                     f"plain route")
            if int(wot.count_large_in_protected(kq.reshape(-1))):
                fail(f"{name}: throttled q breaks the WOT constraint")
            moved += int((kw != w).sum())
            n_w += w.numel()
            w.copy_(kw)
            del res, kw, kq, pw, pq
    step_ms.append(upd_ms + thr_ms["cuda"])
    if not all(math.isfinite(x) for x in losses):
        fail(f"training losses not finite: {losses}")
    med = statistics.median(step_ms[1:])
    log(f"training {cfg.name} x {cfg.n_layers} layers, batch {batch} x "
        f"{seq}: losses {losses}; ms/step {[round(x, 2) for x in step_ms]} "
        f"(the last: update {upd_ms:.2f} + kernel-route throttle "
        f"{thr_ms['cuda']:.2f}); median of steps 2..{steps} {med:.2f} "
        f"ms/step, {tok_per_step / med * 1e3:.1f} tokens/s; peak device "
        f"memory {peak_gb:.2f} GB")
    log(f"last step's throttle: masters, q and scales bit-equal on both "
        f"routes; {moved} of {n_w} weights moved; WOT constraint holds on "
        f"every protected leaf; kernel route {thr_ms['cuda']:.2f} ms, plain "
        f"route {thr_ms['torch']:.2f} ms")
    del opt, step, b
    torch.cuda.empty_cache()

    enc = {}
    for route in ("cuda", "torch"):
        enc[route] = ProtectionPolicy("in-place",
                                      backend=route).encode_tree(params)
    n_leaves = 0
    for path, pt in tree.leaves_with_path(enc["cuda"]):
        other = tree.get_path(enc["torch"], path)
        if not hasattr(pt, "enc"):
            continue
        n_leaves += 1
        if not (torch.equal(pt.enc, other.enc) and torch.equal(
                pt.scale.view(torch.int32), other.scale.view(torch.int32))):
            fail(f"deploy of {tree.path_str(path)}: encoded image or scale "
                 f"differs between the routes")
    del enc["torch"]
    log(f"deploy: {n_leaves} encoded images and scales byte-equal on both "
        f"routes")

    kw = dict(backend="cuda", kv_policy="in-place-fused", batch=4,
              tokens=serve_tokens, device=dev, weights=enc["cuda"], log=log)
    clean = serve(cfg, **kw)
    fixed = serve(cfg, fault_rate=rate, correctable_only=True, **kw)
    counts = dict(build.COUNTS)
    lg = clean["logits"]
    if lg.shape != (serve_tokens, 4, cfg.vocab_padded) or \
            not bool(torch.isfinite(lg.float()).all()):
        fail(f"served logits: shape {tuple(lg.shape)} or non-finite values")
    if clean["flags"] != {"corrected": 0, "due": 0, "kv_corrected": 0,
                          "kv_due": 0}:
        fail(f"clean serve of the trained weights reported faults: "
             f"{clean['flags']}")
    n_single = 0
    for name, pos in fixed["weight_positions"].items():
        _, c = torch.unique(pos // 64, return_counts=True)
        if c.numel() and int(c.max()) > 1:
            fail(f"{name}: a weight block took more than one flip")
        n_single += int(c.numel())
    ff = fixed["flags"]
    if n_single == 0 or ff["corrected"] != serve_tokens * n_single or \
            ff["due"] or ff["kv_due"]:
        fail(f"trained-weight serve accounting {ff} != {serve_tokens} x "
             f"{n_single} corrected blocks and no DUE")
    if not (torch.equal(fixed["logits"], clean["logits"])
            and torch.equal(fixed["tokens"], clean["tokens"])):
        fail("every flip was correctable, yet the served logits differ from "
             "the clean run")
    log(f"served the trained weights: {serve_tokens} steps x batch 4, clean "
        f"and correctable-only ({n_single} flipped blocks, {ff}) bit-equal; "
        f"{statistics.median(clean['step_ms']):.2f} ms/step clean")
    log(f"launch counts over the training path: {counts}")
    with open(OUT_DIR / "chip_smoke_train.json", "w") as fh:
        json.dump({"config": f"{cfg.name} n_layers={cfg.n_layers}",
                   "batch": batch, "seq": seq, "losses": losses,
                   "step_ms": step_ms, "median_ms": med,
                   "tokens_per_s": tok_per_step / med * 1e3,
                   "peak_gb": peak_gb, "throttle_ms": thr_ms,
                   "moved": moved, "serve_step_ms": clean["step_ms"],
                   "serve_flags": ff}, fh, indent=1)
    del enc, clean, fixed
    return counts, params


def phase_train_profile(torch, dev, cfg, params, *, batch=8, seq=2048):
    """One more throttled train step under ``torch.profiler``, from the
    trained masters: device time split into projections (``aten::mm``),
    attention matmuls (``aten::bmm``), the optimizer and the throttle (the
    step's ``sgd_momentum`` and ``wot_throttle`` ranges), and the rest."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import synthetic
    from repro_torch.training import optim
    from repro_torch.training import train as train_mod
    opt = optim.sgd_init(params)
    step = train_mod.make_train_step(cfg, chunk=2048, backend="cuda")
    b = synthetic.token_batch(cfg.vocab_padded, batch, seq, seed=0, step=9)
    b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.time()
        step(params, opt, b)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0)
    ranges = ("sgd_momentum", "wot_throttle")
    kernels = _profile_table(torch, prof, wall_ms, "one full train step",
                             "chip_smoke_train_profile.txt", ranges=ranges)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    split = {"projections (aten::mm)": 0.0,
             "attention matmuls (aten::bmm)": 0.0,
             "optimizer (sgd_momentum)": 0.0,
             "throttle (wot_throttle)": 0.0}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        if e.name in ("aten::mm", "aten::addmm"):
            split["projections (aten::mm)"] += e.self_device_time_total / 1e3
        elif e.name == "aten::bmm":
            split["attention matmuls (aten::bmm)"] += \
                e.self_device_time_total / 1e3
        elif e.name in ranges:
            key = next(k for k in split if e.name in k)
            split[key] += e.device_time_total / 1e3
    split["the rest (attention softmax, fake-quant, embedding, loss, glue)"] \
        = busy - sum(split.values())
    log("train-step profile split (device ms of "
        f"{busy:.2f} busy): " + ", ".join(f"{k} {v:.2f}"
                                          for k, v in split.items()))


# ---------------------------------------------------------------------------
# phase 8: guarded int8 serving — calibration, static / dynamic int8 with
# ABFT and clamps, the CLI's guarded float path, an int8 prefill
# ---------------------------------------------------------------------------


PROJ_PATHS = tuple(f"layers/attn/{n}" for n in ("wq", "wk", "wv", "wo")) + \
    tuple(f"layers/mlp/{n}" for n in ("w_gate", "w_up", "w_down")) + ("head",)


def phase_guarded(torch, dev, build):
    """Full-width deepseek-7b (30 layers), random weights from seed 0, batch
    4, 16 greedy steps under ``in-place-fused`` on the kernel route:

    1. static activation scales from 4 x 256 seeded tokens through the
       cache-less prefill (flash kernel, float ``ecc_qmatmul``): a finite,
       positive scale for every projection and the head;
    2. static int8 serving (``with_act_quant("static", scales,
       clamp=True).with_abft(True)``, ``act_quant="plan"``): no ABFT
       mismatch; then the same with correctable weight faults at 1e-6:
       logits and tokens bit-equal, each flipped block counted once per
       step, still no mismatch;
    3. dynamic int8 serving with ABFT: no mismatch;
    4. the CLI path, ``serve(abft=True, act_clamp=True)`` with float
       activations: no mismatch;
    5. a static int8 prefill of 4 x 512 tokens under ``in-place-chunked``
       (the requantize path at M = 2,048 in 64 row chunks), then 4 decode
       steps;
    6. the kernel and plain routes of paths 2 and 3 on a 2-layer full-width
       model, from the same scales (``route_check``);
    7. ms/step and tok/s of paths 2-4 beside phase 4's unguarded float
       decode, and a profile of 4 static int8 decode steps.
    -> launch counts over 1-5."""
    from repro_torch.configs import get
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm
    from repro_torch.protection import policy as policy_mod
    from repro_torch.serving import protected

    cfg = get("deepseek-7b")
    tokens, batch, rate = 16, 4, 1e-6
    torch.cuda.empty_cache()
    plan = policy_mod.ProtectionPolicy(backend="cuda").plan(
        lm.param_shapes(cfg))
    enc = lm.init_params(cfg, 0, device=dev, leaf_fn=plan.encode_leaf)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    cal = torch.randint(0, cfg.vocab, (4, 256), generator=gen, device=dev)
    build.reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    scales = protected.calibrate_act_scales(cfg, enc, cal, plan=plan,
                                            backend="cuda")
    cal_s = time.time() - t0
    cal_counts = dict(build.COUNTS)
    if sorted(scales) != sorted(PROJ_PATHS) or not all(
            math.isfinite(x) and x > 0 for x in scales.values()):
        fail(f"calibration: scales {scales} (want a finite positive scale "
             f"for each of {PROJ_PATHS})")
    if cal_counts["flash_attention"] != cfg.n_layers or \
            cal_counts["ecc_qmatmul"] != 7 * cfg.n_layers + 1:
        fail(f"calibration did not run the flash and ecc_qmatmul kernels "
             f"once per layer and projection: {cal_counts}")
    log(f"calibrated {len(scales)} static activation scales from 4 x 256 "
        f"tokens in {cal_s:.2f} s: " + ", ".join(
            f"{p} {x:.4g}" for p, x in scales.items()))

    kw = dict(backend="cuda", kv_policy="in-place-fused", batch=batch,
              tokens=tokens, device="cuda", weights=enc, log=log)
    static = dict(act_quant="static", scales=scales, act_clamp=True,
                  abft=True)
    runs, counts = {}, {}
    for name, extra in (("static", static),
                        ("static correctable-only",
                         dict(static, fault_rate=rate,
                              correctable_only=True)),
                        ("dynamic", dict(act_quant="dynamic", abft=True)),
                        ("float --abft --act-clamp",
                         dict(abft=True, act_clamp=True))):
        torch.cuda.empty_cache()
        build.reset_counts()
        runs[name] = serve(cfg, **extra, **kw)
        counts[name] = dict(build.COUNTS)
    torch.cuda.empty_cache()
    build.reset_counts()
    runs["static prefill"] = serve(
        cfg, **static, **dict(kw, kv_policy="in-place-chunked", tokens=4,
                              prompt_len=512))
    counts["static prefill"] = dict(build.COUNTS)

    for name, r in runs.items():
        lg = r["logits"]
        if lg.shape[1:] != (batch, cfg.vocab_padded) or \
                not bool(torch.isfinite(lg.float()).all()):
            fail(f"{name}: logits {tuple(lg.shape)} or non-finite values")
        if r["abft"]["mismatches"]:
            fail(f"{name}: {r['abft']['mismatches']} ABFT mismatches on a "
                 f"clean compute (false positives)")
        if "correctable" not in name and r["flags"] != {
                "corrected": 0, "due": 0, "kv_corrected": 0, "kv_due": 0}:
            fail(f"{name}: a clean run reported faults: {r['flags']}")
        log(f"guarded {name}: ABFT {r['abft']} over the run, launches "
            f"{counts[name]}")
    pre = runs["static prefill"]
    if not bool(torch.isfinite(pre["prefill_logits"].float()).all()):
        fail("static int8 prefill: non-finite logits")
    fixed, clean = runs["static correctable-only"], runs["static"]
    n_single = 0
    for name, pos in fixed["weight_positions"].items():
        _, c = torch.unique(pos // 64, return_counts=True)
        if c.numel() and int(c.max()) > 1:
            fail(f"{name}: a weight block took more than one flip")
        n_single += int(c.numel())
    ff = fixed["flags"]
    if n_single == 0 or ff["corrected"] != tokens * n_single or ff["due"] \
            or ff["kv_due"]:
        fail(f"static int8 correctable-only accounting {ff} != {tokens} x "
             f"{n_single} corrected blocks and no DUE")
    if not (torch.equal(fixed["logits"], clean["logits"])
            and torch.equal(fixed["tokens"], clean["tokens"])):
        fail("static int8: every flip was correctable, yet the logits "
             "differ from the clean run")
    log(f"static int8 correctable-only run: {n_single} single-flip blocks, "
        f"{ff}; logits and tokens bit-equal to the clean run")
    torch.cuda.empty_cache()
    route_check(torch, dev, cal)

    with open(OUT_DIR / "chip_smoke_serve.json") as fh:
        base = json.load(fh)["clean"]
    base_ms = statistics.median(base["step_ms"])
    log(f"unguarded float decode (phase 4, clean): {base_ms:.2f} ms/step, "
        f"{base['tok_per_s']:.1f} tok/s")
    summary = {"calibration_s": cal_s, "scales": scales,
               "float_unguarded_ms": base_ms}
    for name, r in runs.items():
        med = statistics.median(r["step_ms"])
        log(f"guarded {name}: {med:.2f} ms/step median, "
            f"{r['tok_per_s']:.1f} tok/s, clamp hits "
            f"{r['abft']['clamp_hits']} over {len(r['step_ms'])} steps"
            + (f"; prefill {batch} x 512 in {r['prefill_s']:.3f} s "
               f"({r['prefill_tok_per_s']:.1f} tok/s)"
               if "prefill_s" in r else ""))
        summary[name] = {"step_ms": r["step_ms"], "median_ms": med,
                         "tok_per_s": r["tok_per_s"], "abft": r["abft"],
                         "flags": r["flags"], "launches": counts[name],
                         **({"prefill_s": r["prefill_s"]}
                            if "prefill_s" in r else {})}
    with open(OUT_DIR / "chip_smoke_guarded.json", "w") as fh:
        json.dump(summary, fh, indent=1)
    profile_int8_decode(torch, dev, plan, enc, scales)
    del enc
    total = {k: cal_counts[k] + sum(c[k] for c in counts.values())
             for k in build.COUNTS}
    log(f"launch counts over the guarded int8 path: {total}")
    return total


# ---------------------------------------------------------------------------
# phase 9: burst serving through the request front-end, full width
# ---------------------------------------------------------------------------


def _burst_metrics(r) -> dict:
    """The end-to-end numbers of one burst, from its telemetry."""
    summ = r["summary"]
    steps = [e["step_ms"] for e in r["events"] if e["event"] == "step"]
    return {"finished": summ["requests"]["finished"],
            "submitted": summ["requests"]["submitted"],
            "steps": summ["steps"], "gen_tokens": summ["gen_tokens"],
            # end to end: generated tokens over the burst's wall time
            # (admission, finishes, telemetry and injection included);
            # the roll-up's rate sums only the steps' own windows
            "tok_per_s": summ["gen_tokens"] / r["seconds"],
            "step_tok_per_s": summ["throughput"]["tokens_per_s"],
            "ttft_s": summ["ttft_s"], "ttft_steps": summ["ttft_steps"],
            "tpot_ms": summ["per_token_ms"],
            "step_ms_median": statistics.median(steps),
            "seconds": r["seconds"], "pool": summ["pool"],
            "kv_corrected": summ["due"]["corrected_total"],
            "kv_due": summ["due"]["total"], "sharing": summ["sharing"]}


def _check_attribution(name, r, rows):
    """Per-slot rows against the telemetry: the rows of active slots sum to
    the finish events' per-request counts, all rows to the step events'
    totals; no DUE, some corrected bytes."""
    ev = r["events"]
    fin = [e for e in ev if e["event"] == "finish"]
    steps = [e for e in ev if e["event"] == "step"]
    act = [0, 0]
    every = [0, 0]
    for kv, active in rows:
        slot_rows = kv.sum(0)                          # (2, B)
        for i in range(2):
            every[i] += int(slot_rows[i].sum())
            act[i] += sum(int(slot_rows[i, j]) for j in active)
    per_req = [sum(e["kv_corrected"] for e in fin),
               sum(e["kv_due"] for e in fin)]
    per_step = [sum(e["kv_corrected"] for e in steps),
                sum(e["kv_due"] for e in steps)]
    if act != per_req or every != per_step or len(rows) != len(steps):
        fail(f"{name}: per-slot rows of active slots {act} vs per-request "
             f"{per_req}; all rows {every} vs step totals {per_step}")
    if per_req[1] or per_step[1] or per_req[0] == 0:
        fail(f"{name}: parity-zero must count corrected bytes and no DUE: "
             f"{per_req}")
    log(f"{name}: per-slot rows of active slots sum to the per-request "
        f"counts {per_req}; all rows to the step totals {per_step}")


class _step_profiler:
    """``before_step`` / ``after_step`` hooks that run ``torch.profiler``
    over ``steps`` front-end steps from step ``first`` (host work of the
    front-end included) and report the device-busy share and top ops."""

    def __init__(self, torch, first: int, steps: int):
        from torch.profiler import ProfilerActivity, profile
        self.torch, self.first, self.last = torch, first, first + steps
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.t0 = self.wall_ms = None

    def before(self, fe):
        if fe.step_no == self.first:
            self.torch.cuda.synchronize()
            self.prof.start()
            self.t0 = time.time()

    def after(self, fe):
        if fe.step_no == self.last:        # step ``last - 1`` just ran
            self.torch.cuda.synchronize()
            self.wall_ms = 1e3 * (time.time() - self.t0)
            self.prof.stop()

    def report(self):
        if self.wall_ms is None:
            fail("the burst ended before its profiled window")
        _profile_table(self.torch, self.prof, self.wall_ms,
                       f"{self.last - self.first} full-width burst steps "
                       f"(in-place-fused, {BURST_SLOTS} slots)",
                       "chip_smoke_burst_profile.txt")


def phase_burst(torch, dev, build):
    """Full-width deepseek-7b (30 layers, bf16) through
    ``repro_torch.launch.serve.burst``: two waves of twelve requests on
    BURST_SLOTS slots of BURST_MAX_LEN tokens.

    a. ``in-place-fused``, clean, twice: equal deterministic views;
    b. ``parity-zero-fused``, weight flips once and live KV flips every
       4 steps: per-slot KV attribution exact, DUE 0, corrected > 0;
    c. ``parity-zero-chunked``, the same;
    d. ``in-place-chunked`` over a 32-token shared prefix (two full pages;
       suffixes of 0-16 tokens, so a prompt may end on the shared boundary
       and copy on write) with prefix sharing: a cow event, the pool's
       free count back at its start once the prefix cache is dropped, the
       tokens of the same burst without sharing;
    e. ``in-place-fused`` with weight and KV flips of one bit per code
       block: the tokens of (a)."""
    from repro_torch.configs import get
    from repro_torch.launch.serve import burst
    from repro_torch.models import lm
    from repro_torch.protection import policy as policy_mod
    from repro_torch.serving import frontend, telemetry

    cfg = get("deepseek-7b")
    waves = frontend.make_waves(seed=0, n_waves=2, wave_size=12,
                                prompt_len=(8, 48), max_new=(4, 16),
                                gap_steps=16, vocab=cfg.vocab)
    shared = frontend.make_waves(seed=0, n_waves=2, wave_size=12,
                                 prompt_len=(0, 16), max_new=(4, 16),
                                 gap_steps=16, shared_prefix_len=32,
                                 vocab=cfg.vocab)
    plan = policy_mod.ProtectionPolicy(backend="cuda").plan(
        lm.param_shapes(cfg))
    t0 = time.time()
    enc = lm.init_params(cfg, 0, device=dev, leaf_fn=plan.encode_leaf)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    log(f"burst phase: drew and encoded full-width weights in "
        f"{time.time() - t0:.1f}s")
    kw = dict(slots=BURST_SLOTS, max_len=BURST_MAX_LEN, backend="cuda",
              device=dev, weights=enc, log=log)
    rate = 1e-6
    runs, rows = {}, {}
    build.reset_counts()
    runs["a"] = burst(cfg, waves=waves, kv_policy="in-place-fused", **kw)
    # the replay also profiles eight steps in the middle of the burst
    profiled = _step_profiler(torch, first=40, steps=8)
    runs["a2"] = burst(cfg, waves=waves, kv_policy="in-place-fused",
                       before_step=profiled.before, after_step=profiled.after,
                       **kw)
    for name, kvp in (("b", "parity-zero-fused"),
                      ("c", "parity-zero-chunked")):
        rows[name] = []
        runs[name] = burst(cfg, waves=waves, kv_policy=kvp,
                           fault_rate=rate, seed=3,
                           after_step=_row_recorder(rows[name]), **kw)
        del runs[name]["weights"]      # the injected copy: free it now
    fes = set()      # the sharing run's front-end, for its allocator
    runs["d"] = burst(cfg, waves=shared, kv_policy="in-place-chunked",
                      prefix_sharing=True, after_step=fes.add, **kw)
    runs["d0"] = burst(cfg, waves=shared, kv_policy="in-place-chunked", **kw)
    runs["e"] = burst(cfg, waves=waves, kv_policy="in-place-fused",
                      fault_rate=rate, correctable_only=True, seed=5, **kw)
    del runs["e"]["weights"]
    counts = dict(build.COUNTS)
    log(f"launch counts over the burst runs: {counts}")

    a = runs["a"]
    if a["summary"]["requests"]["finished"] != len(waves) or \
            a["summary"]["due"]["corrected_total"] or \
            a["summary"]["pool"]["leaked_pages"]:
        fail(f"clean burst: {a['summary']['requests']}, "
             f"{a['summary']['due']}, {a['summary']['pool']}")
    if telemetry.deterministic_view(a["events"]) != \
            telemetry.deterministic_view(runs["a2"]["events"]) or \
            a["results"] != runs["a2"]["results"]:
        fail("two clean bursts of the same seed differ in their "
             "deterministic views")
    log("clean burst replayed: deterministic views and tokens equal")
    for name in ("b", "c"):
        _check_attribution(f"burst {name}", runs[name], rows[name])
    d, d0 = runs["d"], runs["d0"]
    cows = [e for e in d["events"] if e["event"] == "cow"]
    (fe,) = fes
    start = d["summary"]["pool"]["initial_free"]
    dropped = fe.drop_prefix_cache()
    if not cows or fe.allocator.free_count != start or \
            fe.allocator.live_count != 0:
        fail(f"prefix-sharing burst: {len(cows)} cow events, free pages "
             f"{fe.allocator.free_count} after dropping {dropped} cached "
             f"(start {start})")
    if d["results"] != d0["results"] or \
            d["summary"]["sharing"]["pages_shared"] == 0:
        fail("prefix sharing changed the tokens (or shared nothing)")
    log(f"prefix-sharing burst: {len(cows)} cow events, "
        f"{d['summary']['sharing']['pages_shared']} pages shared, "
        f"{d['summary']['steps']} steps against {d0['summary']['steps']} "
        f"without sharing, tokens equal; pool back to {start} free pages")
    e = runs["e"]["summary"]["due"]
    w = [sum(ev[k] for ev in runs["e"]["events"] if ev["event"] == "step")
         for k in ("w_corrected", "w_due")]
    if runs["e"]["results"] != a["results"] or e["total"] or \
            e["corrected_total"] == 0 or w[1] or w[0] == 0:
        fail(f"correctable-only burst: KV {e}, weights corrected/DUE {w}, "
             f"tokens equal to the clean burst: "
             f"{runs['e']['results'] == a['results']}")
    log(f"correctable-only burst: {e['corrected_total']} corrected KV "
        f"blocks and {w[0]} corrected weight blocks over the steps, no DUE, "
        f"tokens equal to the clean burst")
    profiled.report()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    metrics = {}
    for name, r in runs.items():
        m = metrics[name] = _burst_metrics(r)
        log(f"burst {name} ({smi}): {m['finished']}/{m['submitted']} "
            f"requests in {m['steps']} steps, {m['gen_tokens']} tokens, "
            f"{m['tok_per_s']:.2f} tok/s over {m['seconds']:.2f} s of wall "
            f"({m['step_tok_per_s']:.2f} over the steps' windows), TTFT "
            f"p50/p99 "
            f"{m['ttft_s']['p50']:.3f}/{m['ttft_s']['p99']:.3f} s, TPOT "
            f"p50/p99 {m['tpot_ms']['p50']:.2f}/{m['tpot_ms']['p99']:.2f} "
            f"ms, median {m['step_ms_median']:.2f} ms/step, pool "
            f"{m['pool']['initial_free']} free at start, peak "
            f"{m['pool']['peak_pages_in_use']} in use, "
            f"{m['pool']['leaked_pages']} leaked")
    with open(OUT_DIR / "chip_smoke_burst.json", "w") as fh:
        json.dump({"card": smi, "runs": metrics}, fh, indent=1)
    del enc, runs, fes
    torch.cuda.empty_cache()
    return counts


def route_check(torch, dev, cal):
    """Static int8 with clamps and ABFT, and dynamic int8 with ABFT, on a
    2-layer full-width model with injected single and double flips, served
    3 steps on the kernel route (``in-place-fused`` KV) and on the plain
    route (``in-place`` KV) from the same scales: greedy tokens, flags and
    ABFT rows equal, logits bit-equal."""
    from repro_torch.configs import get
    from repro_torch.models import lm
    from repro_torch.protection import policy as policy_mod
    from repro_torch.serving import kvcache, protected

    cfg = get("deepseek-7b").with_(n_layers=2)
    plans = {r: policy_mod.ProtectionPolicy(backend=r).plan(
        lm.param_shapes(cfg)) for r in ("cuda", "torch")}
    enc = lm.init_params(cfg, 7, device=dev, leaf_fn=plans["cuda"].encode_leaf)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    enc, _ = policy_mod.inject_tree_device(enc, 1e-5, gen)
    scales = protected.calibrate_act_scales(cfg, enc, cal, plan=plans["cuda"],
                                            backend="cuda")
    for mode in ("static", "dynamic"):
        results = {}
        for route, kvp in (("cuda", "in-place-fused"), ("torch", "in-place")):
            if mode == "static":
                plan = plans[route].with_act_quant(
                    "static", scales, clamp=True).with_abft(True)
                aq = "plan"
            else:
                plan, aq = plans[route].with_abft(True), "dynamic"
            step = protected.make_serve_step(cfg, plan=plan, backend=route,
                                             kv_policy=kvp, act_quant=aq)
            cache = kvcache.init_cache(cfg, 4, 64, kv_policy=kvp, device=dev)
            tok = torch.zeros((4, 1), dtype=torch.long, device=dev)
            logits, flags, toks = [], [], []
            for t in range(3):
                pos = torch.full((4,), t, dtype=torch.int32, device=dev)
                lg, cache, fl = step(enc, cache, tok, pos)
                tok = lg.argmax(dim=-1)
                logits.append(lg)
                toks.append(tok)
                flags.append({k: v.tolist() for k, v in fl.items()})
            results[route] = (torch.stack(logits), torch.stack(toks), flags)
        (lk, tk, fk), (lp, tp, fp) = results["cuda"], results["torch"]
        if fk != fp:
            fail(f"{mode} int8, 2 layers: routes disagree on flags: cuda {fk}"
                 f" vs torch {fp}")
        if not torch.equal(tk, tp):
            fail(f"{mode} int8, 2 layers: routes disagree on greedy tokens")
        d = (lk.float() - lp.float()).abs()
        if not torch.equal(_bits(torch, lk), _bits(torch, lp)):
            fail(f"{mode} int8, 2 layers: kernel-route logits not bit-equal "
                 f"to the plain route's ({int((lk != lp).sum())} differ, max "
                 f"abs {float(d.max()):.4g})")
        log(f"{mode} int8, 2 layers full width: kernel and plain routes give "
            f"bit-equal logits, equal tokens and flags (layers "
            f"{fk[0]['layers']}, ABFT rows {fk[0]['layers_abft']}, top ABFT "
            f"{fk[0]['top_abft']})")
    del enc


def profile_int8_decode(torch, dev, plan, enc, scales):
    """4 static int8 decode steps (clamps and ABFT, ``in-place-fused``) of
    the full-width model under ``torch.profiler``: device time split into
    the fused matmul (``qmatmul_kernel``), its ABFT compare
    (``abft_compare_kernel``), activation quantization (the ``act_quant``
    range) and the rest."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get
    from repro_torch.serving import kvcache, protected

    cfg, batch = get("deepseek-7b"), 4
    torch.cuda.empty_cache()
    plan = plan.with_act_quant("static", scales, clamp=True).with_abft(True)
    step = protected.make_serve_step(cfg, plan=plan, backend="cuda",
                                     kv_policy="in-place-fused",
                                     act_quant="plan")
    cache = kvcache.init_cache(cfg, batch, 64, kv_policy="in-place-fused",
                               device=dev)
    tok = torch.zeros((batch, 1), dtype=torch.long, device=dev)
    step(enc, cache, tok, torch.zeros((batch,), dtype=torch.int32,
                                      device=dev))  # warm
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.time()
        for t in range(1, 5):
            pos = torch.full((batch,), t, dtype=torch.int32, device=dev)
            logits, cache, _ = step(enc, cache, tok, pos)
            tok = logits.argmax(dim=-1)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0)
    kernels = _profile_table(torch, prof, wall_ms,
                             "4 full-width static int8 decode steps",
                             "chip_smoke_int8_profile.txt",
                             ranges=("act_quant",))
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    split = {"fused matmul (qmatmul_kernel)": 0.0,
             "ABFT compare (abft_compare_kernel)": 0.0,
             "activation quantization (act_quant)": 0.0}
    for e in kernels:
        for key in list(split)[:2]:
            if key.split("(")[-1].rstrip(")") in e.key:
                split[key] += e.self_device_time_total / 1e3
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and \
                e.name == "act_quant":
            split["activation quantization (act_quant)"] += \
                e.device_time_total / 1e3
    split["the rest (attention, KV codec, norms, embedding, glue)"] = \
        busy - sum(split.values())
    log(f"int8 decode profile split (device ms over 4 steps, {busy:.2f} "
        f"busy of {wall_ms:.2f} wall): " + ", ".join(
            f"{k} {v:.2f}" for k, v in split.items()))
    del cache


if __name__ == "__main__":
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    main()
