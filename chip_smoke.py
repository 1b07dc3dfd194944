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
  the throttle through the ``quantize_throttle`` kernel, which writes the
  moved masters back in place); the last update runs unthrottled and its
  masters are throttled on both routes (masters, q and scales bit-equal,
  the WOT constraint on every leaf); the trained
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
  pool on 8 slots, two waves of twelve requests; full-width deepseek-7b
  cut to 15 layers): clean twice (equal
  deterministic telemetry), ``parity-zero-fused`` and
  ``parity-zero-chunked`` with live KV flips (per-slot flags attributed
  exactly, no DUE), ``in-place-chunked`` with prefix sharing and
  copy-on-write (tokens of the run without sharing, the pool back at its
  start), and ``in-place-fused`` with correctable KV flips only (tokens of
  the clean run); with TTFT, TPOT, tok/s and a profile of eight steps;
* phase 10: full-width, full-depth phi3-medium-14b (40 layers, d_model
  5,120, GQA 40/10, 14.7 GB of encoded weights), the decode runs of the
  first bullet (clean, faulted, correctable-only), with its launches per
  step;
* phase 11: full-width, full-depth paligemma-3b (the vlm family: 18
  layers, 8 query heads over one KV head of 256, a tied 257,216-word
  head): the same decode runs; the long-context runs (a 4 x 2,048 prefill
  through flash at head_dim 256, 16 steps through the chunked kernel at
  rep 8); two QATT steps at batch 2 x (256 patch embeddings + 512 tokens)
  through ``launch.train.train`` (finite losses, the throttle bit-equal
  across routes, the WOT constraint on every leaf); and a profile of its
  decode step (the embedding's decode and the tied head beside the rest);
* phase 12: full-width, full-depth whisper-base (the encdec family: 6
  encoder and 6 decoder layers, d_model 512, 8 heads of 64, layer norms,
  cross-attention, a 51,968-word head) on its dense KV cache: the decode
  triple of the first bullet at batch 4 (the accounting counts only the
  leaves a decode step reads: not the encoder's images, nor the decoder's
  cross ``wk`` and ``wv``); 16 steps over cross caches filled from the
  encoder on 4 x 1,500 seeded frames, kernel route against plain route in
  lockstep; the cache-less decode-at-use forward over 8 x 1,500 frames and
  8 x 448 tokens (the encoder's images decode at use; flash at head_dim
  64), on both routes, and with correctable flips (bit-equal, every
  flipped block counted once in its row); three QATT steps at batch 8 x
  (1,500 frames + 448 tokens) in 4 microbatches (finite losses, the
  throttle bit-equal across routes, the WOT constraint on every leaf),
  deployed on both routes (byte-equal) and served 8 steps clean and
  correctable-only (bit-equal); and a profile of 4 decode steps;
* phase 13: full-width, full-depth recurrentgemma-2b (the hybrid family:
  8 super-blocks of two RG-LRU layers and one local-attention layer over
  a 2,048-token window, 2 tail RG-LRU layers, d_model 2,560, 10 query
  heads over one KV head of 256, a tied 256,000-word head) on its dense
  cache (RG-LRU states, a ring of 2,048 K/V slots): the decode triple of
  the first bullet at batch 4 (every leaf is read by a step: the tail,
  the conv kernels and both gates of every RG-LRU layer); 16 steps at
  positions 2,040..2,055 across the ring wrap over a seeded cache, kernel
  route against plain route in lockstep; the cache-less decode-at-use
  forward over 2 x 4,096 tokens (flash with the 2,048-token sliding
  window) and 2 x 2,048 (the window dropped), on both routes and with
  correctable flips (bit-equal, every flipped block counted once in its
  row: top, layers, tail); and a profile of 4 decode steps split into
  the projections, the gate and conv decodes, the RG-LRU glue and the
  local attention;
* phase 14: full-width, full-depth mamba2-2.7b (the ssm family: 64
  layers of one Mamba2 mixer, d_model 2,560, 80 SSD heads of 64 with a
  state of 128, an untied 50,304-word head) on its state cache (each
  layer's recurrent state and conv history, no KV cache): the decode
  triple of the first bullet at batch 4 (exactly 65 ``ecc_decode`` and
  129 ``ecc_qmatmul`` launches a clean step); 8 steps from a seeded
  state cache, kernel route against plain route in lockstep and both
  against an f32 plain decode; the cache-less decode-at-use forward over
  2 x 4,096 tokens (the SSD chunked scan over 32 chunks of 128) on both
  routes against an f32 forward, and with correctable flips (bit-equal,
  every flipped block counted once in its row); the chunked scan against
  the recurrence in f32 on the kernel route at 16 layers (the forward
  over 2 x 256 tokens against 256 decode steps); and a profile of 4 decode steps split
  into the projections, the embedding's and the ``conv_w`` decodes, the
  embedding's dequantization and the Mamba2 glue;
* phase 15: deepseek-v2-236b (the moe family: MLA over a compressed
  latent cache of 512 + 64 per token, 128 heads of 128 nope + 64 rope
  dims, 160 routed experts of 1,536 with top-6 routing and 2 shared
  experts, d_model 5,120, a 102,400-word head) at full width, cut to 4
  layers (17.26 GB of image): the decode triple of the first bullet at
  batch 4 (every expert leaf and the router decode whole each step;
  exactly 17 ``ecc_decode`` and 33 ``ecc_qmatmul`` launches a clean
  step); a profile of 4 decode steps split into the projections, the
  embedding's, the routers' and the expert leaves' decodes and
  dequantizations, the MLA glue and the routed experts' products; then
  cut to 2 layers, 16 decode steps at batch 8 on the kernel and plain
  routes in bf16 and the plain route in f32 in lockstep, and the
  cache-less forward over 2 x 4,096 tokens (flash at the 192/128 head
  split) on the same three routes: the shares of (token, layer) pairs
  routed to another expert set on each pair of routes, the kernel route
  no more often than the bf16 plain route, the logits held on the rows no
  routing difference reaches, the pairs dropped at capacity; and the f32
  forward against 8 f32 decode steps over 4 x 8 tokens (no drops
  possible);
* phase 16: deepseek-v3-671b (MLA with the low-rank query pair, 256
  routed experts of 2,048 with top-8 and one shared expert, d_model
  7,168, a 129,280-word head) at full width, cut to 1 layer (13.36 GB of
  image; each expert leaf 3.76 GB, past 2^31 bytes): the decode triple,
  a profile of its decode step, and the cache-less forward over 2 x
  4,096 tokens through flash;
* phase 17: the paper's Table 2 at full width (every published conv and
  fc width, the synthetic task's 4-class head): ResNet18 pretrained with
  Adam, WOT-fine-tuned through the ``quantize_throttle`` kernel until no
  protected position holds a large value, then the four schemes'
  (trial x rate) campaigns on the kernel and the plain route (equal
  grids, cell for cell), at the reference experiment's 32 x 32 input and
  at 224; the in-place DUE, corrected and fidelity grids against every
  cell's recomputed flips; the ABFT compute campaigns; VGG16 and
  SqueezeNet from a seed (in-place and faulty campaigns; SqueezeNet's
  batched layout against the one-cell one); each campaign cell's inject,
  decode and forward times;
* phase 18: the serve CLI's fault smoke-check (decode fidelity and DUE
  campaigns at 1e-5, 1e-4, 1e-3 x 2 trials) over full-width deepseek-7b's
  encoded tree, every cell held to its recomputed flips, then a faulted
  serve over the same tree;
* phase 19: the rest of training. QATT of full-width, full-depth
  recurrentgemma-2b (2 steps of 8 x 2,048 tokens, the last throttle and
  the deploy bit-equal across routes, 8 served steps clean and
  correctable-only on its dense cache) and mamba2-2.7b cut to 16 layers
  (2 steps, then one f32 step on both routes from the same state:
  bit-equal under deterministic algorithms), each with a profile of a step; the f32
  gradient of a 2-layer full-width mamba2 with remat'ed blocks bit-equal
  to one without remat (where a write into a saved tensor raises); on
  that 2-layer model, a crash after step 3 of 6 with async checkpoints
  every 2 steps and a resume bit-equal to the uninterrupted run, and the
  train entry point's protected checkpoint (restored as scale x the
  throttled int8, exactly; 1,024 single flips per stored image
  corrected; save and restore seconds and bytes against an unprotected
  one); ADMM against QATT on full-width ResNet18 at 32 x 32 (QATT and
  ADMM's final clamp meet the WOT constraint, ADMM's residual large
  values reported, the projection bit-equal across routes);
* phase 20: mixed schemes and self-healing on full-width deepseek-7b
  (16 of its 30 layers since PR 27): the ``attn-inplace-mlp-secded`` plan served on both routes
  in lockstep (flags equal) beside all-in-place on the kernel route, a
  profile of each; then, from all-in-place, a burst through the front-end
  with a scrub pass every step and a MILR repair kit (its build time and
  host peak logged), single flips injected into the in-place weight
  leaves and into live pages no slot writes, one DUE block into
  ``layers/attn/wo``, a DUE pattern into a free page, and a live
  migration to ``attn-inplace-mlp-secded`` from step 30 (the middle): the
  DUE leaf repaired, no page leaked, no residual DUE, the free page zero
  again, and the healed
  tree decoding to the int8 of a clean encode under the final plan,
  whose logits it serves bit for bit; scrub ms per leaf and per page and
  a profile of each scrub pass, repair seconds, steps to migrate;
* phase 21: distribution. A world-1 NCCL process group (a FileStore, no
  network) and the (1, 1) ('data', 'model') mesh; the sharded decode cell
  (``launch.specs.decode_cell``) of full-width deepseek-7b at 8 layers on
  DTensors (in-place plan, in-place fused paged KV with per-slot rows,
  batch 4, weight flips) for 8 steps in lockstep with the unsharded
  serve step: logits, flags, per-slot rows, page tables and pools bit for
  bit, ms/step of both, ``ecc_qmatmul``, the paged kernel and
  ``kv_write`` counted on the sharded steps; the sharded train cell at 2
  layers (8 x 2,048, 2 steps) against ``make_train_step``: loss and every
  master bit for bit, ``quantize_throttle`` counted (its two passes, an
  all-reduce MAX between them); ``compressed_psum`` of a 64 M-value
  gradient against the local ``compress`` (payload and residual equal),
  timed beside a plain f32 all-reduce; a protected 2-layer checkpoint
  restored with ``shardings=`` bit-equal to ``restore(device="cuda")``.

Phase 4 also runs the whole-tree decode ablations over its resident
tree (decode at use, ``decode_at_use=False``, ``decode_per_step=False``;
ms/step and peak memory each, the whole-tree modes bit-equal, decode at
use within ABLATION_*_ATOL of them), and phases 13-15 serve their
full-width models guarded (static int8 with clamps and ABFT, flips
injected) on both routes in lockstep: flags, ABFT and clamp rows equal
(``guarded_routes``). Both are counted apart from their phase's path,
each with its own row in the per-path launch check.

Phase 2 also holds the parity-zero decode and the per-slot flags of both
paged-attention kernels to their plain versions at the burst's shapes;
both kernels through their page-table entries (the pool read through a
shuffled table with a shared page and a parking page, as the decode step
calls them) at the decode, long-context and burst shapes and at
minitron-4b widths (rep 3) and paligemma-3b's (rep 8, hd 256: S 64, S
272 under all three schemes, S 2,064), against ``gather_strips`` + the
plain version, with the time the gather alone would take; the chunked
kernel at paligemma-3b's decode shape against the fp64 oracle too;
flash attention at head_dim 256 (paligemma-3b's prefill: B 4, H 8, S
2,048, and a ragged S) in bf16 (tensor cores) and f32 (CUDA cores), with
its TFLOP/s beside SDPA's; and the float ``ecc_qmatmul`` at every weight
shape for the decode step (M = 4), the burst step (M = 8) and the 4 x
2,048 prefill (M = 8,192), and at every weight shape of a phi3-medium-14b
and a paligemma-3b decode step (M = 4), and at whisper-base's (K 512 ->
N 512, 2,048 and 51,968; K 2,048 -> N 512) and recurrentgemma-2b's (K
2,560 -> N 2,560, 7,680 and 256; K 7,680 -> N 2,560) and mamba2-2.7b's
(K 2,560 -> N 10,576, whose last N tile is ragged, and 50,304; K 5,120 ->
N 2,560), flags exact and a split-K launch repeated bit for bit, and once
in the prefill regime at mamba2-2.7b's w_in over 2 x 4,096 tokens (M
8,192, the ragged last N tile); ``ecc_decode`` at one routed-expert leaf
of deepseek-v2-236b (1.26 G values) and of deepseek-v3-671b (3.76 G
values, 3.76 GB of image); flash at MLA's head split (q and k of 192, v
of 128) over B 2, H 128, S 4,096 in bf16 and a ragged S in bf16 and f32,
timed beside SDPA; flash attention at whisper-base's decoder
shape (B 8, H 8, S 448, head_dim 64, bf16); flash with a sliding window
at recurrentgemma-2b's local attention (B 2, H 10, S 4,096, head_dim
256, window 2,048, bf16), timed beside SDPA with the band as a boolean
mask, and at a ragged S with a window of 300 in bf16 and f32; the fused
KV write
(``kv_write``: one launch per layer quantizes, throttles, encodes and
stores K and V into the pool through the table) byte-equal to its plain
version at the decode, burst, 4 x 2,048 prefill, minitron-4b and
paligemma-3b (one KV head of 256) shapes under all three KV schemes,
timed beside the unfused route of the same
write; and ``quantize_throttle``'s in-place write-back of the QATT
masters bit-equal to its plain version. Phase 3 runs a 2-layer burst on both
routes with the same pool flips. Phase 6 counts the decode step's
launches with ``kv_write`` and on the unfused KV route in the same run.

Launch counts are set to 0 just before each path and read just after.
``throttle`` is exempt from the check that every kernel launched on a
main path (``MAIN_PATH_EXEMPT`` gives the reason); ``kv_write`` must
launch on every serve path.
Every phase raises on failure and the script exits nonzero; it prints no
result without a CUDA device. Its last lines are the kernels JSON (per
kernel: launches on the main paths, max abs error against the plain
version, times and bound) and ``{"ok": true, "device": {...}}``.

Times are CUDA-event medians over repeats with the 50 MB L2 cache flushed
before each repeat and the card kept busy while the host enqueues. Kernel
entries report the work one call of the serve path gives the kernel: one
decode step (ecc_decode, ecc_qmatmul, the two decode attentions,
kv_write), one deploy (ecc_encode: every protected leaf once), one prefill
(flash_attention) or one train step (quantize_throttle's write-back: every
protected leaf of the 8-layer model once): the sum over the launches of
that call. ``bound_ms`` is max(bytes / 3.35 TB/s, ops / peak) with each
input read once and each output written once (H100 SXM data-sheet rates:
HBM 3.35 TB/s, dense bf16 989 TFLOP/s, dense int8 1,979 TOP/s, f32
without tensor cores 67 TFLOP/s).
"""
from __future__ import annotations

import contextlib
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
F32_FLOPS = 67e12     # CUDA cores, no tensor cores

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
# (held to the same at whisper-base's 6 + 6 layers in phase 12, whose
# layer norms renormalize the residual stream every sublayer)
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
# flash at MLA's 192/128 split against SDPA (causal) over the same bf16
# inputs: SDPA rounds its probabilities and sums in its own order, so the
# two differ by a few bf16 ulps; held within 2^-6 of max |SDPA| (read:
# 0.00391, H100 at 700 W), which a wrong tile or scale would break by O(1)
FLASH_SDPA_RTOL = 2.0 ** -6
# recurrentgemma-2b's logits at 26 layers (phase 13: the cache-less
# forward, and the decode across the ring wrap): the routes round each
# bf16 projection at different points and the differences grow with
# depth, so nearly every logit differs; the logits reach |16|..|32|,
# where a bf16 ulp is 0.125. Held to 4 such ulps at most and to 0.03 on
# average (readings on the H100: forward max 0.25, mean 0.0184; ring
# wrap max 0.1406, mean 0.0189), and, sharper, to the f32 plain route
# over the same weights and inputs: the kernel route must be no farther
# from it than the bf16 plain route (mean within F32_ROUTE_RATIO, max
# within 1.5x), which an error in a kernel would break (phase 14 too).
HYBRID_MAX_ATOL, HYBRID_MEAN_ATOL = 0.5, 0.03
F32_ROUTE_RATIO = 1.1
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
# phase 9's bursts: full width, cut to half depth for the card run's time
# limit (each burst step is host-bound, its time ~ proportional to depth)
BURST_LAYERS = 15
# Kernels that no main path launches, each with its reason; phase 2 still
# holds each against its plain version.
MAIN_PATH_EXEMPT = {
    "throttle": "its main-path work, the WOT clamp of the KV write, now runs "
                "inside kv_write through the same device function "
                "(csrc/wot8.cuh); it is held against its plain version in "
                "phase 2"}


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
    decode_counts, ablation_counts = phase_full(
        torch, dev, build, get_config("deepseek-7b"), ablation=True)
    log(f"phase 4 (decode path) took {time.time() - t0:.0f}s")
    t0 = time.time()
    long_counts = phase_long(torch, dev, build, get_config("deepseek-7b"))
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
    t0 = time.time()
    phi3_counts = phase_full(torch, dev, build, get_config("phi3-medium-14b"),
                             "chip_smoke_phi3.json")
    log(f"phase 10 (phi3-medium-14b decode path) took "
        f"{time.time() - t0:.0f}s")
    t0 = time.time()
    vlm_counts = phase_vlm(torch, dev, build)
    log(f"phase 11 (paligemma-3b: decode, long context, QATT) took "
        f"{time.time() - t0:.0f}s")
    t0 = time.time()
    encdec_counts = phase_encdec(torch, dev, build)
    log(f"phase 12 (whisper-base: decode, cross caches, forward, QATT) took "
        f"{time.time() - t0:.0f}s")
    t0 = time.time()
    hybrid_counts, hybrid_guarded, windowed = phase_hybrid(torch, dev, build)
    entries["flash_attention"]["window"]["launches_per_forward"] = windowed
    log(f"phase 13 (recurrentgemma-2b: decode, ring wrap, forward) took "
        f"{time.time() - t0:.0f}s")
    t0 = time.time()
    ssm_counts, ssm_guarded = phase_ssm(torch, dev, build)
    log(f"phase 14 (mamba2-2.7b: decode, state routes, forward, scan vs "
        f"recurrence) took {time.time() - t0:.0f}s")
    t0 = time.time()
    moe_v2_counts, moe_v2_guarded = phase_moe_v2(torch, dev, build)
    log(f"phase 15 (deepseek-v2-236b at {MOE_V2_LAYERS} layers: decode, "
        f"profile; at {MOE_ROUTE_LAYERS}: routes, forward) took "
        f"{time.time() - t0:.0f}s")
    t0 = time.time()
    moe_v3_counts = phase_moe_v3(torch, dev, build)
    log(f"phase 16 (deepseek-v3-671b at {MOE_V3_LAYERS} layer: decode, "
        f"profile, forward) took {time.time() - t0:.0f}s")
    t0 = time.time()
    cnn_counts, cell_rows = phase_cnn(torch, dev, build)
    entries["ecc_decode"]["campaign_cell"] = cell_rows
    log(f"phase 17 (Table 2: resnet18 pipeline, vgg16, squeezenet at full "
        f"width) took {time.time() - t0:.0f}s")
    t0 = time.time()
    smoke_counts = phase_smoke_check(torch, dev, build,
                                     get_config("deepseek-7b"))
    log(f"phase 18 (the serve CLI's fault smoke-check on deepseek-7b) took "
        f"{time.time() - t0:.0f}s")
    t0 = time.time()
    rest_counts = phase_train_rest(torch, dev, build)
    log(f"phase 19 (the rest of training: QATT of recurrentgemma-2b and "
        f"mamba2-2.7b, crash and resume, the protected checkpoint, ADMM vs "
        f"QATT) took {time.time() - t0:.0f}s")
    t0 = time.time()
    heal_counts = phase_heal(torch, dev, build)
    log(f"phase 20 (mixed schemes and self-healing on full-width "
        f"deepseek-7b at {HEAL_LAYERS} layers: scrub, MILR repair, live "
        f"migration) took {time.time() - t0:.0f}s")
    t0 = time.time()
    dist_counts, _ = phase_dist(torch, dev, build)
    log(f"phase 21 (distribution: the sharded decode and train cells on a "
        f"world-1 NCCL mesh, compressed_psum, the elastic restore) took "
        f"{time.time() - t0:.0f}s")
    paths = (decode_counts, ablation_counts, long_counts, train_counts,
             guarded_counts, burst_counts, phi3_counts, vlm_counts,
             encdec_counts, hybrid_counts, hybrid_guarded, ssm_counts,
             ssm_guarded, moe_v2_counts, moe_v2_guarded, moe_v3_counts,
             cnn_counts, smoke_counts, rest_counts, heal_counts, dist_counts)
    counts = {k: sum(c[k] for c in paths) for k in build.COUNTS}
    if sorted(entries) != sorted(counts):
        fail(f"kernels checked {sorted(entries)} != kernels counted "
             f"{sorted(counts)}")
    for path, cnt, needed in (
            ("decode", decode_counts, ("ecc_decode", "ecc_encode",
                                       "ecc_qmatmul", "fused_page_attention",
                                       "kv_write")),
            ("whole-tree decode ablations", ablation_counts,
             ("ecc_decode", "ecc_qmatmul", "fused_page_attention",
              "kv_write")),
            ("long-context", long_counts,
             ("ecc_decode", "ecc_encode", "ecc_qmatmul", "flash_attention",
              "chunked_page_attention", "kv_write")),
            ("training", train_counts,
             ("quantize_throttle", "ecc_encode", "ecc_decode",
              "ecc_qmatmul", "fused_page_attention", "kv_write")),
            ("guarded int8", guarded_counts,
             ("ecc_decode", "ecc_qmatmul", "flash_attention",
              "fused_page_attention", "chunked_page_attention",
              "kv_write")),
            ("burst", burst_counts,
             ("ecc_decode", "ecc_qmatmul", "fused_page_attention",
              "chunked_page_attention", "kv_write")),
            ("phi3-medium-14b decode", phi3_counts,
             ("ecc_decode", "ecc_encode", "ecc_qmatmul",
              "fused_page_attention", "kv_write")),
            ("paligemma-3b", vlm_counts,
             ("ecc_decode", "ecc_encode", "ecc_qmatmul",
              "fused_page_attention", "kv_write", "flash_attention",
              "chunked_page_attention", "quantize_throttle")),
            ("whisper-base", encdec_counts,
             ("ecc_decode", "ecc_encode", "ecc_qmatmul", "flash_attention",
              "quantize_throttle")),
            ("recurrentgemma-2b", hybrid_counts,
             ("ecc_decode", "ecc_encode", "ecc_qmatmul",
              "flash_attention")),
            ("guarded recurrentgemma-2b", hybrid_guarded,
             ("ecc_decode", "ecc_qmatmul", "flash_attention")),
            ("ssm (mamba2-2.7b)", ssm_counts,
             ("ecc_decode", "ecc_encode", "ecc_qmatmul")),
            ("guarded mamba2-2.7b", ssm_guarded,
             ("ecc_decode", "ecc_qmatmul")),
            ("moe (deepseek-v2-236b)", moe_v2_counts,
             ("ecc_decode", "ecc_encode", "ecc_qmatmul", "flash_attention",
              "quantize_throttle")),
            ("guarded deepseek-v2-236b", moe_v2_guarded,
             ("ecc_decode", "ecc_qmatmul", "flash_attention")),
            ("moe (deepseek-v3-671b)", moe_v3_counts,
             ("ecc_decode", "ecc_encode", "ecc_qmatmul", "flash_attention",
              "quantize_throttle")),
            ("CNN Table 2", cnn_counts,
             ("ecc_encode", "ecc_decode", "quantize_throttle")),
            ("fault smoke-check", smoke_counts,
             ("ecc_encode", "ecc_decode")),
            ("the rest of training", rest_counts,
             ("quantize_throttle", "ecc_encode", "ecc_decode",
              "ecc_qmatmul")),
            ("mixed schemes and self-healing", heal_counts,
             ("ecc_decode", "ecc_encode", "ecc_qmatmul", "kv_write",
              "fused_page_attention")),
            ("distribution (the sharded cells)", dist_counts,
             ("ecc_qmatmul", "fused_page_attention", "kv_write",
              "quantize_throttle"))):
        missing = [k for k in needed if cnt[k] <= 0]
        if missing:
            fail(f"kernels never launched on the {path} path: {missing}")
    for name, why in MAIN_PATH_EXEMPT.items():
        log(f"exempt from the main-path launch check: {name} "
            f"({counts[name]} launches on the main paths): {why}")
    missing = [k for k, v in counts.items()
               if v <= 0 and k not in MAIN_PATH_EXEMPT]
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

    def ms(self, fn, setup=None) -> float:
        """Median CUDA-event time of ``fn`` over repeats, L2 flushed. A
        ~1 ms device sleep ahead of the start event keeps the card busy
        while the host enqueues ``fn``, so a small kernel's time is not its
        wrapper's host latency. ``setup`` (untimed) runs before each call:
        it restores what an in-place ``fn`` overwrote."""
        torch = self.torch
        if setup is not None:
            setup()
        fn()
        times = []
        for _ in range(self.REPS):
            if setup is not None:
                setup()
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
    one = torch.zeros(1, device=dev)
    log(f"timer floor: one launch of a one-element fill takes "
        f"{timer.ms(lambda: one.zero_()):.4f} ms (launch latency, the floor "
        f"of every latency-bound row)")

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
    torch.cuda.empty_cache()
    out["ecc_decode"]["expert_leaf"] = check_ecc_decode_expert_leaves(
        torch, dev, timer, gen)

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
    out["ecc_qmatmul"] = check_qmatmul_mixes(torch, dev, cfg, timer, gen)
    models, e = check_qmatmul_models(torch, dev, timer, gen)
    out["ecc_qmatmul"]["max_abs_err"] = max(
        out["ecc_qmatmul"]["max_abs_err"], e)
    out["ecc_qmatmul"]["models_m4"] = models
    ragged = check_qmatmul_ragged_prefill(torch, dev, timer, gen)
    out["ecc_qmatmul"]["max_abs_err"] = max(
        out["ecc_qmatmul"]["max_abs_err"], ragged["err"])
    out["ecc_qmatmul"]["mamba2_prefill_w_in"] = ragged
    moe, e = check_qmatmul_moe_prefill(torch, dev, timer, gen)
    out["ecc_qmatmul"]["max_abs_err"] = max(
        out["ecc_qmatmul"]["max_abs_err"], e)
    out["ecc_qmatmul"]["moe_prefill_m8192"] = moe
    check_qmatmul_paths(torch, dev, cfg, timer, gen)

    # -- kernel 4: fused page attention, 30 launches per step ---------------
    b, h, kvh, hd, s = 4, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 64
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
    # both kernels through the page table at the serve shapes, rep > 1
    for name, r in check_paged_tables(torch, dev, cfg, timer, gen).items():
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"],
                                       r["max_abs_err"])
        out[name]["through_table"] = r["through_table"]
    out["flash_attention"] = check_flash(torch, dev, cfg, timer, gen)
    out["quantize_throttle"] = check_quant_throttle(torch, dev, timer, gen)
    out["throttle"] = check_throttle(torch, dev, timer, gen)
    out["kv_write"] = check_kv_write(torch, dev, timer, gen)
    return out


def _qmm_weight(torch, dev, k, n, gen, scale):
    """A (k, n) in-place image with 50 single- and 20 double-flip blocks
    and its bf16 decode -> (image, bf16 weight, (singles, doubles))."""
    from repro_torch.core import ecc
    w_enc = ecc.encode64(wot_blocks(torch, dev, k * n // 8, gen))
    flips = flip_blocks(torch, w_enc, 50, 20, gen)
    w_enc = w_enc.view(k, n)
    dec = ecc.decode64(w_enc.reshape(k, n // 8, 8))[0].reshape(k, n)
    w_bf = (dec.view(torch.int8).float() * scale).to(torch.bfloat16)
    return w_enc, w_bf, flips


def _qmm_case(torch, dev, m, w_enc, w_bf, scale, flips, timer, gen):
    """The float ecc_qmatmul at (m, k, n) against its plain version: flags
    equal to the injected counts and the plain version's, the output
    within QMM_RTOL, a split-K launch repeated bit for bit; timed beside
    the plain version, ``torch.matmul`` over the decoded bf16 weight and
    the bound. -> dict of the times, the bound, the error and the plan."""
    from repro_torch.kernels import ecc_qmatmul
    k, n = w_enc.shape
    a = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    plan = ecc_qmatmul.plan_launch(m, n, k, a.dtype)
    ko, kfl = ecc_qmatmul.ecc_qmatmul(a, w_enc, scale, with_flags=True)
    po, pfl = ecc_qmatmul.ecc_qmatmul_plain(a, w_enc, scale, with_flags=True)
    if kfl.tolist() != pfl.tolist() or kfl.tolist() != list(flips):
        fail(f"ecc_qmatmul flags {kfl.tolist()} vs plain {pfl.tolist()} vs "
             f"injected {list(flips)} at {(m, k, n)}")
    diff = (ko - po).abs()
    del po
    e = float(diff.max())
    diff -= QMM_RTOL * (a.float().abs() @ w_bf.float().abs())
    if bool((diff > 1e-6).any()):
        fail(f"ecc_qmatmul out of tolerance at {(m, k, n)}: max abs err {e}")
    del diff
    if plan.splits > 1:
        again = ecc_qmatmul.ecc_qmatmul(a, w_enc, scale)
        if not torch.equal(_bits(torch, again), _bits(torch, ko)):
            fail(f"ecc_qmatmul split-K ({plan.splits} splits) at "
                 f"{(m, k, n)}: a repeated launch differs")
    del ko
    km = timer.ms(lambda: ecc_qmatmul.ecc_qmatmul(a, w_enc, scale))
    pm = timer.ms(lambda: ecc_qmatmul.ecc_qmatmul_plain(a, w_enc, scale))
    lm_ = timer.ms(lambda: torch.matmul(a, w_bf))
    ops = 2 * m * k * n
    bb, by = bound_ms(m * k * 2 + k * n + m * n * 4 + 4, ops)
    log(f"ecc_qmatmul {(m, k, n)} ({plan.regime}, {plan.ctas} CTAs, "
        f"{plan.splits} splits): kernel {km:.4f} ms "
        f"({ops / km / 1e9:.1f} TFLOP/s), plain {pm:.4f} ms, "
        f"torch.matmul(bf16 decoded) {lm_:.4f} ms, bound {bb:.4f} ms ({by}), "
        f"flags {kfl.tolist()}, max abs err {e:.3g}")
    return dict(ms=km, plain_ms=pm, library_ms=lm_, bound_ms=bb,
                bound_by=by, ops=ops, err=e)


def _qmm_sum(cases) -> dict:
    """Per-call sums over ``[(case, launches)]``, bound by what bounds
    the case of the largest bound summed."""
    out = {k: sum(c[k] * n for c, n in cases)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms", "ops")}
    ops = out.pop("ops")
    out.update(bound_by=max(cases, key=lambda cn: cn[0]["bound_ms"] *
                            cn[1])[0]["bound_by"],
               launches=sum(n for _, n in cases),
               tflops=ops / out["ms"] / 1e9,
               library_tflops=ops / out["library_ms"] / 1e9)
    return out


def qmm_per_step(cfg):
    """``[((k, n), launches per decode step)]`` of a dense, vlm, encdec,
    hybrid, ssm or moe config: wq and wo, wk and wv, w_gate and w_up,
    w_down per layer
    (the encdec decoder: wq and wo of the self- and the cross-attention,
    wk and wv, w_up, w_down; its cross K and V come from the cache; a
    hybrid super-block: w_x, w_y_gate and w_out of each of its two RG-LRU
    layers, wq, wk, wv and wo of its local attention, and three SwiGLU
    MLPs; a tail layer: one RG-LRU and one MLP. The RG-LRU's two gate
    weights decode whole and multiply in ``torch.matmul``, as the
    reference's do; a Mamba2 layer: the fused ``w_in`` and ``w_out``; an
    MLA moe layer: ``wq`` (or ``w_dq`` and ``w_uq``), ``w_dkv``, ``wo`` and
    the three shared-expert projections, its ``w_uk`` and ``w_uv`` in
    :func:`qmm_latent_per_step`, its routed experts decoded whole), and an
    untied head (a tied head is a ``torch.matmul`` over the decoded
    embedding)."""
    d, f, nl = cfg.d_model, cfg.d_ff, cfg.n_layers
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    if cfg.family == "ssm":
        di = cfg.d_inner
        shapes = [((d, 2 * di + 2 * cfg.ssm_state + cfg.ssm_heads), nl),
                  ((di, d), nl)]
    elif cfg.family == "hybrid":
        w, nb = cfg.lru_width or d, nl // 3
        nrg = 2 * nb + (nl - 3 * nb)          # RG-LRU layers
        nmlp = 3 * nb + (nl - 3 * nb)         # SwiGLU MLPs
        shapes = [((d, w), 2 * nrg), ((w, d), nrg), ((d, qd), nb),
                  ((qd, d), nb), ((d, kvd), 2 * nb), ((d, f), 2 * nmlp),
                  ((f, d), nmlp)]
    elif cfg.family == "encdec":
        shapes = [((d, qd), 2 * nl), ((qd, d), 2 * nl), ((d, kvd), 2 * nl),
                  ((d, f), nl), ((f, d), nl)]
    elif cfg.family == "moe":
        if not cfg.use_mla:
            raise ValueError(f"{cfg.name}: a moe config without MLA")
        h, qr, ql = cfg.n_heads, cfg.qk_rope_dim, cfg.q_lora_rank
        qk, fs = h * (cfg.qk_nope_dim + qr), cfg.n_shared_experts * \
            cfg.moe_d_ff
        shapes = [((d, ql), nl), ((ql, qk), nl)] if ql else [((d, qk), nl)]
        shapes += [((d, cfg.kv_lora_rank + qr), nl),
                   ((h * cfg.v_head_dim, d), nl), ((d, fs), 2 * nl),
                   ((fs, d), nl)]
    else:
        shapes = [((d, qd), nl), ((qd, d), nl), ((d, kvd), 2 * nl),
                  ((d, f), 2 * nl), ((f, d), nl)]
    if not cfg.tie_embeddings:
        shapes.append(((d, cfg.vocab_padded), 1))
    return _merged(shapes)


def qmm_latent_per_step(cfg):
    """``[((k, n), launches per decode step)]`` of an MLA config's latent
    re-expansions ``w_uk`` and ``w_uv``: their rows are every cached
    latent (M = B·Smax), not the step's tokens."""
    r, h, nl = cfg.kv_lora_rank, cfg.n_heads, cfg.n_layers
    return _merged([((r, h * cfg.qk_nope_dim), nl),
                    ((r, h * cfg.v_head_dim), nl)])


def _merged(shapes):
    merged: dict = {}
    for kn, c in shapes:
        merged[kn] = merged.get(kn, 0) + c
    return list(merged.items())


def check_qmatmul_mixes(torch, dev, cfg, timer, gen):
    """The float path of ecc_qmatmul (bf16 activations) at every weight
    shape of the serve paths, each weight with 50 single- and 20
    double-flip blocks: the decode step at batch 4 (the entry; 211
    launches), the burst's decode step at its 8 slots, and the prefill of
    4 x 2,048 tokens (M = 8,192; 30 x 7 projections and the head). At each
    shape the flags equal the injected counts and the plain version's, and
    the output is within QMM_RTOL of the plain version; a split-K launch
    repeated gives the same bits. Times summed per step / per prefill
    against the bound (bytes at decode, operations at prefill) and
    ``torch.matmul`` over the bf16 weight decoded beforehand."""
    mixes = {4: "decode step, batch 4", 8: "burst step, 8 slots",
             8192: "prefill, 4 x 2,048 tokens"}
    cases = {m: [] for m in mixes}
    err = 0.0
    scale = torch.tensor(0.02, dtype=torch.float32, device=dev)
    for (k, n), count in qmm_per_step(cfg):
        w_enc, w_bf, flips = _qmm_weight(torch, dev, k, n, gen, scale)
        for m in mixes:
            c = _qmm_case(torch, dev, m, w_enc, w_bf, scale, flips, timer,
                          gen)
            err = max(err, c["err"])
            cases[m].append((c, count))
        del w_enc, w_bf
    mix = {}
    for m, what in mixes.items():
        mix[m] = _qmm_sum(cases[m])
        log(f"ecc_qmatmul float, {what} (M = {m}, "
            f"{mix[m]['launches']} launches): {mix[m]}")
    entry = dict(source="src/repro_torch/csrc/ecc_qmatmul.cu",
                 replaces="src/repro/kernels/ecc_qmatmul.py:393",
                 max_abs_err=err, **{k: mix[4][k] for k in (
                     "ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms")},
                 burst_m8=mix[8], prefill_m8192=mix[8192])
    log(f"ecc_qmatmul (per step, {mix[4]['launches']} launches): {entry}")
    return entry


def check_qmatmul_models(torch, dev, timer, gen):
    """The float ecc_qmatmul at M = 4 at every weight shape of a
    phi3-medium-14b, a paligemma-3b, a whisper-base, a recurrentgemma-2b,
    a mamba2-2.7b, a deepseek-v2-236b and a deepseek-v3-671b decode step
    (phi3's
    w_up 5,120 -> 17,920 and w_down 17,920 -> 5,120, its head 5,120 ->
    100,352; paligemma's wk and wv 2,048 -> 256, one KV head; whisper's K
    512 -> N 512, 2,048 and its 51,968-word head, K 2,048 -> N 512: few K
    blocks for the split-K grid; recurrentgemma's 2,560 -> 2,560, 7,680
    and 256, 7,680 -> 2,560: 164 launches; mamba2's fused w_in 2,560 ->
    10,576, whose last N tile is ragged, w_out 5,120 -> 2,560 and its
    50,304-word head: 129 launches; deepseek-v2's wq 5,120 -> 24,576,
    w_dkv 5,120 -> 576 (a ragged last N tile), wo 16,384 -> 5,120, its
    shared experts 5,120 <-> 3,072 and 102,400-word head; deepseek-v3's
    w_dq 7,168 -> 1,536 and w_uq 1,536 -> 24,576, w_dkv 7,168 -> 576, wo
    16,384 -> 7,168, shared experts 7,168 <-> 2,048 and 129,280-word
    head; both with w_uk and w_uv 512 -> 16,384 at M = 4 x MOE_SERVE_SMAX,
    the latent cache of the decode triple, the launch count of each
    equal to the one the decode triple checks), as
    :func:`check_qmatmul_mixes` holds deepseek-7b's: flags exact, within
    QMM_RTOL, split-K repeated bit for bit. -> ({arch: per-step sums},
    max abs err)."""
    from repro_torch.configs import get
    scale = torch.tensor(0.02, dtype=torch.float32, device=dev)
    out, err = {}, 0.0
    for arch in ("phi3-medium-14b", "paligemma-3b", "whisper-base",
                 "recurrentgemma-2b", "mamba2-2.7b", "deepseek-v2-236b",
                 "deepseek-v3-671b"):
        cfg = get(arch)
        todo = [(4, kn, count) for kn, count in qmm_per_step(cfg)]
        if cfg.family == "moe":
            todo += [(4 * MOE_SERVE_SMAX, kn, count)
                     for kn, count in qmm_latent_per_step(cfg)]
        cases = []
        for m, (k, n), count in todo:
            w_enc, w_bf, flips = _qmm_weight(torch, dev, k, n, gen, scale)
            c = _qmm_case(torch, dev, m, w_enc, w_bf, scale, flips, timer,
                          gen)
            err = max(err, c["err"])
            cases.append((c, count))
            del w_enc, w_bf
        out[arch] = _qmm_sum(cases)
        log(f"ecc_qmatmul float, {arch} decode step (M = 4, "
            f"{out[arch]['launches']} launches): {out[arch]}")
        if cfg.family == "moe" and \
                out[arch]["launches"] != _moe_step_launches(cfg)[1]:
            fail(f"{arch}: {out[arch]['launches']} ecc_qmatmul shapes a "
                 f"step checked, the decode step launches "
                 f"{_moe_step_launches(cfg)[1]}")
    return out, err


def check_qmatmul_moe_prefill(torch, dev, timer, gen):
    """The prefill regime of ecc_qmatmul at every weight shape of the
    deepseek-v2-236b and deepseek-v3-671b cache-less forward over
    MOE_FORWARD tokens (M = 8,192 rows for each projection, the latent
    re-expansions and the head), w_dkv's ragged last N tile (576 = 4 x 128
    + 64) included: held as :func:`check_qmatmul_mixes` holds its prefill
    mix (flags exact, within QMM_RTOL of the plain version on every
    output), timed beside the plain version, ``torch.matmul`` and the
    operations bound. -> ({arch: per-forward sums at full depth}, max abs
    err)."""
    from repro_torch.configs import get
    scale = torch.tensor(0.02, dtype=torch.float32, device=dev)
    m = MOE_FORWARD[0] * MOE_FORWARD[1]
    out, err = {}, 0.0
    for arch in ("deepseek-v2-236b", "deepseek-v3-671b"):
        cfg = get(arch)
        cases = []
        for (k, n), count in qmm_per_step(cfg) + qmm_latent_per_step(cfg):
            w_enc, w_bf, flips = _qmm_weight(torch, dev, k, n, gen, scale)
            c = _qmm_case(torch, dev, m, w_enc, w_bf, scale, flips, timer,
                          gen)
            err = max(err, c["err"])
            cases.append((c, count))
            del w_enc, w_bf
            torch.cuda.empty_cache()
        out[arch] = _qmm_sum(cases)
        log(f"ecc_qmatmul float, {arch} forward (M = {m}, "
            f"{out[arch]['launches']} launches at full depth): {out[arch]}")
    return out, err


def check_qmatmul_ragged_prefill(torch, dev, timer, gen):
    """One prefill-regime launch at mamba2-2.7b's ``w_in`` over its
    cache-less forward of 2 x 4,096 tokens: (M 8,192, K 2,560, N 10,576);
    N = 82 x 128 + 80, so the last N tile is ragged. Held as
    :func:`check_qmatmul_mixes` holds the prefill mix (flags exact, within
    QMM_RTOL of the plain version on every output, the ragged tile's
    included), timed beside the plain version, ``torch.matmul`` and the
    operations bound. -> the case (times, bound, error)."""
    scale = torch.tensor(0.02, dtype=torch.float32, device=dev)
    w_enc, w_bf, flips = _qmm_weight(torch, dev, 2560, 10576, gen, scale)
    c = _qmm_case(torch, dev, 8192, w_enc, w_bf, scale, flips, timer, gen)
    del w_enc, w_bf
    c["launches"] = 1
    log(f"ecc_qmatmul float, mamba2-2.7b w_in prefill (M 8,192, ragged last "
        f"N tile): {c}")
    return c


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
    S 2,064 = 129 pages) and at B 1, S 16,384, KV 32, hd 128, and at
    paligemma-3b's (B 4, S 2,064, H 8 over one KV head of 256: rep 8),
    bf16 q, with single- and double-flip blocks and ragged positions:
    flags equal to the plain version's, output within CHUNKED_* of it and
    within 2% of max|oracle| of the fp64 oracle. Timed at the path's last
    step (every row at pos S - 1), one launch per layer and step."""
    from repro_torch.configs import get
    from repro_torch.kernels import paged_attention
    from repro_torch.serving import kvcache
    pali = get("paligemma-3b")
    policy = kvcache.get_kv_policy("in-place-chunked")
    chunk = policy.chunk_pages * policy.page_size
    err = 0.0
    entry = None
    for c, b, s, ragged in ((cfg, 4, 2064, (2063, 1500, 700, 0)),
                            (cfg, 1, 16384, (16000,)),
                            (pali, 4, 2064, (2063, 1024, 17, 2000))):
        h, kvh, hd = c.n_heads, c.n_kv_heads, c.head_dim
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
        splits = paged_attention.plan_splits(b, kvh, s,
                                             paged_attention._sm_count(dev))
        log(f"chunked_page_attention {c.name} (H {h}, KV {kvh}, hd {hd}) "
            f"B={b} S={s} ({splits} splits of the "
            f"plan; the plain version's chunk {chunk}): flags "
            f"{kfl.tolist()}, max abs err vs plain {float(e.max()):.3g}, vs "
            f"fp64 oracle {oerr:.3g} (gate {otol:.3g}); per launch kernel "
            f"{km:.4f} ms, plain {pm:.4f} ms, sdpa(decoded) {lm_:.4f} ms, "
            f"bound {bb:.5f} ms")
        n = c.n_layers
        step = dict(ms=n * km, plain_ms=n * pm, bound_ms=n * bb,
                    bound_by=by, library_ms=n * lm_)
        if entry is None:
            entry = dict(source="src/repro_torch/csrc/chunked_attention.cu",
                         replaces="src/repro/kernels/paged_attention.py:313",
                         **step)
        elif c is pali:
            entry["paligemma"] = dict(step, launches_per_step=n, B=b, S=s,
                                      splits=splits)
        del ke, ve, kd_, vd_, args, last
    entry["max_abs_err"] = err
    log(f"chunked_page_attention (per step, {cfg.n_layers} launches of B=4 "
        f"H={cfg.n_heads} S=2064): {entry}")
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


def _paged_pool(torch, dev, b, s, kvh, hd, scheme, pos, gen, ps=16):
    """One layer's pool laid out as the serving front-end lays it out:
    parking pages 0..B-1, the rows' pages in a shuffled order, two spare;
    rows 0 and 1 share their first page (a common prefix); the last row's
    last page is its parking page (its ``pos`` lies before it). Data bytes
    flipped (300 single- and 100 double-flip blocks), and one check byte
    in 97 for parity-zero. -> (pool operands, table (B, npg) int32)."""
    from repro_torch.serving import kvcache
    npg = s // ps
    n_pages = b + b * npg + 2
    pol = kvcache.KVProtectionPolicy(scheme=scheme)
    pool = []
    for _ in range(2):
        e, c, sc = kvcache._encode_kv(
            torch.randn((n_pages, ps, kvh, hd), generator=gen, device=dev),
            pol)
        flip_blocks(torch, e.view(-1, 8), 300, 100, gen)
        if c is not None:
            _flip_check_bytes(torch, c, 97, gen)
        pool += [e, c, sc]
    perm = torch.randperm(n_pages - b, generator=gen, device=dev) + b
    table = perm[: b * npg].reshape(b, npg).to(torch.int32)
    table[1, 0] = table[0, 0]
    table[b - 1, npg - 1] = b - 1
    if int(pos[b - 1]) >= (npg - 1) * ps:
        fail("the parking page must lie past the last row's pos")
    return pool, table


def check_paged_tables(torch, dev, cfg, timer, gen):
    """Both kernels through their table entries (the pool read through the
    page table, what ``paged_gqa_decode`` calls) at the serve shapes: B 4,
    S 64 (decode; strip and chunked), B 4, S 2,064 (long context; chunked:
    the strip kernel stops at 848 tokens) and B 8, S 128 (burst,
    parity-zero, per-slot rows), over a shuffled table with a shared page
    and a parking page; then at minitron-4b widths (H 24, KV 8, hd 128,
    rep 3) and at paligemma-3b's (H 8 over one KV head of 256: rep 8; the
    decode's S 64, S 272 under all three schemes — the strip kernel stops
    at 287 tokens there — and S 2,064) in bf16. Each against
    ``paged_attention.gather_strips`` + the plain version: the strip kernel
    bit-equal, the chunked kernel within CHUNKED_*; flags and per-slot rows
    exactly equal. Prints the kernel's time through the table and the time
    the gather alone takes (the copy the decode step does not make). Each
    case's bound counts the work of its ragged positions (the live tokens:
    each distinct live page slot's bytes read once, the scores and PV of
    every row's ``pos + 1`` tokens), its plain time the strip plain version
    on the gathered strips (the gather not included), and its library time
    SDPA over the same gathered, pre-decoded bf16 strips with a mask past
    ``pos``. -> {kernel: {"max_abs_err": x, "through_table": [per-case
    times]}}."""
    from repro_torch.configs import get
    from repro_torch.kernels import paged_attention as pa
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res = {k: dict(max_abs_err=0.0, through_table=[])
           for k in ("fused_page_attention", "chunked_page_attention")}
    pali = get("paligemma-3b")
    cases = [(cfg, 4, 64, "in-place", False, (63, 32, 21, 47)),
             (cfg, 4, 2064, "in-place", False, (2063, 1500, 700, 2047)),
             (cfg, BURST_SLOTS, BURST_MAX_LEN, "parity-zero", True,
              (127, 100, 64, 33, 16, 15, 1, 0)),
             (get("minitron-4b"), 4, 64, "in-place", True, (63, 40, 15, 0)),
             (get("minitron-4b"), 4, 2064, "in-place", False,
              (2063, 1024, 17, 2000)),
             (pali, 4, 64, "in-place", False, (63, 32, 21, 47)),
             (pali, 4, 272, "in-place", False, (271, 200, 17, 250)),
             (pali, 4, 272, "parity-zero", True, (271, 100, 0, 255)),
             (pali, 4, 272, "faulty", False, (271, 64, 5, 254)),
             (pali, 4, 2064, "in-place", False, (2063, 1500, 700, 2047))]
    for c, b, s, scheme, per_slot, ragged in cases:
        h, kvh, hd = c.n_heads, c.n_kv_heads, c.head_dim
        pos = torch.tensor(ragged, dtype=torch.int32, device=dev)
        pool, table = _paged_pool(torch, dev, b, s, kvh, hd, scheme, pos, gen)
        q = torch.randn((b, h, 1, hd), generator=gen, device=dev).to(
            torch.bfloat16)
        ke, kch, ksc = pa.gather_strips(*pool[:3], table)
        ve, vch, vsc = pa.gather_strips(*pool[3:], table)
        strips = (q, ke, kch, ksc, ve, vch, vsc, pos)
        nbytes, ops, live = _table_work(torch, c, b, s, scheme, per_slot,
                                        pos, table)
        bb, by = bound_ms(nbytes, ops)
        if scheme == "parity-zero":
            kd_ = _decoded_parity_bf16(torch, ke, kch, ksc)
            vd_ = _decoded_parity_bf16(torch, ve, vch, vsc)
        elif scheme == "faulty":
            kd_, vd_ = _raw_bf16(torch, ke, ksc), _raw_bf16(torch, ve, vsc)
        else:
            kd_, vd_ = _decoded_bf16(torch, ke, ksc), _decoded_bf16(
                torch, ve, vsc)
        mask = (torch.arange(s, device=dev)[None, :] <= pos[:, None])[
            :, None, None, :]
        lm_ = timer.ms(lambda: sdpa(q, kd_, vd_, attn_mask=mask,
                                    enable_gqa=h != kvh))
        del kd_, vd_
        kernels = [("chunked_page_attention",
                    pa.chunked_page_attention_paged,
                    pa.chunked_page_attention_plain)]
        if s < pa.strip_smem_crossover(hd, h // kvh):
            kernels.insert(0, ("fused_page_attention",
                               pa.fused_page_attention_paged,
                               pa.fused_page_attention_plain))
        for name, fn, plain in kernels:
            kw = dict(scheme=scheme, per_slot=per_slot)
            ko, kf = fn(q, *pool, table, pos, **kw)
            po, pf = plain(*strips, **kw)
            if not torch.equal(kf, pf) or \
                    (int(kf.sum()) == 0) != (scheme == "faulty"):
                fail(f"{name} through the table at {c.name} B={b} S={s} "
                     f"{scheme}: flags {kf.tolist()} vs plain {pf.tolist()}")
            e = (ko.float() - po.float()).abs()
            if name == "fused_page_attention":
                if not torch.equal(ko, po):
                    fail(f"{name} through the table at {c.name} B={b} S={s} "
                         f"{scheme} differs from gather + plain in "
                         f"{int((ko != po).sum())} outputs: max abs err "
                         f"{float(e.max())}")
            elif bool((e > CHUNKED_RTOL * po.float().abs()
                       + CHUNKED_ATOL).any()):
                fail(f"{name} through the table at {c.name} B={b} S={s} "
                     f"{scheme}: max abs err {float(e.max())} from gather + "
                     f"plain")
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"],
                                           float(e.max()))
            km = timer.ms(lambda f=fn, k=kw: f(q, *pool, table, pos, **k))
            pm = timer.ms(lambda p=plain, k=kw: p(*strips, **k))
            row = dict(arch=c.name, B=b, S=s, scheme=scheme,
                       per_slot=per_slot, live_tokens=live, ms=km,
                       plain_ms=pm, bound_ms=bb, bound_by=by,
                       library_ms=lm_, launches_per_step=c.n_layers)
            extra = ""
            if name == "chunked_page_attention":
                row["splits"] = pa.plan_splits(b, kvh, s, pa._sm_count(dev))
                extra = f", {row['splits']} splits"
            res[name]["through_table"].append(row)
            n = c.n_layers
            log(f"{name} through the table, {c.name} (H {h}, KV {kvh}, hd "
                f"{hd}) B={b} S={s} {scheme}{' per-slot' if per_slot else ''}"
                f" at pos {list(ragged)} ({live} live tokens): flags "
                f"{kf.tolist()} equal to gather + plain, max abs err "
                f"{float(e.max()):.3g}; per launch {km:.4f} ms, plain (on the "
                f"gathered strips) {pm:.4f} ms, sdpa(masked, "
                f"decoded) {lm_:.4f} ms, bound {bb:.5f} ms ({by}){extra}; per "
                f"step ({n} launches) {n * km:.4f} ms, sdpa {n * lm_:.4f} ms, "
                f"bound {n * bb:.5f} ms")
        if c is cfg and s in (2064, BURST_MAX_LEN):
            gm = timer.ms(lambda: (pa.gather_strips(*pool[:3], table),
                                   pa.gather_strips(*pool[3:], table)))
            log(f"gather_strips alone (K and V strips, {scheme}) at B={b} "
                f"S={s}: {gm:.4f} ms per layer, {cfg.n_layers * gm:.3f} ms "
                f"per decode step: the copy the table entries do not make")
        del pool, table, ke, ve, strips
    return res


def _table_work(torch, c, b, s, scheme, per_slot, pos, table):
    """The bytes and operations one table-entry call needs at ragged
    positions: q read and the output written (bf16), each distinct live
    (page, slot) of K and V read once with its scale (and its check bytes
    under parity-zero), the live pages' table entries, pos and the flags;
    scores and PV over every row's ``pos + 1`` tokens. -> (bytes,
    operations, live token count)."""
    h, kvh, hd = c.n_heads, c.n_kv_heads, c.head_dim
    ps = s // table.shape[1]
    n = pos.long() + 1
    t = torch.arange(s, device=pos.device)
    flat = table.long()[:, t // ps] * ps + t % ps          # (B, S)
    slots = int(torch.unique(flat[t[None, :] < n[:, None]]).numel())
    live = int(n.sum())
    per_token = 2 * (kvh * hd + 4 + (kvh * hd // 8 if scheme == "parity-zero"
                                     else 0))
    nbytes = (2 * 2 * b * h * hd + slots * per_token
              + 4 * int(((n + ps - 1) // ps).sum()) + 4 * b
              + 4 * (2 * b if per_slot else 2))
    return nbytes, 4 * h * hd * live, live


def _raw_bf16(torch, enc, sc):
    """Unprotected (faulty-scheme) (B, S, KV, hd) strip -> dequantized
    bf16 (B, KV, S, hd)."""
    return (enc.view(torch.int8).float() * sc[..., None, None]).to(
        torch.bfloat16).transpose(1, 2)


def _decoded_parity_bf16(torch, enc, ch, sc):
    """Parity-zero (B, S, KV, hd) strip -> dequantized bf16 (B, KV, S, hd)."""
    from repro_torch.core import ecc
    qv = ecc.decode_parity8(enc, ch)[0].view(torch.int8)
    return (qv.float() * sc[..., None, None]).to(torch.bfloat16).transpose(
        1, 2)


def check_flash(torch, dev, cfg, timer, gen):
    """flash_attention at the prefill's shape (B 4, H 32, S 2,048, hd 128,
    bf16; 30 launches per prefill) and at a ragged S, against its plain
    version; then at head_dim 256 (paligemma-3b's prefill, B 4, H 8, S
    2,048, 18 launches per prefill, and a ragged S) in bf16 (tensor cores)
    and f32 (CUDA cores); and at head_dim 64 (whisper-base's decoder, B 8,
    H 8, S 448, bf16, 6 launches per forward). Library
    yardstick SDPA with ``is_causal=True``; achieved TFLOP/s of both over
    the causal triangle's operations."""
    from repro_torch.kernels import flash_attention
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def check(b, h, s, hd, dtype):
        q, k, v = (torch.randn((b, h, s, hd), generator=gen, device=dev).to(
            dtype) for _ in range(3))
        ko = flash_attention.flash_attention(q, k, v)
        po = flash_attention.flash_attention_plain(q, k, v)
        e = (ko.float() - po.float()).abs()
        if bool((e > FLASH_RTOL * po.float().abs() + FLASH_ATOL).any()):
            fail(f"flash_attention out of tolerance of its plain version at "
                 f"{(b, h, s, hd)} {dtype}: max abs err {float(e.max())}")
        log(f"flash_attention {(b, h, s, hd)} {dtype}: max abs err vs plain "
            f"{float(e.max()):.3g}, mean {float(e.mean()):.3g}")
        return (q, k, v), float(e.max())

    def timed(qkv):
        q = qkv[0]
        b, h, s, hd = q.shape
        km = timer.ms(lambda: flash_attention.flash_attention(*qkv))
        pm = timer.ms(lambda: flash_attention.flash_attention_plain(*qkv))
        lm_ = timer.ms(lambda: sdpa(*qkv, is_causal=True))
        ops = 4 * b * h * hd * s * (s + 1) // 2   # QK^T and PV, causal
        bb, by = bound_ms(4 * b * h * s * hd * q.element_size(), ops,
                          BF16_FLOPS if q.dtype == torch.bfloat16
                          else F32_FLOPS)
        log(f"flash_attention {(b, h, s, hd)} {q.dtype} per launch: kernel "
            f"{km:.4f} ms ({ops / km / 1e9:.1f} TFLOP/s), plain {pm:.4f} ms, "
            f"sdpa(causal) {lm_:.4f} ms ({ops / lm_ / 1e9:.1f} TFLOP/s), "
            f"bound {bb:.4f} ms ({by})")
        return dict(ms=km, plain_ms=pm, bound_ms=bb, bound_by=by,
                    library_ms=lm_, tflops=ops / km / 1e9,
                    library_tflops=ops / lm_ / 1e9)

    h, hd = cfg.n_heads, cfg.head_dim
    qkv, err = check(4, h, 2048, hd, torch.bfloat16)
    one = timed(qkv)
    n = cfg.n_layers
    entry = dict(source="src/repro_torch/csrc/flash_attention.cu",
                 replaces="src/repro/kernels/flash_attention.py:87",
                 **{k: n * one[k] for k in ("ms", "plain_ms", "bound_ms",
                                            "library_ms")},
                 bound_by=one["bound_by"], tflops=one["tflops"],
                 library_tflops=one["library_tflops"])
    del qkv
    err = max(err, check(1, h, 1000, hd, torch.bfloat16)[1])
    entry["head_dim_256"] = {}
    for dtype in (torch.bfloat16, torch.float32):
        qkv, e = check(4, 8, 2048, 256, dtype)
        err = max(err, e, check(1, 8, 1000, 256, dtype)[1])
        entry["head_dim_256"][str(dtype)[6:]] = timed(qkv)
        del qkv
    # paligemma-3b's prefill of 4 x 2,048 tokens: the bf16 head_dim 256
    # shape, K and V repeated to its 8 query heads, once per layer
    from repro_torch.configs import get
    nl = get("paligemma-3b").n_layers
    one = entry["head_dim_256"]["bfloat16"]
    entry["paligemma_prefill"] = dict(
        {k: nl * one[k] for k in ("ms", "plain_ms", "bound_ms",
                                  "library_ms")},
        bound_by=one["bound_by"], launches=nl)
    # whisper-base's decoder self-attention over its 448-token text context
    # at batch 8 (phase 12's forward), once per decoder layer
    qkv, e = check(8, 8, 448, 64, torch.bfloat16)
    err = max(err, e)
    one = timed(qkv)
    del qkv
    nl = get("whisper-base").n_layers
    entry["whisper_forward"] = dict(
        {k: nl * one[k] for k in ("ms", "plain_ms", "bound_ms",
                                  "library_ms")},
        bound_by=one["bound_by"], launches=nl, tflops=one["tflops"],
        library_tflops=one["library_tflops"])
    entry["window"], e = check_flash_window(torch, dev, timer, gen)
    err = max(err, e)
    entry["mla_192_128"], e = check_flash_mla(torch, dev, timer, gen)
    entry["max_abs_err"] = max(err, e)
    log(f"flash_attention (per prefill, 30 launches of (4, 32, 2048, 128)): "
        f"{entry}")
    return entry


def check_flash_mla(torch, dev, timer, gen, *, b=2, h=128, s=4096):
    """Flash at MLA's head split (q and k of 192 = 128 nope + 64 rope dims,
    v of 128; scale 1/sqrt(192)) at the deepseek-v2-236b and -v3-671b
    forward of phases 15 and 16 (B 2, their 128 heads, S 4,096, bf16: one
    launch per layer), and at a ragged S (1,000) in bf16 and f32: the
    kernel against its plain version within FLASH_RTOL / FLASH_ATOL, timed
    per launch beside the plain version and SDPA (causal) over the same
    inputs, and held to SDPA within FLASH_SDPA_RTOL. The bound counts the
    causal triangle's S (S + 1) / 2 pairs per head, 2 (192 + 128)
    operations each (QK^T and PV), at the bf16 peak, against q, k and v
    read once and the output written once. -> (entry, max abs err)."""
    from repro_torch.kernels import flash_attention
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dqk, dv = 192, 128

    def check(shape, dtype):
        q, k = (torch.randn((*shape, dqk), generator=gen, device=dev).to(
            dtype) for _ in range(2))
        v = torch.randn((*shape, dv), generator=gen, device=dev).to(dtype)
        ko = flash_attention.flash_attention(q, k, v)
        po = flash_attention.flash_attention_plain(q, k, v)
        if ko.shape != (*shape, dv):
            fail(f"flash_attention (192, 128) output {tuple(ko.shape)}")
        e = (ko.float() - po.float()).abs()
        if bool((e > FLASH_RTOL * po.float().abs() + FLASH_ATOL).any()):
            fail(f"flash_attention (192, 128) out of tolerance of its plain "
                 f"version at {shape} {dtype}: max abs err {float(e.max())}")
        log(f"flash_attention {shape} q/k 192, v 128 {dtype}: max abs err "
            f"vs plain {float(e.max()):.3g}, mean {float(e.mean()):.3g}")
        return (q, k, v), float(e.max())

    err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        err = max(err, check((1, 8, 1000), dtype)[1])
    qkv, e = check((b, h, s), torch.bfloat16)
    err = max(err, e)
    km = timer.ms(lambda: flash_attention.flash_attention(*qkv))
    pm = timer.ms(lambda: flash_attention.flash_attention_plain(*qkv))
    lm_ = timer.ms(lambda: sdpa(*qkv, is_causal=True))
    so = sdpa(*qkv, is_causal=True).float()
    lib_err = float((so - flash_attention.flash_attention(*qkv).float())
                    .abs().max())
    lib_top = float(so.abs().max())
    del so
    if lib_err > FLASH_SDPA_RTOL * lib_top:
        fail(f"flash_attention (192, 128) differs from SDPA (causal) by "
             f"{lib_err} at {(b, h, s)} (max |SDPA| {lib_top})")
    ops = 2 * (dqk + dv) * b * h * s * (s + 1) // 2
    bb, by = bound_ms(2 * b * h * s * (2 * dqk + 2 * dv), ops)
    log(f"flash_attention {(b, h, s)} q/k 192, v 128 bf16 per launch: "
        f"kernel {km:.4f} ms ({ops / km / 1e9:.1f} TFLOP/s), plain {pm:.4f} "
        f"ms, sdpa(causal) {lm_:.4f} ms ({ops / lm_ / 1e9:.1f} TFLOP/s; max "
        f"abs diff from the kernel {lib_err:.3g}, max |SDPA| {lib_top:.3g}), "
        f"bound {bb:.4f} ms ({by})")
    del qkv
    return dict(ms=km, plain_ms=pm, bound_ms=bb, bound_by=by, library_ms=lm_,
                tflops=ops / km / 1e9, library_tflops=ops / lm_ / 1e9,
                shape=[b, h, s, dqk, dv]), err


def check_ecc_decode_expert_leaves(torch, dev, timer, gen):
    """``ecc_decode`` at one routed-expert leaf of each moe config, as a
    decode step decodes it whole (``ProtectedWeight.astype``):
    deepseek-v2-236b's 160 x 5,120 x 1,536 (1.26 G values) and
    deepseek-v3-671b's 256 x 7,168 x 2,048 (3.76 G values, 3.76 GB of
    image: byte offsets past 2^31). The image is encoded by the
    ``ecc_encode`` kernel from WOT-compliant random blocks, with 1,000
    single and 1,000 double flips spread over it; the kernel must equal
    its plain version byte for byte and flag every flipped block. Timed
    beside the plain version; bound 8 bytes read and 9 written per block.
    -> {config: entry}."""
    from repro_torch.configs import get
    from repro_torch.kernels import ecc_decode, ecc_encode

    out = {}
    for name in ("deepseek-v2-236b", "deepseek-v3-671b"):
        cfg = get(name)
        n = cfg.n_experts * cfg.d_model * cfg.moe_d_ff
        enc = ecc_encode.ecc_encode(wot_blocks(torch, dev, n // 8, gen))
        ns, nd = flip_blocks(torch, enc, 1000, 1000, gen)
        kd, kf = ecc_decode.ecc_decode(enc)
        if int((kf & 1).sum()) != ns or int((kf >> 1).sum()) != nd:
            fail(f"ecc_decode flag counts at the {name} expert leaf != "
                 f"the injected single/double blocks")
        pd, pf = ecc_decode.ecc_decode_plain(enc)
        same = torch.equal(kd, pd) and torch.equal(kf, pf)
        del kd, kf, pd, pf
        if not same:
            fail(f"ecc_decode disagrees with its plain version at the {name} "
                 f"expert leaf ({n} values)")
        torch.cuda.empty_cache()
        bms, by = bound_ms(17 * (n // 8))
        out[name] = dict(
            values=n, ms=timer.ms(lambda: ecc_decode.ecc_decode(enc)),
            plain_ms=timer.ms(lambda: ecc_decode.ecc_decode_plain(enc)),
            bound_ms=bms, bound_by=by, library_ms=None, max_abs_err=0.0)
        log(f"ecc_decode at one {name} expert leaf ({n} values, "
            f"{n / 2 ** 30:.2f} GiB of image): {out[name]}")
        del enc
        torch.cuda.empty_cache()
    return out


def check_flash_window(torch, dev, timer, gen, *, b=2, h=10, s=4096, hd=256,
                       window=2048):
    """The sliding window of flash at recurrentgemma-2b's local attention
    over a 2 x 4,096-token forward (B 2, its 10 query heads, S 4,096,
    head_dim 256, bf16, window 2,048: one launch per super-block), and at
    a ragged S with a window that is not a multiple of 64 (S 1,000, window
    300) in bf16 and f32: the kernel against its plain version (which
    walks the same key tiles) within FLASH_RTOL / FLASH_ATOL; timed per
    launch beside the plain version and SDPA over the same inputs with the
    band as a boolean mask. The bound counts the visible (query, key)
    pairs of this run, 4 * hd operations each (QK^T and PV), at the bf16
    peak, against each of q, k, v read once and the output written once.
    -> (entry, max abs err)."""
    from repro_torch.kernels import flash_attention
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def check(shape, win, dtype):
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        ko = flash_attention.flash_attention(q, k, v, window=win)
        po = flash_attention.flash_attention_plain(q, k, v, window=win)
        e = (ko.float() - po.float()).abs()
        if bool((e > FLASH_RTOL * po.float().abs() + FLASH_ATOL).any()):
            fail(f"windowed flash_attention out of tolerance of its plain "
                 f"version at {shape} window {win} {dtype}: max abs err "
                 f"{float(e.max())}")
        log(f"flash_attention {shape} window {win} {dtype}: max abs err vs "
            f"plain {float(e.max()):.3g}, mean {float(e.mean()):.3g}")
        return (q, k, v), float(e.max())

    err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        err = max(err, check((1, 4, 1000, hd), 300, dtype)[1])
    qkv, e = check((b, h, s, hd), window, torch.bfloat16)
    err = max(err, e)
    pos = torch.arange(s, device=dev)
    age = pos[:, None] - pos[None, :]
    band = (age >= 0) & (age < window)
    pairs = int(band.sum())
    km = timer.ms(lambda: flash_attention.flash_attention(*qkv,
                                                          window=window))
    pm = timer.ms(lambda: flash_attention.flash_attention_plain(
        *qkv, window=window))
    lm_ = timer.ms(lambda: sdpa(*qkv, attn_mask=band))
    so = sdpa(*qkv, attn_mask=band)
    ko = flash_attention.flash_attention(*qkv, window=window)
    lib_err = float((so.float() - ko.float()).abs().max())
    del so, ko
    causal_ms = timer.ms(lambda: flash_attention.flash_attention(*qkv))
    ops = 4 * b * h * hd * pairs
    bb, by = bound_ms(4 * b * h * s * hd * 2, ops)
    log(f"flash_attention {(b, h, s, hd)} bf16 window {window} per launch: "
        f"kernel {km:.4f} ms ({ops / km / 1e9:.1f} TFLOP/s over {pairs} "
        f"visible pairs per head), plain {pm:.4f} ms, sdpa(band mask) "
        f"{lm_:.4f} ms ({ops / lm_ / 1e9:.1f} TFLOP/s; max abs diff from "
        f"the kernel {lib_err:.3g}), bound {bb:.4f} ms ({by}); the causal "
        f"kernel over the same inputs {causal_ms:.4f} ms")
    del qkv
    return dict(ms=km, plain_ms=pm, bound_ms=bb, bound_by=by, library_ms=lm_,
                visible_pairs=pairs, tflops=ops / km / 1e9,
                library_tflops=ops / lm_ / 1e9, causal_ms=causal_ms), err


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
    """quantize_throttle against its plain version in both of its modes.
    The deploy's (q out, masters untouched): byte-equal q and bit-equal
    scale. The train step's write-back (the moved masters rewritten in
    place, no q): bit-equal masters and scale. At the embedding leaf
    (52,428,800 blocks), a ragged size, exact rounding ties and an all-zero
    leaf (the eps clamp). Timed summed over the protected leaves one
    throttled train step of the training phase visits (the 8-layer
    full-width model; one call = two launches): the write-back (the main
    path's call; bound 8 bytes a value plus 4 per moved value, counted on
    this data) and, beside it, the deploy mode (9 bytes a value)."""
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
        # the write-back, over a ragged value count (the last block masked)
        flat = w.reshape(-1)[: w.numel() - 3] if name == "ragged" else w
        kw, pw = flat.clone(), flat.clone()
        _, kws = qt.quantize_throttle(kw, write_back=True, with_q=False)
        _, pws = qt.quantize_throttle_plain(pw, write_back=True)
        if not torch.equal(kw.view(torch.int32), pw.view(torch.int32)) or \
                kws.view(torch.int32).item() != pws.view(torch.int32).item():
            fail(f"the quantize_throttle write-back differs from its plain "
                 f"version on the {name} input: "
                 f"{int((kw != pw).sum())} masters")
        if name == "embedding":
            bb, _ = bound_ms(9 * w.numel())
            km = timer.ms(lambda: qt.quantize_throttle(w))
            pm = timer.ms(lambda: qt.quantize_throttle_plain(w))
            lm_ = timer.ms(lambda: torch.linalg.vector_norm(w, float("inf")))
            log(f"quantize_throttle embedding leaf {tuple(w.shape)}: kernel "
                f"{km:.4f} ms, plain {pm:.4f} ms, vector_norm(inf) {lm_:.4f} "
                f"ms, bound {bb:.4f} ms")
        del w, kq, pq, flat, kw, pw
    log("quantize_throttle: q byte-equal, masters and scale bit-equal to the "
        "plain version in both modes on the embedding, ragged, ties and "
        "all-zero inputs")
    leaves = train_leaf_shapes(cfg.with_(n_layers=TRAIN_LAYERS))
    nmax = max(math.prod(s) for s in leaves)
    raw = 0.02 * torch.randn((nmax // 8, 8), generator=gen, device=dev)
    buf = torch.empty_like(raw)
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "deploy_ms": 0.0,
           "bytes": 0, "deploy_bytes": 0, "moved": 0, "values": 0}
    for s in leaves:
        w0 = raw[: math.prod(s) // 8]
        w = buf[: w0.shape[0]]
        reset = (lambda: w.copy_(w0))
        tot["ms"] += timer.ms(lambda: qt.quantize_throttle(
            w, write_back=True, with_q=False), setup=reset)
        tot["plain_ms"] += timer.ms(lambda: qt.quantize_throttle_plain(
            w, write_back=True, with_q=False), setup=reset)
        moved = int((w != w0).sum())
        tot["library_ms"] += timer.ms(
            lambda: torch.linalg.vector_norm(w0, float("inf")))
        tot["deploy_ms"] += timer.ms(lambda: qt.quantize_throttle(w0))
        tot["bytes"] += 8 * w0.numel() + 4 * moved
        tot["deploy_bytes"] += 9 * w0.numel()
        tot["moved"] += moved
        tot["values"] += w0.numel()
    del raw, buf
    bb, by = bound_ms(tot["bytes"])
    entry = dict(source="src/repro_torch/csrc/quant_throttle.cu",
                 replaces="src/repro/kernels/quant_throttle.py:65",
                 max_abs_err=0.0, ms=tot["ms"], plain_ms=tot["plain_ms"],
                 bound_ms=bb, bound_by=by, library_ms=tot["library_ms"],
                 deploy_ms=tot["deploy_ms"],
                 deploy_bound_ms=bound_ms(tot["deploy_bytes"])[0],
                 moved=tot["moved"], values=tot["values"])
    log(f"quantize_throttle (per train step: {len(leaves)} protected leaves "
        f"of the {TRAIN_LAYERS}-layer model, the in-place write-back, one "
        f"call = two launches each; library = vector_norm(inf), pass 1 "
        f"only; deploy = the q mode, 9 B a value): {entry}")
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


def _unfused_write_kv(lc, k, v, policy, *, pos=None, copy=False):
    """The unfused route of the KV write (the route before ``kv_write``),
    kept here only to time and count it beside ``kv_write`` (same signature
    as ``kvcache._write_kv``): per side the plain per-token quantize, the
    ``throttle`` kernel (in-place scheme), the scheme's encode on the
    policy's route (the ``ecc_encode`` kernel for in-place on "cuda"), then
    the index puts of the reference's ``_write_token`` / ``_write_pages``."""
    import torch
    from repro_torch.core import quant
    from repro_torch.kernels import kv_write
    from repro_torch.protection.backends import get_backend
    be = get_backend(policy.backend)
    sch = policy.scheme_obj
    out = []
    for name, x in (("k", k), ("v", v)):
        xf = (x if pos is None else x[:, 0]).to(torch.float32)
        scale = quant.compute_scale(xf, dim=(-2, -1))
        q, _ = quant.quantize(xf, scale=scale)
        if sch.requires_wot:
            q = be.throttle(q.reshape(-1, 8)).reshape(q.shape)
        enc, ch = sch.encode(q, be)
        sc = scale[..., 0, 0]
        args = (lc[f"{name}_pages"], lc.get(f"{name}_checks"),
                lc[f"{name}_scale"], lc["kv_table"], enc, ch, sc)
        if pos is None:
            kv_write._write_pages(*args)
        else:
            kv_write._write_token(*args, pos)
        out += [enc, ch, sc]
    return tuple(out) if copy else None


def _kv_write_case(torch, dev, gen, b, kv, hd, npg, ps, scheme, t):
    """One layer's pool as the request front-end lays it out (parking
    pages 0..B-1, then the rows' pages in a shuffled order, two spare;
    random bytes and scales, so bytes a write does not own must stay) and
    bf16 K/V (B, t, kv, hd) with per-token magnitudes spread over e^+-3.
    A decode token (t = 1) goes to a ragged position of each row: rows 0
    and 1 share their first page (row 0 writes into it, row 1 past it) and
    the last row is parked on its parking page. A prefill writes t tokens
    from position 0. -> (k, v, pools (kp, kc, ks, vp, vc, vs), table, pos
    or None)."""
    n_pages = b + b * npg + 2
    pools = []
    for _ in range(2):
        pools += [torch.randint(0, 256, (n_pages, ps, kv, hd), generator=gen,
                                device=dev, dtype=torch.uint8),
                  torch.randint(0, 256, (n_pages, ps, kv, hd // 8),
                                generator=gen, device=dev, dtype=torch.uint8)
                  if scheme == "parity-zero" else None,
                  torch.randn((n_pages, ps), generator=gen, device=dev)]
    perm = torch.randperm(n_pages - b, generator=gen, device=dev) + b
    table = perm[: b * npg].reshape(b, npg).to(torch.int32)
    mag = torch.exp(6 * torch.rand((2, b, t, 1, 1), generator=gen,
                                   device=dev) - 3)
    x = (torch.randn((2, b, t, kv, hd), generator=gen, device=dev)
         * mag).to(torch.bfloat16)
    pos = None
    if t == 1:
        s = npg * ps
        pos = (torch.arange(b, device=dev, dtype=torch.int32) * 37 + 5) % s
        pos[1] = ps + int(pos[1]) % (s - ps)
        table[1, 0] = table[0, 0]
        table[b - 1] = b - 1
    return x[0], x[1], pools, table, pos


def _kv_write_bytes(b, t, kv, hd, ps, scheme, copy=False):
    """Bytes one KV write must move: K and V read once (bf16), each encoded
    token, check row and scale written once (twice with the prefill's
    copy), and each row's pos and page ids read once."""
    d = kv * hd
    out = d + (d // 8 if scheme == "parity-zero" else 0) + 4
    return (2 * b * t * (2 * d + out * (2 if copy else 1)) + 4 * b
            + 4 * b * -(-t // ps))


def check_kv_write(torch, dev, timer, gen):
    """kv_write against kv_write_plain, byte-equal pools, check planes and
    copies, bit-equal scales, under all three schemes: at the decode step
    (B 4, 64-token rows), the burst step (B 8, 128-token rows), the 4 x
    2,048 prefill (whole pages from 0, with the copies), minitron-4b
    widths (KV 8, rep 3) and paligemma-3b's one KV head of 256 (decode
    and the 4 x 2,048 prefill: two CTAs per token, one for K and one for
    V). Timed per decode step (30 launches) beside its
    plain composition and the unfused route (the plain quantize, the
    throttle and ecc_encode kernels, the index puts), and per prefill
    layer. No single PyTorch call computes the function: no library
    time."""
    from repro_torch.configs import get
    from repro_torch.kernels import kv_write
    from repro_torch.serving import kvcache
    cfg, mini, pali = get("deepseek-7b"), get("minitron-4b"), \
        get("paligemma-3b")
    kv, hd, ps = cfg.n_kv_heads, cfg.head_dim, 16
    pkv, phd = pali.n_kv_heads, pali.head_dim
    shapes = (("decode", 4, kv, hd, 4, 1), ("burst", 8, kv, hd, 8, 1),
              ("prefill", 4, kv, hd, 129, 2048),
              ("minitron-4b decode", 4, mini.n_kv_heads, mini.head_dim, 4, 1),
              ("paligemma-3b decode", 4, pkv, phd, 4, 1),
              ("paligemma-3b prefill", 4, pkv, phd, 129, 2048))
    times = {}
    for what, b, kvh, d, npg, t in shapes:
        for scheme in ("faulty", "parity-zero", "in-place"):
            k, v, pools, table, pos = _kv_write_case(
                torch, dev, gen, b, kvh, d, npg, ps, scheme, t)
            kp = [None if a is None else a.clone() for a in pools]
            pp = [None if a is None else a.clone() for a in pools]
            copy = pos is None
            kc = kv_write.kv_write(k, v, *kp, table, pos, scheme=scheme,
                                   copy=copy) or ()
            pc = kv_write.kv_write_plain(k, v, *pp, table, pos,
                                         scheme=scheme, copy=copy) or ()
            for a, c in zip(kp + list(kc), pp + list(pc)):
                if (a is None) != (c is None) or (a is not None and not
                                                  torch.equal(
                                                      a.view(torch.uint8),
                                                      c.view(torch.uint8))):
                    fail(f"kv_write differs from its plain version at the "
                         f"{what} shape under {scheme}")
            if scheme != "in-place" or what == "burst":
                continue
            keys = ("k_pages", "k_checks", "k_scale", "v_pages", "v_checks",
                    "v_scale")
            pol = kvcache.KVProtectionPolicy(scheme=scheme, backend="cuda")
            old = _unfused_write_kv(dict(zip(keys, pp), kv_table=table), k,
                                    v, pol, pos=pos, copy=copy) or ()
            if not all(torch.equal(a, c) for a, c in zip(kp + list(kc),
                                                         pp + list(old))
                       if a is not None):
                fail(f"the unfused KV route differs from kv_write ({what})")
            lc = dict(zip(keys, kp), kv_table=table)
            times[what] = dict(
                ms=timer.ms(lambda: kv_write.kv_write(
                    k, v, *kp, table, pos, scheme=scheme, copy=copy)),
                plain_ms=timer.ms(lambda: kv_write.kv_write_plain(
                    k, v, *kp, table, pos, scheme=scheme, copy=copy)),
                unfused_route_ms=timer.ms(lambda: _unfused_write_kv(
                    lc, k, v, pol, pos=pos, copy=copy)),
                bound_ms=bound_ms(_kv_write_bytes(b, t, kvh, d, ps, scheme,
                                                  copy))[0])
            log(f"kv_write {what} (B {b}, T {t}, KV {kvh}, hd {d}, "
                f"in-place; one launch): {times[what]}")
            del lc, old
        del k, v, pools, kp, pp, kc, pc
    log("kv_write: pools, check planes, copies byte-equal and scales "
        "bit-equal to the plain version at the decode, burst, prefill, "
        "minitron-4b and paligemma-3b shapes under faulty, parity-zero and "
        "in-place")
    n = cfg.n_layers
    dec = times["decode"]
    entry = dict(source="src/repro_torch/csrc/kv_write.cu",
                 replaces="src/repro/kernels/throttle.py:35",
                 max_abs_err=0.0, ms=n * dec["ms"],
                 plain_ms=n * dec["plain_ms"],
                 bound_ms=n * dec["bound_ms"], bound_by="bytes",
                 library_ms=None,
                 unfused_route_ms=n * dec["unfused_route_ms"],
                 prefill_layer=times["prefill"],
                 paligemma=dict(
                     {k: pali.n_layers * v for k, v in
                      times["paligemma-3b decode"].items()},
                     launches_per_step=pali.n_layers,
                     prefill_layer=times["paligemma-3b prefill"]))
    log(f"kv_write (per decode step: {n} launches at B 4, in-place; the "
        f"unfused route beside it; library none: no single PyTorch call "
        f"quantizes, encodes and scatters): {entry}")
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


DEPLOY_KERNELS = ("quantize_throttle", "ecc_encode")


def block_hist(torch, positions, keep=None) -> dict:
    """Code blocks with 1, 2 and 3+ flips over the images of
    ``positions`` ({leaf path: flipped bit positions}) whose path ``keep``
    accepts (default: all)."""
    hist = {1: 0, 2: 0, "3+": 0}
    for name, pos in positions.items():
        if keep is not None and not keep(name):
            continue
        _, c = torch.unique(pos // 64, return_counts=True)
        hist[1] += int((c == 1).sum())
        hist[2] += int((c == 2).sum())
        hist["3+"] += int((c >= 3).sum())
    return hist


def phase_full(torch, dev, build, cfg, fname="chip_smoke_serve.json", *,
               ablation=False):
    """Three 16-step runs of ``cfg`` at full width and depth: clean;
    faulted at ``rate`` (corrected and DUE counts against the injected
    single- and double-flip blocks); and faulted at ``rate`` with at most
    one flip per code block, which must give the clean run's logits and
    tokens bit for bit. Logs ms/step, tok/s and the clean run's launches
    per decode step (its deploy's encode launches left out). -> the launch
    counts of the three runs; with ``ablation`` also those of the
    whole-tree decode ablations over the clean run's resident tree
    (:func:`decode_ablation`), counted apart."""
    from repro_torch.launch.serve import serve

    from repro_torch.models import lm
    from repro_torch.protection import policy as policy_mod

    tokens, batch, rate = 16, 4, 1e-6
    kw = dict(backend="cuda", kv_policy="in-place-fused", batch=batch,
              tokens=tokens, device="cuda", log=log)
    torch.cuda.empty_cache()
    build.reset_counts()
    plan = policy_mod.ProtectionPolicy(backend="cuda").plan(
        lm.param_shapes(cfg))
    enc = lm.init_params(cfg, 0, device=dev, leaf_fn=plan.encode_leaf)
    clean = serve(cfg, weights=enc, **kw)
    per_step = {k: v / tokens for k, v in build.COUNTS.items()
                if v and k not in DEPLOY_KERNELS}
    if not ablation:
        del enc
    torch.cuda.empty_cache()
    faulted = serve(cfg, fault_rate=rate, **kw)
    torch.cuda.empty_cache()
    fixed = serve(cfg, fault_rate=rate, correctable_only=True, **kw)
    counts = dict(build.COUNTS)
    log(f"launch counts over the three runs: {counts}")
    ablated = ablation_counts = None
    if ablation:
        build.reset_counts()
        ablated = decode_ablation(torch, dev, cfg, enc)
        ablation_counts = dict(build.COUNTS)
        del enc
        log(f"launch counts over the decode ablations: {ablation_counts}")

    lg = clean["logits"]
    if lg.shape != (tokens, batch, cfg.vocab_padded) or \
            not bool(torch.isfinite(lg.float()).all()):
        fail(f"clean logits: shape {tuple(lg.shape)} or non-finite values")
    if clean["flags"] != {"corrected": 0, "due": 0, "kv_corrected": 0,
                          "kv_due": 0}:
        fail(f"clean run reported faults: {clean['flags']}")

    wh = block_hist(torch, faulted["weight_positions"])
    kh = block_hist(torch, faulted["kv_positions"])
    fl = faulted["flags"]
    log(f"faulted run: weight blocks with 1/2/3+ flips {wh}, KV {kh}; "
        f"reported {fl}")
    if wh["3+"]:
        fail("a weight block took 3+ flips: its accounting is undefined")
    if fl["corrected"] != tokens * wh[1] or fl["due"] != tokens * wh[2]:
        fail(f"weight fault accounting {fl['corrected']}/{fl['due']} != "
             f"{tokens}x injected single/double blocks {wh[1]}/{wh[2]}")

    ch = block_hist(torch, fixed["weight_positions"])
    ckh = block_hist(torch, fixed["kv_positions"])
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
        log(f"{cfg.name} full width {name}: {r['tok_per_s']:.1f} tok/s, "
            f"median {statistics.median(r['step_ms']):.2f} ms/step, first "
            f"step {r['step_ms'][0]:.2f} ms")
    log(f"{cfg.name} decode launches per step (clean run): "
        f"{sum(per_step.values()):.1f} = {per_step}")
    with open(OUT_DIR / fname, "w") as fh:
        json.dump({"config": cfg.name, "launches_per_step": per_step,
                   **{n: {"tok_per_s": r["tok_per_s"],
                          "step_ms": r["step_ms"], "flags": r["flags"]}
                      for n, r in runs},
                   "decode_ablation": ablated}, fh, indent=1)
    return (counts, ablation_counts) if ablation else counts


# ---------------------------------------------------------------------------
# phase 5: the long-context path — prefill + chunked decode, full width
# ---------------------------------------------------------------------------


def phase_long(torch, dev, build, cfg, fname="chip_smoke_long.json"):
    """Two runs of ``cfg`` with a 2,048-token prompt per row plus 16 decode
    steps under ``in-place-chunked``: clean, and with at most one flip per
    weight code block at ``rate`` (the KV pools take correctable flips
    mid-run too). The faulted run must give the clean run's prefill
    logits, decode logits and tokens bit for bit, and count each flipped
    weight block once per call: 1 prefill + 16 steps = 17 times."""
    from repro_torch.launch.serve import serve

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
               "chunked_page_attention": cfg.n_layers * tokens,
               "kv_write": cfg.n_layers * (1 + tokens)}
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
        log(f"{cfg.name} long context {name}: prefill {batch} x "
            f"{prompt_len} tokens in "
            f"{r['prefill_s']:.3f} s ({r['prefill_tok_per_s']:.1f} tok/s); "
            f"decode at context {prompt_len + 1}..{prompt_len + tokens}: "
            f"{r['tok_per_s']:.2f} tok/s, median "
            f"{statistics.median(r['step_ms']):.2f} ms/step")
    with open(OUT_DIR / fname, "w") as fh:
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


def _profile_table(torch, prof, wall_ms, what, fname, rows=18, ranges=(),
                   steps=None):
    """Log the device-busy share of a profiled window (and, over ``steps``
    decode steps, the launches per step) and print its top ops; -> the
    device-side (kernel) events. An operator row's self device time
    repeats its kernels' rows, so only kernel rows are summed; so does the
    device-side row of a ``record_function`` range (its name in
    ``ranges``), which is left out."""
    avg = prof.key_averages()
    kernels = [e for e in avg
               if e.device_type == torch.autograd.DeviceType.CUDA and
               e.key not in ranges]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n = sum(e.count for e in kernels)
    per = f", {n / steps:.1f} per step" if steps else ""
    log(f"profile, {what}: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms "
        f"wall ({100 * busy_ms / wall_ms:.1f}%), {n} kernel launches{per}")
    table = avg.table(sort_by="self_device_time_total", row_limit=25)
    with open(OUT_DIR / fname, "w") as fh:
        fh.write(table)
    for line in table.splitlines()[:rows]:
        print(line, flush=True)
    return kernels


# the device kernels of csrc/ecc_qmatmul.cu, as torch.profiler names them
QMM_KERNELS = ("::tc_kernel<", "::fma_kernel<", "::finish_kernel<")


def _kernel_split(kernels, groups):
    """Device ms of the profiled kernel rows per group, a row counted in
    the first group one of whose name fragments it contains."""
    split = dict.fromkeys(groups, 0.0)
    for e in kernels:
        key = next((k for k, frags in groups.items()
                    if any(f in e.key for f in frags)), None)
        if key is not None:
            split[key] += e.self_device_time_total / 1e3
    return split


def phase_profile(torch):
    """Profile 4 decode steps of the full-width kernel route, built as
    ``serve`` builds it, then 4 more on the unfused KV write route (the
    launches per step of both, counted in this run: the fused write must
    save at least 25 a layer), then one full-width prefill of a 2,048-token
    prompt per row (batch 4, ``in-place-chunked``) with 2 chunked decode
    steps, and 4 more chunked decode steps alone (after the timed runs; the
    launch counts are already read). Prints the device-busy share of each
    profiled window's wall time, the launches per decode step, the ops
    with the most device time, and the prefill's device time split into
    projections, attention, the KV write, decode, and the rest."""
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
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def decode_window(what, fname, first=0):
        """Profile 4 decode steps from position ``first`` -> launches per
        step."""
        nonlocal cache
        tok = torch.zeros((batch, 1), dtype=torch.long, device=dev)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.time()
            for t in range(first, first + 4):
                pos = torch.full((batch,), t, dtype=torch.int32, device=dev)
                logits, cache, _ = step(enc, cache, tok, pos)
                tok = logits.argmax(dim=-1)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.time() - t0)
        kernels = _profile_table(torch, prof, wall_ms, what, fname, steps=4)
        return sum(e.count for e in kernels) / 4

    per_step = decode_window("4 full-width decode steps",
                             "chip_smoke_profile.txt")
    # the same steps with the unfused KV write in place of kv_write,
    # counted in this run: the launches the fused write saves
    real = kvcache._write_kv
    kvcache._write_kv = _unfused_write_kv
    try:
        old = decode_window("4 decode steps on the unfused KV write route",
                            "chip_smoke_profile_unfused_kv.txt", first=4)
    finally:
        kvcache._write_kv = real
    log(f"decode launches per step: {per_step:.1f} with kv_write, {old:.1f} "
        f"on the unfused KV route: {(old - per_step) / cfg.n_layers:.1f} "
        f"fewer per layer")
    if old - per_step < 25 * cfg.n_layers:
        fail(f"the fused KV write saved {old - per_step:.1f} launches per "
             f"decode step, fewer than 25 per layer")
    del cache

    prompt_len = 2048
    kvp = "in-place-chunked"
    prefill = protected.make_prefill(cfg, plan=plan, backend="cuda",
                                     kv_policy=kvp)
    step = protected.make_serve_step(cfg, plan=plan, backend="cuda",
                                     kv_policy=kvp)
    cache = kvcache.init_cache(cfg, batch, prompt_len + 6, kv_policy=kvp,
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
    split = _kernel_split(kernels, {
        "projections (ecc_qmatmul)": QMM_KERNELS,
        "prefill attention (flash_attention)": ("::flash_tc_kernel<",
                                                "::flash_f32_kernel<"),
        "decode attention (chunked_kernel)": ("::chunked_kernel<",),
        "KV write (kv_write_kernel)": ("::kv_write_kernel<",),
        "KV and embedding decode (decode_kernel)": ("::decode_kernel",)})
    split["other"] = sum(e.self_device_time_total for e in kernels) / 1e3 \
        - sum(split.values())
    log("profile split (device ms over the window): " + ", ".join(
        f"{k} {v:.2f}" for k, v in split.items()))
    # launches per long-context decode step: 4 more chunked steps alone
    tok = logits.argmax(dim=-1)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.time()
        for t in range(2, 6):
            pos = torch.full((batch,), prompt_len + t, dtype=torch.int32,
                             device=dev)
            logits, cache, _ = step(enc, cache, tok, pos)
            tok = logits.argmax(dim=-1)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0)
    _profile_table(torch, prof, wall_ms, "4 long-context decode steps "
                   f"(context {prompt_len + 3}..{prompt_len + 6})",
                   "chip_smoke_long_profile.txt", steps=4)


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


def throttle_both_routes(torch, params):
    """The WOT throttle of every protected master on both routes, in place
    on copies: masters, int8 q and scales must be bit-equal, and every
    leaf's q must meet the WOT constraint; the kernel route's masters are
    kept. -> (weights moved, weights throttled, {route: ms})."""
    from repro_torch import tree
    from repro_torch.core import wot
    moved = n_w = 0
    thr_ms = {"cuda": 0.0, "torch": 0.0}
    with torch.no_grad():
        for path, w in tree.leaves_with_path(params):
            if not wot.is_protected_weight(path, w):
                continue
            res = {}
            for route in ("cuda", "torch"):   # in place, on copies of w
                c = w.clone()
                ms, res[route] = event_ms(torch, lambda: wot.throttle_tensor_(
                    c, backend=route, with_q=True))
                thr_ms[route] += ms
            del c
            (kw, kq, ks), (pw, pq, ps) = res["cuda"], res["torch"]
            name = tree.path_str(path)
            same_scale = torch.equal(ks.view(torch.int32),
                                     ps.view(torch.int32))
            same_w = kw.view(torch.int32) == pw.view(torch.int32)
            if not (bool(same_w.all()) and torch.equal(kq, pq) and same_scale):
                fail(f"throttle of {name}: the kernel route differs from the "
                     f"plain route: masters at {int((~same_w).sum())} of "
                     f"{w.numel()}, q at {int((kq != pq).sum())}, scale "
                     f"{float(ks)!r} vs {float(ps)!r}; "
                     f"{int((~torch.isfinite(w)).sum())} non-finite masters")
            if int(wot.count_large_in_protected(kq.reshape(-1))):
                fail(f"{name}: throttled q breaks the WOT constraint")
            moved += int((kw != w).sum())
            n_w += w.numel()
            w.copy_(kw)
            del res, kw, kq, pw, pq
    return moved, n_w, thr_ms


def deploy_both_routes(torch, params):
    """Deploy the masters (quantize-throttle + in-place encode) on both
    routes: every encoded image and scale must be byte-equal. -> the
    kernel route's encoded tree."""
    from repro_torch import tree
    from repro_torch.protection.policy import ProtectionPolicy
    enc = {route: ProtectionPolicy("in-place", backend=route).encode_tree(
        params) for route in ("cuda", "torch")}
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
    log(f"deploy: {n_leaves} encoded images and scales byte-equal on both "
        f"routes")
    return enc["cuda"]


def phase_train(torch, dev, build, cfg, *, batch=8, seq=2048, steps=4,
                serve_tokens=8, rate=1e-6, kv_policy="in-place-fused",
                fname="chip_smoke_train.json"):
    """QAT training with WOT throttling of ``cfg`` through the port's
    ``launch.train.train`` on the kernel route, then deploy and serve.

    ``steps - 1`` throttled steps (the first a warm-up), then a last
    update with ``wot_throttle=False`` whose masters are throttled through
    both routes: masters, int8 q and scales must be bit-equal, and every
    leaf's q must meet the WOT constraint. The trained masters are deployed
    (quantize-throttle + in-place encode) on both routes, byte-equal, and
    ``serve_tokens`` greedy steps at batch 4 under ``kv_policy`` (None: the
    family's dense cache) are served from the deployed weights clean and
    with correctable weight faults only: bit-equal logits and tokens, each
    flipped block counted once per step. Writes ``fname``. -> (launch
    counts over the path, the trained params)."""
    from repro_torch.data import synthetic
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import train
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
    moved, n_w, thr_ms = throttle_both_routes(torch, params)
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

    enc = deploy_both_routes(torch, params)
    kw = dict(backend="cuda", kv_policy=kv_policy, batch=4,
              tokens=serve_tokens, device=dev, weights=enc, log=log)
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
    with open(OUT_DIR / fname, "w") as fh:
        json.dump({"config": f"{cfg.name} n_layers={cfg.n_layers}",
                   "batch": batch, "seq": seq, "losses": losses,
                   "step_ms": step_ms, "median_ms": med,
                   "tokens_per_s": tok_per_step / med * 1e3,
                   "peak_gb": peak_gb, "throttle_ms": thr_ms,
                   "moved": moved, "serve_step_ms": clean["step_ms"],
                   "serve_flags": ff}, fh, indent=1)
    del enc, clean, fixed
    return counts, params


def phase_train_profile(torch, dev, cfg, params, *, batch=8, seq=2048,
                        extras=None, fname="chip_smoke_train_profile.txt"):
    """One more throttled train step under ``torch.profiler``, from the
    trained masters (``extras``: the batch's other inputs, e.g. an encdec
    model's frames): device time split into projections (``aten::mm``),
    attention matmuls (``aten::bmm``), the optimizer, the throttle and the
    forward's fake-quant (the step's ``sgd_momentum``, ``wot_throttle`` and
    ``fake_quant`` ranges), and the rest."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import synthetic
    from repro_torch.training import optim
    from repro_torch.training import train as train_mod
    opt = optim.sgd_init(params)
    step = train_mod.make_train_step(cfg, chunk=2048, backend="cuda")
    b = synthetic.token_batch(cfg.vocab_padded, batch, seq, seed=0, step=9)
    b = {**{k: torch.from_numpy(v).to(dev) for k, v in b.items()},
         **(extras or {})}
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.time()
        step(params, opt, b)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0)
    ranges = ("sgd_momentum", "wot_throttle", "fake_quant")
    kernels = _profile_table(torch, prof, wall_ms,
                             f"one full {cfg.name} train step", fname,
                             ranges=ranges)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    split = {"projections (aten::mm)": 0.0,
             "attention matmuls (aten::bmm)": 0.0,
             "optimizer (sgd_momentum)": 0.0,
             "throttle (wot_throttle)": 0.0,
             "forward fake-quant and bf16 cast (fake_quant)": 0.0}
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
    # the profiler ties a kernel to the aten op that launched it; a ctypes
    # launch has none, so the range's device time misses the
    # quantize_throttle kernels: they are added by name
    split["throttle (wot_throttle)"] += _kernel_split(kernels, {
        "qt": ("::qt_kernel", "::absmax_kernel")})["qt"]
    split["the rest (attention softmax, embedding, loss, backward glue)"] \
        = busy - sum(split.values())
    log("train-step profile split (device ms of "
        f"{busy:.2f} busy): " + ", ".join(f"{k} {v:.2f}"
                                          for k, v in split.items()))
    return {"wall_ms": wall_ms, "busy_ms": busy, **split}


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
                       "chip_smoke_burst_profile.txt",
                       steps=self.last - self.first)


def phase_burst(torch, dev, build):
    """Full-width deepseek-7b cut to BURST_LAYERS layers (bf16) through
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

    cfg = get("deepseek-7b").with_(n_layers=BURST_LAYERS)
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
    the fused matmul (``ecc_qmatmul``'s kernels), its ABFT compare
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
                             ranges=("act_quant",), steps=4)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    split = _kernel_split(kernels, {
        "fused matmul (ecc_qmatmul)": QMM_KERNELS,
        "ABFT compare (abft_compare_kernel)": ("abft_compare_kernel",)})
    split["activation quantization (act_quant)"] = 0.0
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


# ---------------------------------------------------------------------------
# phase 11: the vlm family — paligemma-3b at full width and depth
# ---------------------------------------------------------------------------


def phase_vlm(torch, dev, build):
    """paligemma-3b (18 layers, d_model 2,048, 8 query heads over one KV
    head of 256, a tied 257,216-word head): phase 4's decode triple under
    ``in-place-fused``, phase 5's 4 x 2,048 prefill and chunked decode
    under ``in-place-chunked`` (flash at head_dim 256, the chunked kernel
    at rep 8), two QATT steps over image-patch prefixes, and a profile of
    its decode step. -> the launch counts of the three runs."""
    from repro_torch.configs import get
    cfg = get("paligemma-3b")
    c1 = phase_full(torch, dev, build, cfg, "chip_smoke_vlm.json")
    c2 = phase_long(torch, dev, build, cfg, "chip_smoke_vlm_long.json")
    c3 = phase_vlm_train(torch, dev, build, cfg)
    profile_vlm_decode(torch, dev, cfg)
    return {k: c1[k] + c2[k] + c3[k] for k in build.COUNTS}


def phase_vlm_train(torch, dev, build, cfg, *, batch=2, seq=512, lr=1e-4):
    """Two QATT steps of full-width, full-depth ``cfg`` (a vlm) at batch
    ``batch`` x (n_patches patch embeddings + ``seq`` tokens), one
    microbatch. The patches are drawn like the embedding table (std 0.02,
    seeded): all-zero patches, the reference CLI's stub, give NaN
    gradients at 18 layers in the reference as in the port (see
    ``launch.train.train``). The first step runs through
    ``launch.train.train`` on the kernel
    route, the second an update without the throttle whose masters are
    then throttled on both routes (bit-equal, the WOT constraint on every
    leaf). The losses must be finite. 2.5 G f32 masters, their momentum
    and one set of gradients take 30 GB; the f32 logits of the 2 x 512
    text positions over 257,280 words 1.05 GB. -> launch counts."""
    from repro_torch.data import synthetic
    from repro_torch.launch.train import train
    from repro_torch.training import train as train_mod

    cfg = cfg.with_(microbatch=1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    patches = (0.02 * torch.randn((batch, cfg.n_patches, cfg.d_model),
                                  generator=gen, device=dev)).to(
        torch.bfloat16)
    build.reset_counts()
    out = train(cfg, steps=1, batch=batch, seq=seq, lr=lr, seed=0,
                chunk=2048, backend="cuda", device=dev,
                prefix_embeds=patches, log=log)
    params, opt = out["params"], out["opt_state"]
    losses, step_ms = list(out["losses"]), list(out["step_ms"])
    b = synthetic.token_batch(cfg.vocab_padded, batch, seq, seed=0, step=1)
    b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    b["prefix_embeds"] = patches
    step = train_mod.make_train_step(cfg, lr=lr, wot_throttle=False,
                                     chunk=2048, backend="cuda")
    torch.cuda.synchronize()
    upd_ms, (params, opt, loss) = event_ms(torch,
                                           lambda: step(params, opt, b))
    losses.append(float(loss))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in losses):
        fail(f"{cfg.name} QATT losses not finite: {losses}")
    moved, n_w, thr_ms = throttle_both_routes(torch, params)
    counts = dict(build.COUNTS)
    step_ms.append(upd_ms + thr_ms["cuda"])
    log(f"QATT {cfg.name} x {cfg.n_layers} layers, batch {batch} x "
        f"({cfg.n_patches} patches + {seq} tokens): losses {losses}; ms/step "
        f"{[round(x, 2) for x in step_ms]} (the second: update "
        f"{upd_ms:.2f} + kernel-route throttle {thr_ms['cuda']:.2f}); peak "
        f"device memory {peak_gb:.2f} GB")
    log(f"{cfg.name} throttle: masters, q and scales bit-equal on both "
        f"routes; {moved} of {n_w} weights moved; WOT constraint holds on "
        f"every protected leaf; kernel route {thr_ms['cuda']:.2f} ms, plain "
        f"route {thr_ms['torch']:.2f} ms")
    log(f"launch counts over the {cfg.name} QATT steps: {counts}")
    with open(OUT_DIR / "chip_smoke_vlm_train.json", "w") as fh:
        json.dump({"config": cfg.name, "batch": batch,
                   "patches": cfg.n_patches, "seq": seq, "losses": losses,
                   "step_ms": step_ms, "peak_gb": peak_gb,
                   "throttle_ms": thr_ms, "moved": moved}, fh, indent=1)
    del params, opt, out, step, b
    torch.cuda.empty_cache()
    return counts


def profile_vlm_decode(torch, dev, cfg, batch=4):
    """Profile 4 decode steps of ``cfg`` (a tied head) on the kernel route
    under ``in-place-fused``, after one step unprofiled, and split the
    device time into the projections (ecc_qmatmul), the decode attention
    (strip kernel), the KV write, the embedding's decode (its
    ``decode_kernel`` and the ``embed_decode`` range's dequantization),
    the tied head (``aten::mm``: bf16 x over the decoded embedding
    transposed) and the rest."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import lm
    from repro_torch.protection import policy as policy_mod
    from repro_torch.serving import kvcache, protected

    torch.cuda.empty_cache()
    plan = policy_mod.ProtectionPolicy(backend="cuda").plan(
        lm.param_shapes(cfg))
    enc = lm.init_params(cfg, 0, device=dev, leaf_fn=plan.encode_leaf)
    step = protected.make_serve_step(cfg, plan=plan, backend="cuda",
                                     kv_policy="in-place-fused")
    cache = kvcache.init_cache(cfg, batch, 64, kv_policy="in-place-fused",
                               device=dev)
    tok = torch.zeros((batch, 1), dtype=torch.long, device=dev)

    def run(t0, t1):
        nonlocal cache, tok
        for t in range(t0, t1):
            pos = torch.full((batch,), t, dtype=torch.int32, device=dev)
            logits, cache, _ = step(enc, cache, tok, pos)
            tok = logits.argmax(dim=-1)

    run(0, 1)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.time()
        run(1, 5)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0)
    kernels = _profile_table(torch, prof, wall_ms,
                             f"4 full-width {cfg.name} decode steps",
                             "chip_smoke_vlm_profile.txt",
                             ranges=("embed_decode",), steps=4)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    split = _kernel_split(kernels, {
        "projections (ecc_qmatmul)": QMM_KERNELS,
        "decode attention (strip_kernel)": ("::strip_kernel",),
        "KV write (kv_write_kernel)": ("::kv_write_kernel<",),
        "embedding decode (decode_kernel)": ("::decode_kernel",)})
    split["embedding dequantization (embed_decode)"] = 0.0
    split["tied head (aten::mm)"] = 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        if e.name == "embed_decode":
            split["embedding dequantization (embed_decode)"] += \
                e.device_time_total / 1e3
        elif e.name == "aten::mm":
            split["tied head (aten::mm)"] += e.self_device_time_total / 1e3
    split["the rest (norms, rope, argmax, glue)"] = busy - sum(split.values())
    log(f"{cfg.name} decode profile split (device ms over 4 steps, "
        f"{busy:.2f} busy of {wall_ms:.2f} wall): " + ", ".join(
            f"{k} {v:.2f}" for k, v in split.items()))
    del enc, cache



# ---------------------------------------------------------------------------
# phase 12: the encdec family — whisper-base at full width and depth
# ---------------------------------------------------------------------------

# the decoder's text context in the forward and QATT runs: Whisper's 448
# tokens (arXiv:2212.04356)
WHISPER_TEXT_CTX = 448


def decode_reads(path: str) -> bool:
    """Whether a decode step on a dense cache reads the leaf at ``path``:
    not whisper's encoder images (the encoder runs only in the cache-less
    forward and in training) and not its decoder's cross ``wk`` and ``wv``
    (the step reads cross K and V from the cache); every other leaf, which
    is every leaf of recurrentgemma-2b (its tail, conv kernels and both
    gates included)."""
    return not (path.startswith("enc_layers/")
                or path in ("layers/cross/wk", "layers/cross/wv"))


def phase_encdec(torch, dev, build):
    """whisper-base (6 encoder and 6 decoder layers, d_model 512, 8 heads
    of 64, a 51,968-word head) at full width and depth on its dense KV
    cache: the decode triple (:func:`dense_cache_decode_triple`), the
    decode over encoder-filled cross caches on both routes
    (:func:`encdec_cross`), the cache-less forward over frames
    (:func:`encdec_forward`), the QATT steps with deploy and serve
    (:func:`encdec_train`), then a profile of its decode step. -> the
    launch counts of the four runs."""
    from repro_torch.configs import get
    cfg = get("whisper-base")
    torch.cuda.empty_cache()
    build.reset_counts()
    clean = dense_cache_decode_triple(torch, dev, build, cfg)
    encdec_cross(torch, dev, cfg, clean["logits"][0])
    del clean
    encdec_forward(torch, dev, build, cfg)
    encdec_train(torch, dev, cfg)
    counts = dict(build.COUNTS)
    log(f"launch counts over the whisper-base path: {counts}")
    profile_encdec_decode(torch, dev, cfg)
    return counts


def dense_cache_decode_triple(torch, dev, build, cfg, *, tokens=16, batch=4,
                              rate=2e-5):
    """Phase 4's three 16-step runs through ``serve`` on a family's dense
    cache (``kv_policy=None``; whisper-base's, recurrentgemma-2b's ring):
    clean; faulted at ``rate``, its corrected and DUE counts equal to
    ``tokens`` x the injected single- and double-flip blocks of the leaves
    a decode step reads (:func:`decode_reads`; the rate must give double
    flips at the model's size); and correctable-only, bit-equal to the
    clean run. Writes ``chip_smoke_<cfg.name>.json``. -> the clean run,
    with the clean run's launches per step under ``"launches_per_step"``
    (every count since the last ``build.reset_counts()`` but the deploy's
    kernels, over ``tokens``)."""
    from repro_torch.launch.serve import serve

    kw = dict(backend="cuda", kv_policy=None, batch=batch, tokens=tokens,
              device=dev, log=log)
    clean = serve(cfg, **kw)
    per_step = {k: v / tokens for k, v in build.COUNTS.items()
                if v and k not in DEPLOY_KERNELS}
    faulted = serve(cfg, fault_rate=rate, **kw)
    fixed = serve(cfg, fault_rate=rate, correctable_only=True, **kw)
    lg = clean["logits"]
    if lg.shape != (tokens, batch, cfg.vocab_padded) or \
            not bool(torch.isfinite(lg.float()).all()):
        fail(f"{cfg.name} clean logits: shape {tuple(lg.shape)} or "
             f"non-finite values")
    if clean["flags"] != {"corrected": 0, "due": 0, "kv_corrected": 0,
                          "kv_due": 0}:
        fail(f"{cfg.name} clean run reported faults: {clean['flags']}")
    wh = block_hist(torch, faulted["weight_positions"], decode_reads)
    unread = block_hist(torch, faulted["weight_positions"],
                        lambda p: not decode_reads(p))
    fl = faulted["flags"]
    log(f"{cfg.name} faulted run: blocks with 1/2/3+ flips in the leaves "
        f"a decode step reads {wh}, in the leaves it does not read "
        f"{unread}; reported {fl}")
    if wh["3+"]:
        fail("a read weight block took 3+ flips: its accounting is "
             "undefined")
    if wh[2] == 0 or fl["corrected"] != tokens * wh[1] or \
            fl["due"] != tokens * wh[2]:
        fail(f"{cfg.name} fault accounting {fl['corrected']}/{fl['due']} != "
             f"{tokens} x the read single/double blocks {wh[1]}/{wh[2]} "
             f"(or no double-flip block was injected)")
    ch = block_hist(torch, fixed["weight_positions"], decode_reads)
    ff = fixed["flags"]
    if ch[1] == 0 or ch[2] or ch["3+"] or ff["due"] or \
            ff["corrected"] != tokens * ch[1]:
        fail(f"{cfg.name} correctable-only accounting {ff} != {tokens} x "
             f"{ch[1]} read single-flip blocks and no DUE")
    if not (torch.equal(fixed["logits"], clean["logits"])
            and torch.equal(fixed["tokens"], clean["tokens"])):
        fail(f"{cfg.name}: every flip was correctable, yet the logits "
             f"differ from the clean run")
    log(f"{cfg.name} correctable-only run ({ch[1]} read single-flip "
        f"blocks): logits and tokens equal the clean run bit for bit")
    runs = (("clean", clean), ("faulted", faulted),
            ("correctable-only", fixed))
    for name, r in runs:
        log(f"{cfg.name} full width {name}: {r['tok_per_s']:.1f} tok/s, "
            f"median {statistics.median(r['step_ms']):.2f} ms/step, first "
            f"step {r['step_ms'][0]:.2f} ms")
    log(f"{cfg.name} decode launches per step (clean run): "
        f"{sum(per_step.values()):.1f} = {per_step}")
    with open(OUT_DIR / f"chip_smoke_{cfg.name}.json", "w") as fh:
        json.dump({"config": cfg.name, "launches_per_step": per_step,
                   **{n: {"tok_per_s": r["tok_per_s"],
                          "step_ms": r["step_ms"], "flags": r["flags"]}
                      for n, r in runs}}, fh, indent=1)
    clean["launches_per_step"] = per_step
    return clean


def encoder_cross_kv(torch, cfg, enc, frames, route):
    """Cross caches filled from the encoder: every encoder leaf and the
    decoder's cross ``wk`` and ``wv`` decoded on ``route``, ``lm._encode``
    over ``frames`` (B, enc_seq, d_model), then ``layers.cross_kv`` per
    decoder layer -> (cross_k, cross_v), each (L, B, enc_seq, H, hd)
    bf16."""
    from repro_torch import tree
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.protection.policy import decode_leaf_with_flags
    from repro_torch.protection.tensor import is_protected_tensor

    def dense(sub):
        return tree.map_with_path(
            lambda _, t: decode_leaf_with_flags(t, torch.bfloat16,
                                                backend=route)[0]
            if is_protected_tensor(t) else t, sub)

    params = {"enc_layers": dense(enc["enc_layers"]),
              "enc_final_norm": enc["enc_final_norm"]}
    cross = dense(enc["layers"]["cross"])
    with torch.no_grad():
        enc_out = lm._encode(cfg, params, frames, dtype=torch.bfloat16)[0]
        kv = [L.cross_kv(lm._take(i, cross), enc_out, cfg)
              for i in range(cfg.n_layers)]
    return (torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv]))


def encdec_cross(torch, dev, cfg, zero_first, *, tokens=16, batch=4):
    """16 serve steps over cross caches filled from the encoder on
    ``batch`` x 1,500 frames of the reference CLI's draw
    (``np.random.default_rng(0)``, std 1), the kernel route against the
    plain route in lockstep (the kernel route's greedy tokens fed to
    both): the caches bit-equal, flags equal, logits within
    E2E_MAX_ATOL / E2E_MEAN_ATOL. The first step's logits must move from
    ``zero_first``, those of the same weights and tokens over zero cross
    caches (where cross-attention adds exactly 0)."""
    from repro_torch.launch.train import reference_frames
    from repro_torch.models import lm
    from repro_torch.protection import policy as policy_mod
    from repro_torch.serving import kvcache, protected

    plan = policy_mod.ProtectionPolicy(backend="cuda").plan(
        lm.param_shapes(cfg))
    enc = lm.init_params(cfg, 0, device=dev, leaf_fn=plan.encode_leaf)
    frames = reference_frames(cfg, batch, dev)
    caches, steps = {}, {}
    for route in ("cuda", "torch"):
        caches[route] = kvcache.init_cache(cfg, batch, 64, device=dev)
        ck, cv = encoder_cross_kv(torch, cfg, enc, frames, route)
        caches[route]["cross_k"].copy_(ck)
        caches[route]["cross_v"].copy_(cv)
        steps[route] = protected.make_serve_step(cfg, backend=route)
    del ck, cv
    for name in ("cross_k", "cross_v"):
        a, b = caches["cuda"][name], caches["torch"][name]
        if not torch.equal(a, b) or not bool(torch.isfinite(a.float()).all()):
            fail(f"{cfg.name} {name} from the encoder differs between the "
                 f"routes or is not finite")
    log(f"{cfg.name} cross caches from the encoder over {batch} x "
        f"{cfg.enc_seq} frames: bit-equal on both routes, |cross_k| max "
        f"{float(caches['cuda']['cross_k'].abs().max()):.3g}, |cross_v| max "
        f"{float(caches['cuda']['cross_v'].abs().max()):.3g}")
    tok = torch.zeros((batch, 1), dtype=torch.long, device=dev)
    logits = {"cuda": [], "torch": []}
    for t in range(tokens):
        pos = torch.full((batch,), t, dtype=torch.int32, device=dev)
        res = {r: steps[r](enc, caches[r], tok, pos) for r in steps}
        fk, fp = ({k: v.tolist() for k, v in res[r][2].items()}
                  for r in ("cuda", "torch"))
        if fk != fp or any(x for row in fk.values() for x in
                           torch.tensor(row).reshape(-1).tolist()):
            fail(f"{cfg.name} step {t} flags: cuda {fk} vs torch {fp} "
                 f"(clean weights: all zero)")
        for r in steps:
            logits[r].append(res[r][0][:, 0].float())
        tok = res["cuda"][0].argmax(dim=-1)
    lk, lp = torch.stack(logits["cuda"]), torch.stack(logits["torch"])
    diff = (lk - lp).abs()
    moved = float((lk[0] - zero_first.float()).abs().max())
    log(f"{cfg.name} {tokens} steps over encoder-filled cross caches, cuda "
        f"vs torch route in lockstep: logits max abs diff "
        f"{float(diff.max()):.4g}, mean {float(diff.mean()):.4g} (|logits| "
        f"max {float(lp.abs().max()):.3g}); the first step moved by up to "
        f"{moved:.3g} from the zero-cache run's")
    if not bool(torch.isfinite(lk).all()) or \
            float(diff.max()) > E2E_MAX_ATOL or \
            float(diff.mean()) > E2E_MEAN_ATOL:
        fail(f"{cfg.name}: kernel route logits over the encoder-filled "
             f"cross caches out of tolerance of the plain route")
    if moved < 0.05:
        fail(f"{cfg.name}: the encoder-filled cross caches left the logits "
             f"where zero caches put them")


def encdec_forward(torch, dev, build, cfg, *, batch=8, rate=1e-6):
    """The cache-less decode-at-use forward (``protected.make_prefill``
    without a KV policy, frames as its ``extras``) over ``batch`` x 1,500
    frames and ``batch`` x 448 seeded tokens: every image decodes at use
    once, the encoder's too, and the decoder's causal self-attention runs
    through flash at head_dim 64 on the kernel route. Both routes: flags
    all zero (rows top, layers, enc_layers), logits within
    E2E_MAX_ATOL / E2E_MEAN_ATOL. Then the kernel route with correctable
    flips at ``rate``: logits bit-equal, and each row counts exactly the
    flipped blocks of its images (top: embed and head)."""
    from repro_torch.launch.train import reference_frames
    from repro_torch.models import lm
    from repro_torch.protection import policy as policy_mod
    from repro_torch.serving import protected

    plan = policy_mod.ProtectionPolicy(backend="cuda").plan(
        lm.param_shapes(cfg))
    enc = lm.init_params(cfg, 0, device=dev, leaf_fn=plan.encode_leaf)
    extras = {"enc_embeds": reference_frames(cfg, batch, dev)}
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    prompt = torch.randint(0, cfg.vocab, (batch, WHISPER_TEXT_CTX),
                           generator=gen, device=dev)
    out, ms, again = {}, {}, {}
    for route in ("cuda", "torch"):
        prefill = protected.make_prefill(cfg, backend=route, with_flags=True)
        before = build.COUNTS["flash_attention"]
        torch.cuda.synchronize()
        t0 = time.time()
        out[route] = prefill(enc, prompt, extras)
        torch.cuda.synchronize()
        ms[route] = 1e3 * (time.time() - t0)
        launched = build.COUNTS["flash_attention"] - before
        if launched != (cfg.n_layers if route == "cuda" else 0):
            fail(f"{cfg.name} forward on the {route} route launched flash "
                 f"{launched} times")
        again[route] = event_ms(torch, lambda: prefill(enc, prompt,
                                                       extras))[0]
    (lk, fk), (lp, fp) = out["cuda"], out["torch"]
    for r, fl in (("cuda", fk), ("torch", fp)):
        if sorted(fl) != ["enc_layers", "layers", "top"] or \
                any(int(v.abs().sum()) for v in fl.values()):
            fail(f"{cfg.name} clean forward flags on the {r} route: "
                 f"{ {k: v.tolist() for k, v in fl.items()} }")
    if lk.shape != (batch, WHISPER_TEXT_CTX, cfg.vocab_padded) or \
            not bool(torch.isfinite(lk.float()).all()):
        fail(f"{cfg.name} forward logits {tuple(lk.shape)} or not finite")
    diff = (lk.float() - lp.float()).abs()
    log(f"{cfg.name} forward over {batch} x ({cfg.enc_seq} frames + "
        f"{WHISPER_TEXT_CTX} tokens), cuda vs torch route: logits max abs "
        f"diff {float(diff.max()):.4g}, mean {float(diff.mean()):.4g}; "
        f"{ms['cuda']:.1f} ms on the kernel route, {ms['torch']:.1f} ms on "
        f"the plain route (host clock, first call); a second call "
        f"{again['cuda']:.1f} and {again['torch']:.1f} ms (CUDA events)")
    if float(diff.max()) > E2E_MAX_ATOL or float(diff.mean()) > E2E_MEAN_ATOL:
        fail(f"{cfg.name}: kernel route forward logits out of tolerance of "
             f"the plain route")
    del out, lp, fp, diff
    gen.manual_seed(13)
    fenc, positions = policy_mod.inject_tree_device(enc, rate, gen,
                                                    one_per_block=True)
    lf, ff = protected.make_prefill(cfg, backend="cuda", with_flags=True)(
        fenc, prompt, extras)
    rows = {"top": lambda p: p in ("embed", "head"),
            "layers": lambda p: p.startswith("layers/"),
            "enc_layers": lambda p: p.startswith("enc_layers/")}
    want = {k: block_hist(torch, positions, keep) for k, keep in rows.items()}
    got = {k: v.reshape(-1, 2).sum(0).tolist() for k, v in ff.items()}
    log(f"{cfg.name} forward with correctable flips: single-flip blocks per "
        f"row {({k: h[1] for k, h in want.items()})}, reported {got}")
    if any(h[2] or h["3+"] for h in want.values()) or \
            any(got[k] != [want[k][1], 0] for k in rows) or \
            want["enc_layers"][1] == 0:
        fail(f"{cfg.name} forward accounting {got} != the flipped blocks "
             f"of each row's images")
    if not torch.equal(lf, lk):
        fail(f"{cfg.name}: every flip was correctable, yet the forward's "
             f"logits differ from the clean run")
    log(f"{cfg.name} forward with correctable flips: logits equal the clean "
        f"run bit for bit; the encoder's flips counted in its own row")
    with open(OUT_DIR / "chip_smoke_whisper_forward.json", "w") as fh:
        json.dump({"config": cfg.name, "batch": batch,
                   "frames": cfg.enc_seq, "tokens": WHISPER_TEXT_CTX,
                   "first_call_ms": ms, "second_call_ms": again,
                   "faulted_flags": got}, fh, indent=1)


def encdec_train(torch, dev, cfg, *, batch=8, steps=3, lr=1e-4,
                 serve_tokens=8, rate=1e-6):
    """QATT of full-width, full-depth whisper-base through
    ``launch.train.train`` on the kernel route: ``steps - 1`` throttled
    steps at ``batch`` x (1,500 frames of the reference CLI's draw + 448
    tokens) in the config's 4 microbatches, then an update without the
    throttle whose masters are throttled on both routes (bit-equal, the
    WOT constraint on every leaf); finite losses. The trained masters are
    deployed on both routes (byte-equal) and served ``serve_tokens``
    greedy steps at batch 4 on the dense cache, clean and with
    correctable flips only: bit-equal, each read flipped block counted
    once per step. One more step from the trained masters is profiled
    (:func:`phase_train_profile`)."""
    from repro_torch.data import synthetic
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import reference_frames, train
    from repro_torch.training import train as train_mod

    seq = WHISPER_TEXT_CTX
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = train(cfg, steps=steps - 1, batch=batch, seq=seq, lr=lr, seed=0,
                chunk=2048, backend="cuda", device=dev, log=log)
    params, opt = out["params"], out["opt_state"]
    losses, step_ms = list(out["losses"]), list(out["step_ms"])
    b = synthetic.token_batch(cfg.vocab_padded, batch, seq, seed=0,
                              step=steps - 1)
    b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    b["enc_embeds"] = reference_frames(cfg, batch, dev)
    step = train_mod.make_train_step(cfg, lr=lr, wot_throttle=False,
                                     chunk=2048, backend="cuda")
    torch.cuda.synchronize()
    upd_ms, (params, opt, loss) = event_ms(torch,
                                           lambda: step(params, opt, b))
    losses.append(float(loss))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in losses):
        fail(f"{cfg.name} QATT losses not finite: {losses}")
    moved, n_w, thr_ms = throttle_both_routes(torch, params)
    step_ms.append(upd_ms + thr_ms["cuda"])
    med = statistics.median(step_ms[1:])
    rows = batch * (cfg.enc_seq + seq)
    log(f"QATT {cfg.name}, batch {batch} x ({cfg.enc_seq} frames + {seq} "
        f"tokens), {cfg.microbatch} microbatches: losses {losses}; ms/step "
        f"{[round(x, 2) for x in step_ms]} (the last: update {upd_ms:.2f} + "
        f"kernel-route throttle {thr_ms['cuda']:.2f}); median of steps "
        f"2..{steps} {med:.2f} ms/step, {batch * seq / med * 1e3:.1f} text "
        f"tokens/s ({rows / med * 1e3:.1f} frames + tokens/s); peak device "
        f"memory {peak_gb:.2f} GB")
    log(f"{cfg.name} throttle: masters, q and scales bit-equal on both "
        f"routes; {moved} of {n_w} weights moved; WOT constraint holds on "
        f"every protected leaf; kernel route {thr_ms['cuda']:.2f} ms, plain "
        f"route {thr_ms['torch']:.2f} ms")
    del opt, step, b, out
    enc = deploy_both_routes(torch, params)
    phase_train_profile(torch, dev, cfg, params, batch=batch, seq=seq,
                        extras={"enc_embeds": reference_frames(cfg, batch,
                                                               dev)},
                        fname="chip_smoke_whisper_train_profile.txt")
    del params
    kw = dict(backend="cuda", kv_policy=None, batch=4, tokens=serve_tokens,
              device=dev, weights=enc, log=log)
    clean = serve(cfg, **kw)
    fixed = serve(cfg, fault_rate=rate, correctable_only=True, **kw)
    lg = clean["logits"]
    if lg.shape != (serve_tokens, 4, cfg.vocab_padded) or \
            not bool(torch.isfinite(lg.float()).all()) or \
            clean["flags"] != {"corrected": 0, "due": 0, "kv_corrected": 0,
                               "kv_due": 0}:
        fail(f"{cfg.name} served trained logits {tuple(lg.shape)} not "
             f"finite, or faults reported: {clean['flags']}")
    ch = block_hist(torch, fixed["weight_positions"], decode_reads)
    ff = fixed["flags"]
    if ch[1] == 0 or ch[2] or ch["3+"] or ff["due"] or \
            ff["corrected"] != serve_tokens * ch[1]:
        fail(f"{cfg.name} trained-weight serve accounting {ff} != "
             f"{serve_tokens} x {ch[1]} read single-flip blocks, no DUE")
    if not (torch.equal(fixed["logits"], clean["logits"])
            and torch.equal(fixed["tokens"], clean["tokens"])):
        fail(f"{cfg.name}: every flip was correctable, yet the served "
             f"trained logits differ from the clean run")
    log(f"served the trained {cfg.name}: {serve_tokens} steps x batch 4, "
        f"clean and correctable-only ({ch[1]} read flipped blocks, {ff}) "
        f"bit-equal; {statistics.median(clean['step_ms']):.2f} ms/step clean")
    with open(OUT_DIR / "chip_smoke_whisper_train.json", "w") as fh:
        json.dump({"config": cfg.name, "batch": batch,
                   "frames": cfg.enc_seq, "seq": seq, "losses": losses,
                   "step_ms": step_ms, "median_ms": med, "peak_gb": peak_gb,
                   "throttle_ms": thr_ms, "moved": moved,
                   "serve_step_ms": clean["step_ms"], "serve_flags": ff},
                  fh, indent=1)
    del enc, clean, fixed
    torch.cuda.empty_cache()


def profile_encdec_decode(torch, dev, cfg, batch=4):
    """Profile 4 decode steps of whisper-base on the kernel route (dense
    KV), after one step unprofiled: launches per step, the device-busy
    share, and the device time split into the projections
    (ecc_qmatmul), the embedding's decode (its ``decode_kernel`` and the
    ``embed_decode`` range's dequantization), the attention matmuls
    (``aten::bmm``: self-attention over the dense cache, cross-attention
    over 1,500 frames) and the rest."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import lm
    from repro_torch.protection import policy as policy_mod
    from repro_torch.serving import kvcache, protected

    torch.cuda.empty_cache()
    plan = policy_mod.ProtectionPolicy(backend="cuda").plan(
        lm.param_shapes(cfg))
    enc = lm.init_params(cfg, 0, device=dev, leaf_fn=plan.encode_leaf)
    step = protected.make_serve_step(cfg, plan=plan, backend="cuda")
    cache = kvcache.init_cache(cfg, batch, 64, device=dev)
    tok = torch.zeros((batch, 1), dtype=torch.long, device=dev)

    def run(t0, t1):
        nonlocal cache, tok
        for t in range(t0, t1):
            pos = torch.full((batch,), t, dtype=torch.int32, device=dev)
            logits, cache, _ = step(enc, cache, tok, pos)
            tok = logits.argmax(dim=-1)

    run(0, 1)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.time()
        run(1, 5)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0)
    kernels = _profile_table(torch, prof, wall_ms,
                             f"4 full-width {cfg.name} decode steps",
                             "chip_smoke_whisper_profile.txt",
                             ranges=("embed_decode",), steps=4)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    split = _kernel_split(kernels, {
        "projections (ecc_qmatmul)": QMM_KERNELS,
        "embedding decode (decode_kernel)": ("::decode_kernel",)})
    split["embedding dequantization (embed_decode)"] = 0.0
    split["attention matmuls (aten::bmm)"] = 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        if e.name == "embed_decode":
            split["embedding dequantization (embed_decode)"] += \
                e.device_time_total / 1e3
        elif e.name == "aten::bmm":
            split["attention matmuls (aten::bmm)"] += \
                e.self_device_time_total / 1e3
    split["the rest (norms, GELU, softmax, rope, argmax, glue)"] = \
        busy - sum(split.values())
    log(f"{cfg.name} decode profile split (device ms over 4 steps, "
        f"{busy:.2f} busy of {wall_ms:.2f} wall): " + ", ".join(
            f"{k} {v:.2f}" for k, v in split.items()))
    del enc, cache

# ---------------------------------------------------------------------------
# phase 13: the hybrid family — recurrentgemma-2b at full width and depth
# ---------------------------------------------------------------------------

# the serve step's positions across the ring wrap: 8 steps before the
# window's 2,048 slots fill and 8 after
RING_START = 2040
# the cache-less forward's lengths: past the window (flash windowed) and
# at it (the window covers the sequence and is dropped)
HYBRID_FORWARD_S = (4096, 2048)


def phase_hybrid(torch, dev, build):
    """recurrentgemma-2b (26 layers: 8 super-blocks of [RG-LRU, RG-LRU,
    local attention] and 2 tail RG-LRU layers; d_model 2,560, 10 query
    heads over one KV head of 256, a tied 256,000-word embedding) at full
    width and depth, no cut, on its dense cache (the RG-LRU states and a
    ring of 2,048 K/V slots): the decode triple through ``serve``
    (:func:`dense_cache_decode_triple`: every leaf is read by a decode
    step, the tail, the conv kernels and both gates included), whose clean
    run must launch ``ecc_decode`` exactly 1 + 2 x 18 + 18 times a step
    (the embedding, both gates and the conv kernel of each of the 18
    RG-LRU layers); 16 steps across the ring wrap on both routes in
    lockstep (:func:`hybrid_ring`), the cache-less forward past and at the
    window on both routes (:func:`hybrid_forward`), then a profile of its
    decode step; guarded steps (:func:`guarded_routes`, counted apart).
    -> (the launch counts of the path, those of the guarded steps, flash's
    launches in one kernel-route forward past the window)."""
    from repro_torch.configs import get
    from repro_torch.models import lm
    from repro_torch.protection import policy as policy_mod
    cfg = get("recurrentgemma-2b")
    torch.cuda.empty_cache()
    build.reset_counts()
    clean = dense_cache_decode_triple(torch, dev, build, cfg, rate=3e-6)
    per_step = clean["launches_per_step"]
    del clean
    n_rglru = 2 * lm.n_scan_layers(cfg) + lm.hybrid_tail_layers(cfg)
    if per_step.get("ecc_decode") != 1 + 3 * n_rglru:
        fail(f"{cfg.name} decode step: {per_step.get('ecc_decode')} "
             f"ecc_decode launches a step, not 1 embedding + {2 * n_rglru} "
             f"gate + {n_rglru} conv-kernel decodes")
    plan = policy_mod.ProtectionPolicy(backend="cuda").plan(
        lm.param_shapes(cfg))
    t0 = time.time()
    enc = lm.init_params(cfg, 0, device=dev, leaf_fn=plan.encode_leaf)
    torch.cuda.synchronize()
    leaves = _protected(enc)
    nbytes = sum(t.enc.numel() for t in leaves)
    log(f"{cfg.name}: drew and encoded {len(leaves)} protected "
        f"leaves ({nbytes / 1e9:.3f} GB of image, "
        f"{lm.n_scan_layers(cfg)} super-blocks + "
        f"{lm.hybrid_tail_layers(cfg)} tail layers) in "
        f"{time.time() - t0:.1f}s")
    hybrid_ring(torch, dev, cfg, enc)
    report = hybrid_forward(torch, dev, build, cfg, enc)
    guarded, guarded_counts = counted_apart(build, guarded_routes, torch,
                                            dev, cfg, enc)
    if "tail_abft" not in guarded["rows"]:
        fail(f"(b) {cfg.name}: the guarded decode has no tail_abft row")
    with open(OUT_DIR / "chip_smoke_hybrid_guarded.json", "w") as fh:
        json.dump(guarded, fh, indent=1)
    counts = dict(build.COUNTS)
    log(f"launch counts over the recurrentgemma-2b path: {counts}")
    profile_hybrid_decode(torch, dev, cfg, plan, enc)
    del enc
    torch.cuda.empty_cache()
    windowed = [r for r in report.values() if r["window"]]
    return counts, guarded_counts, windowed[0]["flash_launches"]


def _protected(enc) -> list:
    from repro_torch import tree
    from repro_torch.protection.tensor import is_protected_tensor
    return [t for _, t in tree.leaves_with_path(enc)
            if is_protected_tensor(t)]


def hybrid_ring(torch, dev, cfg, enc, *, tokens=16, batch=4):
    """16 serve steps at positions RING_START .. RING_START + 15 over a
    cache seeded with random K/V in every ring slot (std 1) and random
    RG-LRU states and conv histories (std 0.5 and 1), so the ring wraps
    at position 2,048 halfway: the kernel route against the plain route
    in lockstep (the kernel route's greedy tokens fed to both), flags
    equal and zero, logits held by :func:`route_distances` (within
    HYBRID_MAX_ATOL / HYBRID_MEAN_ATOL of each other, and against the
    plain route in f32 over the same cache upcast, fed the same tokens).
    Each bf16 route's step writes slot ``pos % 2,048`` of every layer's
    ring and no other."""
    from repro_torch.serving import kvcache, protected

    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    base = kvcache.init_cache(cfg, batch, RING_START + tokens, device=dev)
    for name, t in base.items():
        std = 0.5 if name.endswith("_h") else 1.0
        t.copy_(torch.randn(t.shape, generator=gen, device=dev) * std)
    caches = {r: {k: v.clone() for k, v in base.items()}
              for r in ("cuda", "torch")}
    caches["f32"] = {k: v.float() for k, v in base.items()}
    steps = {r: protected.make_serve_step(cfg, backend=r)
             for r in ("cuda", "torch")}
    steps["f32"] = protected.make_serve_step(cfg, backend="torch",
                                             dtype=torch.float32)
    tok = torch.randint(0, cfg.vocab, (batch, 1), generator=gen, device=dev)
    logits = {r: [] for r in steps}
    for t in range(tokens):
        pos = torch.full((batch,), RING_START + t, dtype=torch.int32,
                         device=dev)
        res = {r: steps[r](enc, caches[r], tok, pos) for r in steps}
        fk, fp, ff = ({k: v.tolist() for k, v in res[r][2].items()}
                      for r in steps)
        if fk != fp or fk != ff or sorted(fk) != ["layers", "tail", "top"] \
                or any(x for row in fk.values() for x in
                       torch.tensor(row).reshape(-1).tolist()):
            fail(f"{cfg.name} ring step {t} flags: cuda {fk} vs torch {fp} "
                 f"vs f32 {ff} (clean weights: all zero, rows top, layers, "
                 f"tail)")
        for r in steps:
            logits[r].append(res[r][0][:, 0].float())
        tok = res["cuda"][0].argmax(dim=-1)
    smax = cfg.attn_window
    written = torch.zeros(smax, dtype=torch.bool, device=dev)
    written[torch.arange(RING_START, RING_START + tokens, device=dev)
            % smax] = True
    for r in ("cuda", "torch"):
        c = caches[r]
        for name in ("k", "v"):
            same = (c[name] == base[name]).flatten(3).all(-1)  # (L, B, S)
            if bool(same[:, :, written].any()) or \
                    not bool(same[:, :, ~written].all()):
                fail(f"{cfg.name} {r} route: the ring writes of {name} are "
                     f"not exactly slots pos % {smax}")
    lk, lp, lf = (torch.stack(logits[r]) for r in ("cuda", "torch", "f32"))
    route_distances(torch, lk, lp, lf,
                    f"{cfg.name} {tokens} steps at positions {RING_START}.."
                    f"{RING_START + tokens - 1} across the ring wrap at "
                    f"{smax} (each bf16 route wrote exactly slots pos % "
                    f"{smax}), in lockstep",
                    HYBRID_MAX_ATOL, HYBRID_MEAN_ATOL)
    del caches, base


def _max_mean_diff(torch, a, b) -> tuple:
    """(max, mean) |a - b| in f32, one batch row (or one tensor of a
    sequence) at a time (the logits of a long forward take GBs in f32)."""
    mx, tot, n = 0.0, 0.0, 0
    for x, y in zip(a, b):
        d = (x.float() - y.float()).abs()
        mx, tot, n = max(mx, float(d.max())), tot + float(d.sum()), \
            n + d.numel()
    return mx, tot / n


def route_distances(torch, lk, lp, lf, what, max_atol, mean_atol):
    """Hold the kernel route's logits ``lk`` to the bf16 plain route's
    ``lp`` (finite, within ``max_atol`` at most and ``mean_atol`` on
    average) and both to the f32 plain route's ``lf`` over the same
    weights and inputs: the kernel route no farther from it than the
    plain route (mean within F32_ROUTE_RATIO, max within 1.5x). -> the
    readings."""
    dmax, dmean = _max_mean_diff(torch, lk, lp)
    to_f32 = {"cuda": _max_mean_diff(torch, lk, lf),
              "torch": _max_mean_diff(torch, lp, lf)}
    top = max(float(x.abs().max()) for x in lf)
    log(f"{what}, cuda vs torch route: logits max abs diff {dmax:.4g}, mean "
        f"{dmean:.4g} (|logits| max {top:.3g}); against "
        f"the f32 plain route: cuda max {to_f32['cuda'][0]:.4g} mean "
        f"{to_f32['cuda'][1]:.4g}, torch max {to_f32['torch'][0]:.4g} mean "
        f"{to_f32['torch'][1]:.4g}")
    if not all(bool(torch.isfinite(x.float()).all()) for x in lk) or \
            dmax > max_atol or dmean > mean_atol:
        fail(f"{what}: kernel route logits out of tolerance of the plain "
             f"route")
    if to_f32["cuda"][1] > F32_ROUTE_RATIO * to_f32["torch"][1] or \
            to_f32["cuda"][0] > 1.5 * to_f32["torch"][0]:
        fail(f"{what}: the kernel route is farther from the f32 plain route "
             f"than the bf16 plain route: {to_f32}")
    return {"max_abs_diff": dmax, "mean_abs_diff": dmean, "to_f32": to_f32}


def hybrid_forward(torch, dev, build, cfg, enc, *, batch=2, rate=1e-6):
    """The cache-less decode-at-use forward (``protected.make_prefill``
    without a KV policy) over ``batch`` x S seeded tokens for S in
    HYBRID_FORWARD_S: at 4,096 the window of 2,048 is shorter than S and
    flash runs windowed on the kernel route, at 2,048 the window covers
    the sequence and flash runs causal (the wrapper records the window of
    every launch). Both routes: flags all zero (rows top, layers, tail),
    logits held by :func:`route_distances` (within HYBRID_MAX_ATOL /
    HYBRID_MEAN_ATOL of each other, and against the f32 forward, the
    plain route in f32). Then the
    kernel route with correctable flips at ``rate``: logits bit-equal,
    and each row counts each flipped block of its images once. -> per S,
    the measurements (``flash_launches``: flash's launches in the
    kernel-route forward)."""
    from repro_torch.kernels import flash_attention
    from repro_torch.models import lm
    from repro_torch.protection import policy as policy_mod
    from repro_torch.serving import protected

    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    fenc, positions = policy_mod.inject_tree_device(enc, rate, gen,
                                                    one_per_block=True)
    rows = {"top": lambda p: p == "embed",
            "layers": lambda p: p.startswith("layers/"),
            "tail": lambda p: p.startswith("tail/")}
    want = {k: block_hist(torch, positions, keep) for k, keep in rows.items()}
    if any(h[2] or h["3+"] for h in want.values()) or \
            any(h[1] == 0 for h in want.values()):
        fail(f"{cfg.name} forward: the correctable-only injection put "
             f"{want} flips into the rows' blocks")
    real = flash_attention.flash_attention
    seen = []

    def spy(q, k, v, **kw):
        seen.append(kw.get("window", 0))
        return real(q, k, v, **kw)
    nb = lm.n_scan_layers(cfg)
    report = {}
    for s in HYBRID_FORWARD_S:
        prompt = torch.randint(0, cfg.vocab, (batch, s), generator=gen,
                               device=dev)
        out, ms, launches = {}, {}, {}
        for route in ("cuda", "torch"):
            prefill = protected.make_prefill(cfg, backend=route,
                                             with_flags=True)
            before = build.COUNTS["flash_attention"]
            seen.clear()
            flash_attention.flash_attention = spy
            try:
                torch.cuda.synchronize()
                t0 = time.time()
                out[route] = prefill(enc, prompt)
                torch.cuda.synchronize()
                ms[route] = 1e3 * (time.time() - t0)
            finally:
                flash_attention.flash_attention = real
            launched = launches[route] = \
                build.COUNTS["flash_attention"] - before
            win = cfg.attn_window if s > cfg.attn_window else 0
            if (route == "cuda" and (launched != nb or seen != [win] * nb)) \
                    or (route == "torch" and (launched or seen)):
                fail(f"{cfg.name} forward at S {s} on the {route} route: "
                     f"flash launched {launched} times with windows {seen}")
        prefill = protected.make_prefill(cfg, backend="cuda",
                                         with_flags=True)
        again = event_ms(torch, lambda: prefill(enc, prompt))[0]
        (lk, fk), (lp, fp) = out["cuda"], out["torch"]
        for r, fl in (("cuda", fk), ("torch", fp)):
            if sorted(fl) != ["layers", "tail", "top"] or \
                    any(int(v.abs().sum()) for v in fl.values()):
                fail(f"{cfg.name} clean forward flags on the {r} route: "
                     f"{ {k: v.tolist() for k, v in fl.items()} }")
        if lk.shape != (batch, s, cfg.vocab_padded) or \
                not all(bool(torch.isfinite(x.float()).all()) for x in lk):
            fail(f"{cfg.name} forward logits {tuple(lk.shape)} or not "
                 f"finite")
        ref = protected.make_prefill(cfg, backend="torch",
                                     dtype=torch.float32)(enc, prompt)
        dist = route_distances(torch, lk, lp, ref,
                               f"{cfg.name} forward over {batch} x {s} "
                               f"tokens (flash window {win})",
                               HYBRID_MAX_ATOL, HYBRID_MEAN_ATOL)
        del out, lp, fp, ref
        log(f"{cfg.name} forward at S {s}: {ms['cuda']:.1f} ms on the kernel "
            f"route, {ms['torch']:.1f} ms on the plain route (host clock, "
            f"first call); a second kernel-route call {again:.1f} ms (CUDA "
            f"events, {batch * s / again * 1e3:.0f} tok/s)")
        lf, ff = protected.make_prefill(cfg, backend="cuda",
                                        with_flags=True)(fenc, prompt)
        got = {k: v.reshape(-1, 2).sum(0).tolist() for k, v in ff.items()}
        if any(got[k] != [want[k][1], 0] for k in rows) or sorted(got) != \
                sorted(rows):
            fail(f"{cfg.name} forward accounting {got} != the flipped blocks "
                 f"of each row's images {want}")
        if not torch.equal(lf, lk):
            fail(f"{cfg.name}: every flip was correctable, yet the forward's "
                 f"logits at S {s} differ from the clean run")
        log(f"{cfg.name} forward at S {s} with correctable flips: logits "
            f"equal the clean run bit for bit; single-flip blocks per row "
            f"{({k: h[1] for k, h in want.items()})} counted once each: "
            f"{got}")
        report[s] = {"window": win, "flash_launches": launches["cuda"],
                     "first_call_ms": ms, "second_call_ms": again, **dist,
                     "faulted_flags": got}
        del lk, fk, lf, ff
        torch.cuda.empty_cache()
    with open(OUT_DIR / "chip_smoke_hybrid_forward.json", "w") as fh:
        json.dump({"config": cfg.name, "batch": batch,
                   "runs": {str(k): v for k, v in report.items()}}, fh,
                  indent=1)
    del fenc
    return report


def profile_hybrid_decode(torch, dev, cfg, plan, enc, batch=4):
    """Profile 4 decode steps of recurrentgemma-2b on the kernel route
    (its dense ring cache), after one step unprofiled: launches per step,
    the device-busy share, and the device time split into the projections
    (ecc_qmatmul), the ``ecc_decode`` kernel's launches (ranked by time:
    per step the embedding's one, the 36 gate leaves' and the 18 conv
    kernels'), the embedding's dequantization (``embed_decode`` range),
    the gates' dequantization and matmuls (``rglru_gates``), the rest of
    the RG-LRU step (``rglru`` less ``rglru_gates``: conv, recurrence,
    GELU, state writes), the local attention (``local_attention``), the
    tied head (``aten::mm`` outside ``rglru_gates``) and the rest."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import lm
    from repro_torch.serving import kvcache, protected

    torch.cuda.empty_cache()
    step = protected.make_serve_step(cfg, plan=plan, backend="cuda")
    cache = kvcache.init_cache(cfg, batch, 64, device=dev)
    tok = torch.zeros((batch, 1), dtype=torch.long, device=dev)

    def run(t0, t1):
        nonlocal cache, tok
        for t in range(t0, t1):
            pos = torch.full((batch,), t, dtype=torch.int32, device=dev)
            logits, cache, _ = step(enc, cache, tok, pos)
            tok = logits.argmax(dim=-1)

    n = 4
    run(0, 1)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.time()
        run(1, 1 + n)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0)
    ranges = ("embed_decode", "rglru", "rglru_gates", "local_attention")
    kernels = _profile_table(torch, prof, wall_ms,
                             f"{n} full-width {cfg.name} decode steps",
                             "chip_smoke_hybrid_profile.txt", ranges=ranges,
                             steps=n)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    split = _kernel_split(kernels, {
        "projections (ecc_qmatmul)": QMM_KERNELS})
    dec = sorted((e.device_time_total / 1e3 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "::decode_kernel" in e.name), reverse=True)
    n_conv = 2 * lm.n_scan_layers(cfg) + lm.hybrid_tail_layers(cfg)
    n_gate = 2 * n_conv          # two gates per RG-LRU layer
    # a step launches exactly these (phase_hybrid checks build.COUNTS),
    # but the profiler can drop device events at the start of its
    # window: the embedding's decodes (~50x a gate leaf's bytes) are told
    # by their time, then each of them stands for one step's gate decodes,
    # the largest of the rest, and the conv kernels' take what is left
    emb = [d for d in dec if d > 0.25 * dec[0]]
    steps_seen = len(emb)
    log(f"{cfg.name} profile: {len(dec)} ecc_decode kernel events, "
        f"{steps_seen} of them the embedding's, in {n} steps (a step "
        f"launches 1 embedding + {n_gate} gate + {n_conv} conv-kernel "
        f"decodes)")
    rest = dec[steps_seen:]
    split["embedding decode (decode_kernel)"] = sum(emb)
    split["gate decodes (decode_kernel)"] = sum(rest[:steps_seen * n_gate])
    split["conv-kernel decodes (decode_kernel)"] = \
        sum(rest[steps_seen * n_gate:])
    rng = dict.fromkeys(ranges, 0.0)
    gate_mm = head_mm = 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        if e.name in rng:
            rng[e.name] += e.device_time_total / 1e3
        elif e.name == "aten::mm":
            p, inside = e.cpu_parent, False
            while p is not None and not inside:
                inside, p = p.name == "rglru_gates", p.cpu_parent
            if inside:
                gate_mm += e.self_device_time_total / 1e3
            else:
                head_mm += e.self_device_time_total / 1e3
    split["embedding dequantization (embed_decode)"] = rng["embed_decode"]
    split["gate dequantization + matmuls (rglru_gates)"] = rng["rglru_gates"]
    split["RG-LRU glue (rglru less rglru_gates)"] = \
        rng["rglru"] - rng["rglru_gates"]
    split["local attention (local_attention)"] = rng["local_attention"]
    split["tied head (aten::mm)"] = head_mm
    split["the rest (norms, SwiGLU glue, argmax, decode dequant of conv)"] = \
        busy - sum(split.values())
    log(f"{cfg.name} decode profile split (device ms over {n} steps, "
        f"{busy:.2f} busy of {wall_ms:.2f} wall; gate matmuls alone "
        f"{gate_mm:.2f}): " + ", ".join(f"{k} {v:.2f}"
                                        for k, v in split.items()))
    with open(OUT_DIR / "chip_smoke_hybrid_profile.json", "w") as fh:
        json.dump({"config": cfg.name, "steps": n, "wall_ms": wall_ms,
                   "busy_ms": busy, "split_ms": split,
                   "gate_matmul_ms": gate_mm,
                   "launches": sum(e.count for e in kernels)}, fh, indent=1)
    del cache



# ---------------------------------------------------------------------------
# phase 14: the ssm family — mamba2-2.7b at full width and depth
# ---------------------------------------------------------------------------

# the cache-less forward: 2 x 4,096 tokens, 32 chunks of 128
SSM_FORWARD = (2, 4096)
# the chunked scan against the recurrence: 2 x 256 tokens, two chunks
SSM_AGREE = (2, 256)
# the card run's time limit: the scan-vs-recurrence check (256 host-bound
# f32 decode steps) runs on the first SSM_AGREE_LAYERS layers' depth, the
# route lockstep over SSM_ROUTE_STEPS steps
SSM_AGREE_LAYERS, SSM_ROUTE_STEPS = 16, 8
# the seeded state cache of the lockstep routes: state N(0, 0.5^2), conv
# history N(0, 1)
SSM_STATE_STD, SSM_CONV_STD = 0.5, 1.0
# mamba2-2.7b's logits at 64 layers (the decode from a seeded state cache
# and the cache-less forward, both routes): the decode's split-K
# projections sum in another order than cuBLAS, and the bf16 differences
# grow with depth through the state, which is rounded to bf16 every step;
# the logits reach |5|..|6|. Readings on the H100 (700 W): the decode max
# 0.2891, mean 0.04004 (each bf16 route 0.048 from the f32 decode on
# average); the forward bit-equal across routes (its one-split prefill
# tiles sum K in order, as cuBLAS does), 0.0592 from the f32 forward.
# Held to about twice the max and 1.5x the mean read, and, sharper, to
# the f32 plain route (F32_ROUTE_RATIO, as phase 13).
SSM_MAX_ATOL, SSM_MEAN_ATOL = 0.6, 0.06
# the f32 forward against 256 f32 decode steps, both on the kernel route:
# the reference's gate (tests/test_consistency.py::test_prefill_decode_agree)
SSM_AGREE_ATOL = 1e-3


def phase_ssm(torch, dev, build):
    """mamba2-2.7b (64 layers of one Mamba2 mixer, d_model 2,560, d_inner
    5,120 in 80 heads of 64, a state of 128, an untied 50,304-word head)
    at full width and depth on its state cache (each layer's recurrent
    state and conv history; no KV cache): the decode triple through
    ``serve`` (:func:`dense_cache_decode_triple`: every leaf is read by a
    decode step), whose clean run must launch ``ecc_decode`` exactly 1 +
    64 times a step (the embedding and each layer's ``conv_w``) and
    ``ecc_qmatmul`` exactly 2 x 64 + 1 (``w_in``, ``w_out``, the head);
    SSM_ROUTE_STEPS steps from a seeded state cache on both routes in
    lockstep against an f32 plain decode (:func:`ssm_routes`); the
    cache-less forward over 2 x 4,096 tokens on both routes against an
    f32 forward, and with correctable flips (:func:`ssm_forward`); the
    chunked scan against the recurrence in f32 on the kernel route, cut
    to SSM_AGREE_LAYERS layers (:func:`ssm_scan_vs_recurrence`); guarded
    steps (:func:`guarded_routes`, counted apart); then a profile of its
    decode step. -> (the launch counts of the path, those of the guarded
    steps)."""
    from repro_torch.configs import get
    from repro_torch.models import lm
    from repro_torch.protection import policy as policy_mod
    cfg = get("mamba2-2.7b")
    torch.cuda.empty_cache()
    build.reset_counts()
    clean = dense_cache_decode_triple(torch, dev, build, cfg, rate=3e-6)
    per_step = clean["launches_per_step"]
    del clean
    nl = cfg.n_layers
    if per_step.get("ecc_decode") != 1 + nl or \
            per_step.get("ecc_qmatmul") != 2 * nl + 1:
        fail(f"{cfg.name} decode step: {per_step.get('ecc_decode')} "
             f"ecc_decode and {per_step.get('ecc_qmatmul')} ecc_qmatmul "
             f"launches a step, not 1 embedding + {nl} conv_w decodes and "
             f"{2 * nl} projections + the head")
    plan = policy_mod.ProtectionPolicy(backend="cuda").plan(
        lm.param_shapes(cfg))
    t0 = time.time()
    enc = lm.init_params(cfg, 0, device=dev, leaf_fn=plan.encode_leaf)
    torch.cuda.synchronize()
    leaves = _protected(enc)
    log(f"{cfg.name}: drew and encoded {len(leaves)} protected leaves "
        f"({sum(t.enc.numel() for t in leaves) / 1e9:.3f} GB of image, "
        f"{nl} layers) in {time.time() - t0:.1f}s")
    report = {"launches_per_step": per_step,
              "routes": ssm_routes(torch, dev, cfg, enc),
              "forward": ssm_forward(torch, dev, cfg, enc),
              "agree": ssm_scan_vs_recurrence(torch, dev, cfg)}
    report["guarded"], guarded_counts = counted_apart(
        build, guarded_routes, torch, dev, cfg, enc)
    counts = dict(build.COUNTS)
    log(f"launch counts over the mamba2-2.7b path: {counts}")
    report["profile"] = profile_ssm_decode(torch, dev, build, cfg, plan, enc)
    with open(OUT_DIR / "chip_smoke_ssm.json", "w") as fh:
        json.dump({"config": cfg.name, **report}, fh, indent=1)
    del enc
    torch.cuda.empty_cache()
    return counts, guarded_counts


def ssm_routes(torch, dev, cfg, enc, *, tokens=SSM_ROUTE_STEPS, batch=4):
    """``tokens`` serve steps from position 0 over a state cache seeded with
    random states (std SSM_STATE_STD) and conv histories (std
    SSM_CONV_STD), on the kernel and the plain route in bf16 and on the
    plain route in f32 over the same cache upcast, in lockstep (the kernel
    route's greedy tokens fed to all three): flags equal and zero (rows
    top and layers), logits held by :func:`route_distances` within
    SSM_MAX_ATOL / SSM_MEAN_ATOL. Each bf16
    route writes every layer's state and conv history at every step."""
    from repro_torch.serving import kvcache, protected

    gen = torch.Generator(device=dev)
    gen.manual_seed(22)
    base = kvcache.init_cache(cfg, batch, tokens, device=dev)
    for name, t in base.items():
        std = SSM_STATE_STD if name == "state" else SSM_CONV_STD
        t.copy_(torch.randn(t.shape, generator=gen, device=dev) * std)
    caches = {r: {k: v.clone() for k, v in base.items()}
              for r in ("cuda", "torch")}
    caches["f32"] = {k: v.float() for k, v in base.items()}
    steps = {r: protected.make_serve_step(cfg, backend=r)
             for r in ("cuda", "torch")}
    steps["f32"] = protected.make_serve_step(cfg, backend="torch",
                                             dtype=torch.float32)
    tok = torch.randint(0, cfg.vocab, (batch, 1), generator=gen, device=dev)
    logits = {r: [] for r in steps}
    for t in range(tokens):
        pos = torch.full((batch,), t, dtype=torch.int32, device=dev)
        res = {r: steps[r](enc, caches[r], tok, pos) for r in steps}
        fk, fp, ff = ({k: v.tolist() for k, v in res[r][2].items()}
                      for r in steps)
        if fk != fp or fk != ff or sorted(fk) != ["layers", "top"] or \
                any(x for row in fk.values() for x in
                    torch.tensor(row).reshape(-1).tolist()):
            fail(f"{cfg.name} step {t} flags: cuda {fk} vs torch {fp} vs "
                 f"f32 {ff} (clean weights: all zero, rows top, layers)")
        for r in steps:
            logits[r].append(res[r][0][:, 0].float())
        tok = res["cuda"][0].argmax(dim=-1)
    for r in ("cuda", "torch"):
        for name, t in caches[r].items():
            moved = (t != base[name]).flatten(2).any(-1)       # (L, B)
            if not bool(moved.all()):
                fail(f"{cfg.name} {r} route: {name} of some layer and slot "
                     f"was never written")
    lk, lp, lf = (torch.stack(logits[r]) for r in ("cuda", "torch", "f32"))
    out = route_distances(torch, lk, lp, lf,
                          f"{cfg.name} {tokens} steps from a seeded state "
                          f"cache (state std {SSM_STATE_STD}, conv std "
                          f"{SSM_CONV_STD})", SSM_MAX_ATOL, SSM_MEAN_ATOL)
    del caches, base
    return out


def ssm_forward(torch, dev, cfg, enc, *, rate=1e-6):
    """The cache-less decode-at-use forward (``protected.make_prefill``
    without a KV policy) over SSM_FORWARD seeded tokens (32 chunks of 128)
    on both routes: flags all zero (rows top and layers), logits held by
    :func:`route_distances` within SSM_MAX_ATOL / SSM_MEAN_ATOL, and
    against the f32 plain-route forward. Then the
    kernel route with correctable flips at ``rate``: logits bit-equal, and
    each row counts each flipped block of its images once (top: the
    embedding and the head). -> the readings."""
    from repro_torch.protection import policy as policy_mod
    from repro_torch.serving import protected

    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    batch, s = SSM_FORWARD
    prompt = torch.randint(0, cfg.vocab, (batch, s), generator=gen,
                           device=dev)
    out, ms = {}, {}
    for route in ("cuda", "torch"):
        prefill = protected.make_prefill(cfg, backend=route, with_flags=True)
        torch.cuda.synchronize()
        t0 = time.time()
        out[route] = prefill(enc, prompt)
        torch.cuda.synchronize()
        ms[route] = 1e3 * (time.time() - t0)
    prefill = protected.make_prefill(cfg, backend="cuda", with_flags=True)
    again = event_ms(torch, lambda: prefill(enc, prompt))[0]
    (lk, fk), (lp, fp) = out["cuda"], out["torch"]
    del out
    for r, fl in (("cuda", fk), ("torch", fp)):
        if sorted(fl) != ["layers", "top"] or \
                any(int(v.abs().sum()) for v in fl.values()):
            fail(f"{cfg.name} clean forward flags on the {r} route: "
                 f"{ {k: v.tolist() for k, v in fl.items()} }")
    if lk.shape != (batch, s, cfg.vocab_padded):
        fail(f"{cfg.name} forward logits {tuple(lk.shape)}")
    lf = protected.make_prefill(cfg, backend="torch",
                                dtype=torch.float32)(enc, prompt)
    rep = route_distances(torch, lk, lp, lf,
                          f"{cfg.name} forward over {batch} x {s} tokens "
                          f"({s // cfg.ssm_chunk} chunks of "
                          f"{cfg.ssm_chunk})", SSM_MAX_ATOL, SSM_MEAN_ATOL)
    del lp, lf
    proj_ops = 2 * batch * s * sum(k * n * c
                                   for (k, n), c in qmm_per_step(cfg))
    split = profile_ssm_forward(torch, prefill, enc, prompt)
    log(f"{cfg.name} forward: {ms['cuda']:.1f} ms on the kernel route, "
        f"{ms['torch']:.1f} ms on the plain route (host clock, first call); "
        f"a second kernel-route call {again:.1f} ms (CUDA events, "
        f"{batch * s / again * 1e3:.0f} tok/s; projections and head "
        f"{proj_ops / 1e12:.1f} TFLOP, bound {bound_ms(0, proj_ops)[0]:.1f} "
        f"ms); profiled, device ms: " +
        ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
    fenc, positions = policy_mod.inject_tree_device(enc, rate, gen,
                                                    one_per_block=True)
    rows = {"top": lambda p: p in ("embed", "head"),
            "layers": lambda p: p.startswith("layers/")}
    want = {k: block_hist(torch, positions, keep) for k, keep in rows.items()}
    if any(h[2] or h["3+"] or h[1] == 0 for h in want.values()):
        fail(f"{cfg.name} forward: the correctable-only injection put "
             f"{want} flips into the rows' blocks")
    lfl, ff = protected.make_prefill(cfg, backend="cuda",
                                     with_flags=True)(fenc, prompt)
    got = {k: v.reshape(-1, 2).sum(0).tolist() for k, v in ff.items()}
    if sorted(got) != sorted(rows) or \
            any(got[k] != [want[k][1], 0] for k in rows):
        fail(f"{cfg.name} forward accounting {got} != the flipped blocks of "
             f"each row's images {want}")
    if not torch.equal(lfl, lk):
        fail(f"{cfg.name}: every flip was correctable, yet the forward's "
             f"logits differ from the clean run")
    log(f"{cfg.name} forward with correctable flips: logits equal the clean "
        f"run bit for bit; single-flip blocks per row "
        f"{({k: h[1] for k, h in want.items()})} counted once each: {got}")
    del fenc, lk, lfl
    torch.cuda.empty_cache()
    return {**rep, "first_call_ms": ms, "second_call_ms": again,
            "proj_tflop": proj_ops / 1e12, "profile_ms": split,
            "faulted_flags": got}


def profile_ssm_forward(torch, prefill, enc, prompt):
    """One kernel-route forward under ``torch.profiler``: its device time
    split into the projections and the head (ecc_qmatmul), the plain SSD
    chunked scan (``ssd`` range) and the rest (the conv, gates, norms,
    the decodes). -> the split, with ``busy`` and ``wall``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        prefill(enc, prompt)
        torch.cuda.synchronize()
        wall = 1e3 * (time.time() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and
               e.key != "ssd"]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    split = _kernel_split(kernels, {"projections (ecc_qmatmul)":
                                    QMM_KERNELS})
    split["SSD chunked scan (ssd)"] = sum(
        e.device_time_total for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CPU
        and e.name == "ssd") / 1e3
    split["the rest"] = busy - sum(split.values())
    split.update(busy=busy, wall=wall)
    return split


def ssm_scan_vs_recurrence(torch, dev, cfg):
    """The chunked scan against the recurrence at full width, cut to
    SSM_AGREE_LAYERS layers (a seeded encode of its own), in f32 on the
    kernel route: the cache-less forward's logits over SSM_AGREE seeded
    tokens (two chunks, so the scan across chunks runs) against as many
    decode steps from a zero state over the same tokens, within
    SSM_AGREE_ATOL (the reference's test_prefill_decode_agree at full
    width and on the card). -> the readings."""
    from repro_torch.models import lm
    from repro_torch.protection import policy as policy_mod
    from repro_torch.serving import kvcache, protected

    cfg = cfg.with_(n_layers=SSM_AGREE_LAYERS)
    enc = lm.init_params(cfg, 0, device=dev, leaf_fn=policy_mod.
                         ProtectionPolicy(backend="cuda").plan(
                             lm.param_shapes(cfg)).encode_leaf)

    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    batch, s = SSM_AGREE
    toks = torch.randint(0, cfg.vocab, (batch, s), generator=gen, device=dev)
    t0 = time.time()
    full = protected.make_prefill(cfg, backend="cuda",
                                  dtype=torch.float32)(enc, toks)
    step = protected.make_serve_step(cfg, backend="cuda",
                                     dtype=torch.float32)
    cache = kvcache.init_cache(cfg, batch, s, dtype=torch.float32,
                               device=dev)
    worst = 0.0
    for t in range(s):
        pos = torch.full((batch,), t, dtype=torch.int32, device=dev)
        lg, cache, _ = step(enc, cache, toks[:, t:t + 1], pos)
        worst = max(worst, float((lg[:, 0] - full[:, t]).abs().max()))
    torch.cuda.synchronize()
    top = float(full.abs().max())
    log(f"{cfg.name} x {cfg.n_layers} chunked scan vs recurrence (f32, "
        f"kernel route, "
        f"{batch} x {s} tokens, {s // cfg.ssm_chunk} chunks): forward vs "
        f"{s} decode steps max abs diff {worst:.3g} (|logits| max {top:.3g}, "
        f"limit {SSM_AGREE_ATOL}) in {time.time() - t0:.1f}s")
    if not worst < SSM_AGREE_ATOL:
        fail(f"{cfg.name}: the chunked forward and the decode recurrence "
             f"disagree by {worst}")
    del full, cache, enc
    return {"layers": cfg.n_layers, "max_abs_diff": worst,
            "logits_abs_max": top}


def profile_ssm_decode(torch, dev, build, cfg, plan, enc, batch=4):
    """Profile 4 decode steps of mamba2-2.7b on the kernel route (its
    state cache), after one step unprofiled: launches per step, the
    device-busy share, and the device time split into the projections
    (ecc_qmatmul), the ``ecc_decode`` launches of the embedding and of the
    ``conv_w`` leaves, the embedding's dequantization (``embed_decode``
    range), the Mamba2 glue and state update (``mamba2`` range: split,
    conv, softplus, the state's decay and outer-product update, y = state
    C, the gate) and the rest. The decode launches are told apart by
    ``build.COUNTS``: the window launches 1 + 64 of them a step, the
    embedding's first (``_use_tree`` decodes it before the layers), so in
    time order every 65th, counted back from the last (the profiler can
    drop events at the start of its window), is the embedding's. ->
    the split."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import kvcache, protected

    torch.cuda.empty_cache()
    step = protected.make_serve_step(cfg, plan=plan, backend="cuda")
    cache = kvcache.init_cache(cfg, batch, 8, device=dev)
    tok = torch.zeros((batch, 1), dtype=torch.long, device=dev)

    def run(t0, t1):
        nonlocal cache, tok
        for t in range(t0, t1):
            pos = torch.full((batch,), t, dtype=torch.int32, device=dev)
            logits, cache, _ = step(enc, cache, tok, pos)
            tok = logits.argmax(dim=-1)

    n = 4
    run(0, 1)
    torch.cuda.synchronize()
    before = build.COUNTS["ecc_decode"]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.time()
        run(1, 1 + n)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0)
    launched = build.COUNTS["ecc_decode"] - before
    per = 1 + cfg.n_layers
    if launched != n * per:
        fail(f"{cfg.name} profile: {launched} ecc_decode launches in {n} "
             f"steps, not {n} x {per}")
    ranges = ("embed_decode", "mamba2")
    kernels = _profile_table(torch, prof, wall_ms,
                             f"{n} full-width {cfg.name} decode steps",
                             "chip_smoke_ssm_profile.txt", ranges=ranges,
                             steps=n)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    split = _kernel_split(kernels, {
        "projections (ecc_qmatmul)": QMM_KERNELS})
    dec = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "::decode_kernel" in e.name),
                 key=lambda e: e.time_range.start)
    ms_ = [e.time_range.elapsed_us() / 1e3 for e in dec]
    emb = [m for i, m in enumerate(reversed(ms_)) if i % per == per - 1]
    split["embedding decode (ecc_decode)"] = sum(emb)
    split["conv_w decodes (ecc_decode)"] = sum(ms_) - sum(emb)
    rng = dict.fromkeys(ranges, 0.0)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name in rng:
            rng[e.name] += e.device_time_total / 1e3
    split["embedding dequantization (embed_decode)"] = rng["embed_decode"]
    split["Mamba2 glue and state update (mamba2)"] = rng["mamba2"]
    split["the rest (norms, residual adds, argmax)"] = \
        busy - sum(split.values())
    log(f"{cfg.name} profile: {len(dec)} ecc_decode kernel events of the "
        f"{launched} launched ({n} x {per}), {len(emb)} of them the "
        f"embedding's (every {per}th from the last)")
    log(f"{cfg.name} decode profile split (device ms over {n} steps, "
        f"{busy:.2f} busy of {wall_ms:.2f} wall): " +
        ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    del cache
    return {"steps": n, "wall_ms": wall_ms, "busy_ms": busy,
            "split_ms": split, "decode_events": len(dec),
            "launches": sum(e.count for e in kernels)}


# ---------------------------------------------------------------------------
# phases 15 and 16: the moe family — deepseek-v2-236b and deepseek-v3-671b
# ---------------------------------------------------------------------------

# Depth cuts: the widths and expert counts stay as published (160 and 256
# routed experts, top-6 and top-8, kv_lora_rank 512, 128 heads). At full
# depth neither model fits one card (244.2 G and 703.8 G parameters: 4.05
# G and 11.51 G a layer). deepseek-v2-236b serves at 4 layers (17.26 GB of
# image; its deploy draws one stacked expert leaf of 20.1 GB in f32) and
# compares routes at 2; deepseek-v3-671b at 1 layer (13.36 GB of image; a
# 15.0 GB f32 draw for each expert leaf).
MOE_V2_LAYERS, MOE_ROUTE_LAYERS, MOE_V3_LAYERS = 4, 2, 1
# the decode triple's fault rate: at 13-17 GB of image a few dozen blocks
# take two flips and (expected 0.003) none three
MOE_FAULT_RATE = 3e-6
# the cache-less forward: 2 x 4,096 tokens (capacity 192 slots per expert
# at v2, 160 at v3)
MOE_FORWARD = (2, 4096)
# the latent cache of the decode triple: serve sizes it max(64, 2 x 16
# tokens) slots, so w_uk and w_uv run at M = 4 x 64 rows a step
MOE_SERVE_SMAX = 64
# the lockstep decode of the three routes: 16 steps at batch 8
MOE_ROUTE_STEPS, MOE_ROUTE_BATCH = 16, 8
# the f32 forward against f32 decode steps over S = 8 tokens: capacity 8
# >= S, so no pair can drop in either; the reference's gate
# (tests/test_consistency.py::test_prefill_decode_agree)
MOE_AGREE = (4, 8)
MOE_AGREE_ATOL = 1e-3
# Routing between routes: each route rounds the bf16 activations at its
# own places, and a token whose k-th and (k+1)-th gates lie within that
# rounding takes another expert on one of them, which moves its logits by
# O(1) and, in the forward, the later pairs of both experts' queues, so
# other pairs drop at capacity. So the routes are compared on one
# dispatch: the f32 plain route routes by its own gates, and the two bf16
# routes replay its expert ids (their gates gathered at them;
# :func:`_recorded_routing`), so every (token, k) pair goes to the same
# expert and drops alike on all three, and the logits of every row are
# held. Each bf16 route's own top-k picks on that shared history are
# recorded too: the kernel route's may differ from the f32 route's at
# most MOE_FLIP_RATIO times as often as the bf16 plain route's do, plus
# MOE_FLIP_SLACK pairs. Readings on the H100 (700 W, phase 15 at 2
# layers, before the replay, each route on its own routing): the decode
# 27 and 26 of 256 pairs (kernel and plain route against f32), the
# forward's top-k sets 9.381% and 10.199% of 16,384; ratios 1.04 and 0.92.
# With the replay: 16 and 17 of 256, 7.343% and 7.721% of 16,384.
MOE_FLIP_RATIO, MOE_FLIP_SLACK = 1.25, 3
# the logits of every row (both bf16 routes against each other; and each
# against the f32 plain route as F32_ROUTE_RATIO says). Stated from the
# readings before the replay, on the rows no routing difference reached
# (the decode max 0.0625, mean 0.006431 over 64 rows, |logits| up to 5.2,
# where a bf16 ulp is 0.03125; the forward max 0.05957, mean 0.008192
# over 20 rows), at about twice each. With the replay, every row (same
# card): the decode max 0.0625, mean 0.006727 over 128 rows; the forward
# max 0.0957, mean 0.01101 over 8,192 rows.
MOE_MAX_ATOL, MOE_MEAN_ATOL = 0.125, 0.015


def phase_moe_v2(torch, dev, build):
    """deepseek-v2-236b at full width, cut to MOE_V2_LAYERS layers, on its
    latent cache: the decode triple through ``serve``
    (:func:`dense_cache_decode_triple`, rate 3e-6: every expert leaf, the
    router and every projection are read whole each step), whose clean
    run must launch ``ecc_decode`` exactly 1 + 4 L times a step (the
    embedding, each layer's router and three expert leaves) and
    ``ecc_qmatmul`` 8 L + 1 (wq, w_dkv, w_uk, w_uv, wo, the three shared
    expert projections; the head); a profile of its decode step
    (:func:`profile_moe_decode`); then at MOE_ROUTE_LAYERS layers the three
    routes in lockstep (:func:`moe_routes`), the cache-less forward over
    MOE_FORWARD tokens on the three routes (:func:`moe_forward`) and the
    f32 forward against f32 decode steps (:func:`moe_forward_vs_decode`);
    at MOE_V2_LAYERS, guarded steps (:func:`guarded_routes`, counted
    apart). -> (the launch counts of the path, those of the guarded
    steps)."""
    from repro_torch.configs import get
    from repro_torch.models import lm
    from repro_torch.protection import policy as policy_mod

    cfg = get("deepseek-v2-236b").with_(n_layers=MOE_V2_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.reset_counts()
    report = {"layers": MOE_V2_LAYERS,
              "launches_per_step": moe_decode_triple(torch, dev, build, cfg)}
    plan = policy_mod.ProtectionPolicy(backend="cuda").plan(
        lm.param_shapes(cfg))
    enc = _moe_deploy(torch, dev, cfg, plan)
    report["profile"] = profile_moe_decode(torch, dev, build, cfg, plan, enc)
    report["guarded"], guarded_counts = counted_apart(
        build, guarded_routes, torch, dev, cfg, enc)
    del enc
    torch.cuda.empty_cache()
    cfg2 = cfg.with_(n_layers=MOE_ROUTE_LAYERS)
    plan = policy_mod.ProtectionPolicy(backend="cuda").plan(
        lm.param_shapes(cfg2))
    enc = _moe_deploy(torch, dev, cfg2, plan)
    report["routes"] = moe_routes(torch, dev, cfg2, enc)
    report["forward"] = moe_forward(torch, dev, cfg2, enc, routes=True)
    report["agree"] = moe_forward_vs_decode(torch, dev, cfg2, enc)
    del enc
    report["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    counts = dict(build.COUNTS)
    log(f"launch counts over the deepseek-v2-236b path: {counts}; peak "
        f"device memory {report['peak_gb']:.2f} GB")
    with open(OUT_DIR / "chip_smoke_moe_v2.json", "w") as fh:
        json.dump({"config": cfg.name, **report}, fh, indent=1)
    torch.cuda.empty_cache()
    return counts, guarded_counts


def phase_moe_v3(torch, dev, build):
    """deepseek-v3-671b at full width, cut to MOE_V3_LAYERS layer, on its
    latent cache: the decode triple (its ``q_lora`` pair ``w_dq`` ->
    ``w_uq`` and three 3.76 GB expert leaves through ``ecc_decode`` and the
    injector each step; ``ecc_qmatmul`` 9 L + 1 launches a step), a
    profile of its decode step, and one cache-less forward over
    MOE_FORWARD tokens through flash at (192, 128) on the kernel route.
    -> the launch counts of the path."""
    from repro_torch.configs import get
    from repro_torch.models import lm
    from repro_torch.protection import policy as policy_mod

    cfg = get("deepseek-v3-671b").with_(n_layers=MOE_V3_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.reset_counts()
    report = {"layers": MOE_V3_LAYERS,
              "launches_per_step": moe_decode_triple(torch, dev, build, cfg)}
    plan = policy_mod.ProtectionPolicy(backend="cuda").plan(
        lm.param_shapes(cfg))
    enc = _moe_deploy(torch, dev, cfg, plan)
    report["profile"] = profile_moe_decode(torch, dev, build, cfg, plan, enc)
    report["forward"] = moe_forward(torch, dev, cfg, enc, routes=False)
    del enc
    report["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    counts = dict(build.COUNTS)
    log(f"launch counts over the deepseek-v3-671b path: {counts}; peak "
        f"device memory {report['peak_gb']:.2f} GB")
    with open(OUT_DIR / "chip_smoke_moe_v3.json", "w") as fh:
        json.dump({"config": cfg.name, **report}, fh, indent=1)
    torch.cuda.empty_cache()
    return counts


def _moe_deploy(torch, dev, cfg, plan):
    """Draw and encode ``cfg``'s weights leaf by leaf on the kernel route
    (seed 0, as ``serve`` draws them)."""
    from repro_torch.models import lm
    t0 = time.time()
    enc = lm.init_params(cfg, 0, device=dev, leaf_fn=plan.encode_leaf)
    torch.cuda.synchronize()
    leaves = _protected(enc)
    log(f"{cfg.name} ({cfg.n_layers} layers): drew and encoded "
        f"{len(leaves)} protected leaves "
        f"({sum(t.enc.numel() for t in leaves) / 1e9:.3f} GB of image) in "
        f"{time.time() - t0:.1f}s")
    return enc


def _moe_step_launches(cfg) -> tuple:
    """(ecc_decode, ecc_qmatmul) launches of one decode step: the
    embedding and each layer's router and three expert leaves decode
    whole; the MLA projections (``wq``, or ``w_dq`` and ``w_uq``;
    ``w_dkv``, ``w_uk``, ``w_uv``, ``wo``), the three shared-expert
    projections and the head go through ``ecc_qmatmul``."""
    nl = cfg.n_layers
    return 1 + 4 * nl, (8 + bool(cfg.q_lora_rank)) * nl + 1


def moe_decode_triple(torch, dev, build, cfg):
    """The decode triple at batch 4, 16 steps from position 0 on the latent
    cache, rate MOE_FAULT_RATE, with the per-step launches checked. ->
    the clean run's launches per step."""
    clean = dense_cache_decode_triple(torch, dev, build, cfg,
                                      rate=MOE_FAULT_RATE)
    per_step = clean["launches_per_step"]
    del clean
    torch.cuda.empty_cache()
    dec, qmm = _moe_step_launches(cfg)
    if per_step.get("ecc_decode") != dec or per_step.get("ecc_qmatmul") != qmm:
        fail(f"{cfg.name} decode step: {per_step.get('ecc_decode')} "
             f"ecc_decode and {per_step.get('ecc_qmatmul')} ecc_qmatmul "
             f"launches a step, not {dec} and {qmm}")
    return per_step


@contextlib.contextmanager
def _recorded_routing(replay=None):
    """Record the top-k expert ids (B, S, k) the router picks in every moe
    call, in order, by wrapping ``layers.top_k_lower_first`` while the
    block runs. With ``replay`` (the ids another run recorded, one per
    call in the same order) each call dispatches by the replayed ids
    instead, its own gates gathered at them; the record still holds the
    call's own picks."""
    from repro_torch.models import layers as L
    real, calls = L.top_k_lower_first, []
    given = None if replay is None else iter(replay)

    def spy(x, k):
        w, i = real(x, k)
        calls.append(i)
        if given is not None:
            i = next(given)
            w = x.gather(-1, i)
        return w, i
    L.top_k_lower_first = spy
    try:
        yield calls
    finally:
        L.top_k_lower_first = real
    if given is not None and next(given, None) is not None:
        fail("a replayed routing has more moe calls than the run made")


def _routing(torch, cfg, calls) -> tuple:
    """Recorded top-k ids, one call per layer -> (the sets sorted (L, B,
    S, k), the pairs kept at capacity (L, B, S, k), by the model's own
    queues)."""
    from repro_torch.models import layers as L
    topi = torch.stack(calls)
    n, b, s, k = topi.shape
    pos = L.queue_positions(topi.reshape(n * b, s * k), cfg.n_experts)[3]
    keep = (pos < L.moe_capacity(cfg, s)).reshape(n, b, s, k)
    return topi.sort(dim=-1).values, keep


def _hold_flips(what, shares, pairs):
    """The kernel route's own top-k picks differ from the f32 plain
    route's at most MOE_FLIP_RATIO times as often as the bf16 plain
    route's, plus MOE_FLIP_SLACK pairs."""
    k, p = shares["cuda_vs_f32"] * pairs, shares["torch_vs_f32"] * pairs
    log(f"{what}: (token, layer) pairs whose own top-k set differs (each "
        f"route's router on the shared dispatch), of {pairs}: " +
        ", ".join(f"{n} {v * pairs:.0f} ({100 * v:.3f}%)"
                  for n, v in shares.items()))
    if k > MOE_FLIP_RATIO * p + MOE_FLIP_SLACK:
        fail(f"{what}: the kernel route picks other experts than the f32 "
             f"plain route in {k:.0f} pairs, the bf16 plain route in {p:.0f}")


def _set_shares(sets) -> dict:
    """Sorted top-k sets (L, B, S, k) per route -> the share of (token,
    layer) pairs whose sets differ, for the three pairs of routes."""
    pairs = {"cuda_vs_torch": ("cuda", "torch"), "cuda_vs_f32": ("cuda", "f32"),
             "torch_vs_f32": ("torch", "f32")}
    return {n: float((sets[a] != sets[b]).any(-1).float().mean())
            for n, (a, b) in pairs.items()}


def moe_routes(torch, dev, cfg, enc):
    """MOE_ROUTE_STEPS serve steps from position 0 over the latent cache at
    batch MOE_ROUTE_BATCH on the plain route in f32 and on the kernel route
    and the plain route in bf16, in lockstep (the kernel route's greedy
    tokens fed to all three), the bf16 routes dispatched by the f32
    route's expert ids (:func:`_recorded_routing`): flags equal and zero
    (rows top and layers); every row's logits held by
    :func:`route_distances` within MOE_MAX_ATOL / MOE_MEAN_ATOL; the share
    of (token, layer) pairs whose own top-6 set differs between each pair
    of routes held by :func:`_hold_flips`. -> the readings."""
    from repro_torch.serving import kvcache, protected

    tokens, batch = MOE_ROUTE_STEPS, MOE_ROUTE_BATCH
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    routes = {"f32": ("torch", torch.float32),
              "cuda": ("cuda", torch.bfloat16),
              "torch": ("torch", torch.bfloat16)}
    caches = {r: kvcache.init_cache(cfg, batch, tokens, dtype=dt, device=dev)
              for r, (_, dt) in routes.items()}
    steps = {r: protected.make_serve_step(cfg, backend=be, dtype=dt)
             for r, (be, dt) in routes.items()}
    tok = torch.randint(0, cfg.vocab, (batch, 1), generator=gen, device=dev)
    logits = {r: [] for r in routes}
    sinks = {r: [] for r in routes}
    t0 = time.time()
    for t in range(tokens):
        pos = torch.full((batch,), t, dtype=torch.int32, device=dev)
        res = {}
        with _recorded_routing() as ref:
            res["f32"] = steps["f32"](enc, caches["f32"], tok, pos)
        sinks["f32"] += ref
        for r in ("cuda", "torch"):
            with _recorded_routing(replay=ref) as calls:
                res[r] = steps[r](enc, caches[r], tok, pos)
            sinks[r] += calls
        fk, fp, ff = ({k: v.tolist() for k, v in res[r][2].items()}
                      for r in ("cuda", "torch", "f32"))
        if fk != fp or fk != ff or sorted(fk) != ["layers", "top"] or \
                any(x for row in fk.values() for x in
                    torch.tensor(row).reshape(-1).tolist()):
            fail(f"{cfg.name} step {t} flags: cuda {fk} vs torch {fp} vs "
                 f"f32 {ff} (clean weights: all zero, rows top, layers)")
        for r in routes:
            logits[r].append(res[r][0][:, 0])
        tok = res["cuda"][0].argmax(dim=-1)
    torch.cuda.synchronize()
    wall = time.time() - t0
    nl = cfg.n_layers
    # per route: (L, B, T, k), the steps as the sequence axis
    rt = {}
    for r, sink in sinks.items():
        topi, keep = _routing(torch, cfg, sink)      # (T*L, B, 1, k)
        rt[r] = tuple(x.reshape(tokens, nl, batch, -1).permute(1, 2, 0, 3)
                      for x in (topi, keep))
    shares = _set_shares({r: v[0] for r, v in rt.items()})
    what = (f"{cfg.name} ({nl} layers) {tokens} decode steps at batch "
            f"{batch} in lockstep")
    _hold_flips(what, shares, nl * batch * tokens)
    dropped = int((~rt["f32"][1]).sum())
    lk, lp, lf = (torch.stack(logits[r]).transpose(0, 1)
                  for r in ("cuda", "torch", "f32"))  # (B, T, V)
    rep = route_distances(
        torch, lk, lp, lf, f"{what} (every row; the bf16 routes dispatched "
        f"by the f32 route's experts)", MOE_MAX_ATOL, MOE_MEAN_ATOL)
    log(f"{what}: {wall:.1f}s for the three routes; pairs dropped at "
        f"capacity {dropped} (a decode step cannot drop: 8 slots per "
        f"expert, one token a row)")
    if dropped:
        fail(f"{what}: a decode step dropped a pair at capacity")
    return {**rep, "topk_set_shares": shares, "pairs": nl * batch * tokens,
            "rows": batch * tokens}


def moe_forward(torch, dev, cfg, enc, *, routes):
    """The cache-less decode-at-use forward (``protected.make_prefill``
    without a KV policy) over MOE_FORWARD seeded tokens on the kernel route
    (MLA's attention through flash at (192, 128)): flags all zero (rows
    top and layers), logits finite of the expected shape, its time (host
    clock of the first call; CUDA events of a second) and the (token, k)
    pairs dropped at capacity in each layer on its own routing. With
    ``routes`` also on the plain route in f32 and then, dispatched by the
    f32 route's expert ids (:func:`_recorded_routing`), again on the
    kernel route and on the plain route in bf16: the logits of every row
    held by :func:`route_distances` within MOE_MAX_ATOL / MOE_MEAN_ATOL,
    and each bf16 route's own top-6 picks on that dispatch held by
    :func:`_hold_flips`. -> the readings."""
    from repro_torch.serving import protected

    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    batch, s = MOE_FORWARD
    prompt = torch.randint(0, cfg.vocab, (batch, s), generator=gen,
                           device=dev)
    todo = {"cuda": ("cuda", torch.bfloat16)}
    if routes:
        todo = {"f32": ("torch", torch.float32), **todo,
                "torch": ("torch", torch.bfloat16)}
    # timed first, with nothing else held: a first call on the host clock,
    # a second in CUDA events on the allocator's cached blocks (emptying
    # the cache between them would time cudaMalloc of several GB)
    prefill = protected.make_prefill(cfg, backend="cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    with _recorded_routing() as own:
        prefill(enc, prompt)
    torch.cuda.synchronize()
    first = 1e3 * (time.time() - t0)
    again = event_ms(torch, lambda: prefill(enc, prompt))[0]
    torch.cuda.empty_cache()
    keep = {"cuda": _routing(torch, cfg, own)[1]}    # (L, B, S, k)
    out, ms, sets, ref = {}, {"cuda": first}, {}, None
    for r, (be, dt) in todo.items():
        prefill = protected.make_prefill(cfg, backend=be, dtype=dt,
                                         with_flags=True)
        torch.cuda.synchronize()
        t0 = time.time()
        with _recorded_routing(replay=ref) as sink:
            lg, fl = prefill(enc, prompt)
        torch.cuda.synchronize()
        if r != "cuda":
            ms[r] = 1e3 * (time.time() - t0)
        if sorted(fl) != ["layers", "top"] or \
                any(int(v.abs().sum()) for v in fl.values()):
            fail(f"{cfg.name} clean forward flags on the {r} route: "
                 f"{ {k: v.tolist() for k, v in fl.items()} }")
        if lg.shape != (batch, s, cfg.vocab_padded) or \
                not all(bool(torch.isfinite(x.float()).all()) for x in lg):
            fail(f"{cfg.name} forward logits on the {r} route: "
                 f"{tuple(lg.shape)} or non-finite")
        out[r] = lg
        sets[r], kept = _routing(torch, cfg, sink)
        if r == "f32":
            ref, keep["f32"] = sink, kept
        del lg
    from repro_torch.models.layers import moe_capacity
    cap = moe_capacity(cfg, s)
    dropped = {r: [int((~k).sum()) for k in v] for r, v in keep.items()}
    pairs = batch * s * cfg.top_k
    log(f"{cfg.name} ({cfg.n_layers} layers) forward over {batch} x {s} "
        f"tokens: {ms['cuda']:.1f} ms on the kernel route (host clock, "
        f"first call), a second call {again:.1f} ms (CUDA events, "
        f"{batch * s / again * 1e3:.0f} tok/s); " +
        "".join(f"{r} route {v:.1f} ms; " for r, v in ms.items()
                if r != "cuda") +
        f"(token, k) pairs dropped at capacity ({cap} slots per expert) "
        f"per layer on each route's own routing, of {pairs}: {dropped}")
    rep = {"first_call_ms": ms, "second_call_ms": again, "capacity": cap,
           "pairs_per_layer": pairs, "dropped_per_layer": dropped}
    if routes:
        shares = _set_shares(sets)
        what = f"{cfg.name} ({cfg.n_layers} layers) forward over {batch} x {s}"
        _hold_flips(what, shares, cfg.n_layers * batch * s)
        rep.update(route_distances(
            torch, out["cuda"], out["torch"], out["f32"],
            f"{what} (every row; the bf16 routes dispatched by the f32 "
            f"route's experts)", MOE_MAX_ATOL, MOE_MEAN_ATOL),
            topk_set_shares=shares, rows=batch * s)
    del out
    torch.cuda.empty_cache()
    return rep


def moe_forward_vs_decode(torch, dev, cfg, enc):
    """The f32 forward against f32 decode steps on the kernel route over
    MOE_AGREE seeded tokens: the capacity is 8 slots per expert and S is
    8, so no pair drops in either (checked), and the two compute the same
    function; logits within MOE_AGREE_ATOL. -> the readings."""
    from repro_torch.serving import kvcache, protected

    gen = torch.Generator(device=dev)
    gen.manual_seed(25)
    batch, s = MOE_AGREE
    toks = torch.randint(0, cfg.vocab, (batch, s), generator=gen, device=dev)
    with _recorded_routing() as sink:
        full = protected.make_prefill(cfg, backend="cuda",
                                      dtype=torch.float32)(enc, toks)
    if not bool(_routing(torch, cfg, sink)[1].all()):
        fail(f"{cfg.name}: a pair dropped at capacity over {s} tokens")
    step = protected.make_serve_step(cfg, backend="cuda",
                                     dtype=torch.float32)
    cache = kvcache.init_cache(cfg, batch, s, dtype=torch.float32,
                               device=dev)
    worst = 0.0
    for t in range(s):
        pos = torch.full((batch,), t, dtype=torch.int32, device=dev)
        lg, cache, _ = step(enc, cache, toks[:, t:t + 1], pos)
        worst = max(worst, float((lg[:, 0] - full[:, t]).abs().max()))
    top = float(full.abs().max())
    log(f"{cfg.name} f32 forward vs {s} f32 decode steps (kernel route, "
        f"{batch} x {s} tokens, no drops possible): max abs diff "
        f"{worst:.3g} (|logits| max {top:.3g}, limit {MOE_AGREE_ATOL})")
    if not worst < MOE_AGREE_ATOL:
        fail(f"{cfg.name}: the f32 forward and the decode steps disagree by "
             f"{worst}")
    del full, cache
    return {"max_abs_diff": worst, "logits_abs_max": top}


# a CUPTI marker the profiler records while the host waits on a full
# launch queue (a device-bound step); it repeats the device time of the
# kernels queued behind it
CMD_BUFFER_FULL = "Command Buffer Full"


def _range_device_ms(torch, prof, ranges) -> dict:
    """Device ms under each ``record_function`` range of ``ranges``: the
    range's device time less that of the CMD_BUFFER_FULL markers inside
    it, which count its kernels a second time."""
    def markers(e):
        return sum(c.device_time_total if c.name == CMD_BUFFER_FULL
                   else markers(c) for c in e.cpu_children)

    out = dict.fromkeys(ranges, 0.0)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name in out:
            out[e.name] += (e.device_time_total - markers(e)) / 1e3
    return out


def profile_moe_decode(torch, dev, build, cfg, plan, enc, batch=4):
    """Profile 4 decode steps on the kernel route over the latent cache,
    after one step unprofiled: launches per step, the device-busy share,
    and the device time split into the projections (ecc_qmatmul), the
    ``ecc_decode`` launches (in time order per step the embedding's, then
    each layer's router and three expert leaves; told apart by
    ``build.COUNTS``: 1 + 4 L a step), the embedding's dequantization
    (``embed_decode`` range), MLA's PyTorch ops (``mla``: rope, the
    latent cache writes, the scores, softmax and values over all cached
    slots), the router (``moe_router``: its dequantization, logits, top-k
    and queue positions), the routed experts (``moe_experts``: the three
    leaves' dequantizations through f32, their batched products, the
    dispatch and combine gathers) and the rest. -> the split."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import kvcache, protected

    torch.cuda.empty_cache()
    step = protected.make_serve_step(cfg, plan=plan, backend="cuda")
    cache = kvcache.init_cache(cfg, batch, 8, device=dev)
    tok = torch.zeros((batch, 1), dtype=torch.long, device=dev)

    def run(t0, t1):
        nonlocal cache, tok
        for t in range(t0, t1):
            pos = torch.full((batch,), t, dtype=torch.int32, device=dev)
            logits, cache, _ = step(enc, cache, tok, pos)
            tok = logits.argmax(dim=-1)

    n = 4
    run(0, 1)
    torch.cuda.synchronize()
    before = build.COUNTS["ecc_decode"]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.time()
        run(1, 1 + n)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0)
    launched = build.COUNTS["ecc_decode"] - before
    per = _moe_step_launches(cfg)[0]
    if launched != n * per:
        fail(f"{cfg.name} profile: {launched} ecc_decode launches in {n} "
             f"steps, not {n} x {per}")
    ranges = ("embed_decode", "mla", "moe_router", "moe_experts")
    kernels = _profile_table(torch, prof, wall_ms,
                             f"{n} full-width {cfg.name} decode steps "
                             f"({cfg.n_layers} layers)",
                             f"chip_smoke_{cfg.name}_profile.txt",
                             ranges=ranges, steps=n)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    split = _kernel_split(kernels, {
        "projections (ecc_qmatmul)": QMM_KERNELS})
    dec = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "::decode_kernel" in e.name),
                 key=lambda e: e.time_range.start)
    ms_ = [e.time_range.elapsed_us() / 1e3 for e in reversed(dec)]
    # counted back from the last (the profiler can drop events at its
    # window's start): per step each layer's we_down, we_up, we_gate and
    # router, from the last layer, then the embedding's
    emb = [m for i, m in enumerate(ms_) if i % per == per - 1]
    router = [m for i, m in enumerate(ms_)
              if i % per != per - 1 and i % per % 4 == 3]
    split["embedding decode (ecc_decode)"] = sum(emb)
    split["router decodes (ecc_decode)"] = sum(router)
    split["expert-leaf decodes (ecc_decode)"] = sum(ms_) - sum(emb) - \
        sum(router)
    rng = _range_device_ms(torch, prof, ranges)
    split["embedding dequantization (embed_decode)"] = rng["embed_decode"]
    split["MLA glue (mla)"] = rng["mla"]
    split["router (moe_router)"] = rng["moe_router"]
    split["routed experts: dequantization, products, gathers "
          "(moe_experts)"] = rng["moe_experts"]
    split["the rest (norms, residual adds, shared-expert SiLU, argmax)"] = \
        busy - sum(split.values())
    spans = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and e.key in ranges}
    log(f"{cfg.name} profile: {len(dec)} ecc_decode kernel events of the "
        f"{launched} launched ({n} x {per}); the ranges' device-side spans "
        f"(first to last kernel, ms over {n} steps): {spans}")
    log(f"{cfg.name} decode profile split (device ms over {n} steps, "
        f"{busy:.2f} busy of {wall_ms:.2f} wall, "
        f"{100 * busy / wall_ms:.1f}%): " +
        ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    del cache
    return {"steps": n, "wall_ms": wall_ms, "busy_ms": busy,
            "busy_share": busy / wall_ms, "split_ms": split,
            "range_spans_ms": spans, "decode_events": len(dec),
            "launches": sum(e.count for e in kernels)}


# ---------------------------------------------------------------------------
# phase 17: the paper's Table 2 — VGG16, ResNet18 and SqueezeNet at full width
# ---------------------------------------------------------------------------


# Every published conv and fc width at ImageNet's 224 input; the one cut is
# the head: the synthetic task's 4 classes, not 1,000 (the repo holds no
# dataset). Pretraining and WOT fine-tuning are cut to a few steps. The
# synthetic task's classes are white-noise templates, which ResNet18's
# global average pool over a 7 x 7 map cannot tell apart: at 224 it stays
# at chance (read on the card: 0.25-0.30 after 20 + 10 steps), so its
# Table 2 is repeated at the reference experiment's 32 x 32 input
# (CNN_LEARN_IMG; every width kept, ResNet18's weights do not depend on
# the input size), where it learns (0.87 after 20 Adam steps on the CPU).
CNN_IMG, CNN_LEARN_IMG, CNN_CLASSES = 224, 32, 4
CNN_PRE_STEPS, CNN_WOT_STEPS = 20, 10
CNN_RATES = (1e-6, 1e-5, 1e-4, 1e-3, 3e-3)   # the reference's Table-2 rates
CNN_TRIALS = 2
CNN_SMALL_RATES = (1e-4, 1e-3)               # VGG16 and SqueezeNet
TABLE2_SCHEMES = ("faulty", "parity-zero", "secded72", "in-place")


def cell_block_hits(torch, enc, key, r, t, rate, max_rate, dev) -> dict:
    """Recompute campaign cell (r, t)'s flips over the protected leaves of
    an encoded tree without check bytes (``in-place``): each leaf's
    positions drawn from the cell's generator in tree order, as
    ``faults.inject_torch_rate`` draws them, repeats cancelled; -> the
    number of 64-bit blocks hit ("blocks"), with 1, 2 and 3 flips, with an
    odd number ("odd"), and with an even number of 4 or more ("even4")."""
    from repro_torch import tree
    from repro_torch.core import faults
    from repro_torch.protection import campaign
    from repro_torch.protection.tensor import is_protected_tensor

    gen = campaign.cell_generator(key, r, t, dev)
    hist = {"blocks": 0, 1: 0, 2: 0, 3: 0, "odd": 0, "even4": 0}
    for _, pt in tree.leaves_with_path(enc):
        if not is_protected_tensor(pt):
            continue
        if pt.checks is not None:
            fail("cell_block_hits counts images without check bytes only")
        pos = faults.rate_positions(pt.enc.numel() * 8, rate, gen, max_rate,
                                    device=dev)
        uniq, cnt = torch.unique(pos, return_counts=True)
        _, hits = torch.unique(uniq[cnt % 2 == 1] // 64, return_counts=True)
        hist["blocks"] += int(hits.numel())
        for k in (1, 2, 3):
            hist[k] += int((hits == k).sum())
        hist["odd"] += int((hits % 2 == 1).sum())
        hist["even4"] += int(((hits >= 4) & (hits % 2 == 0)).sum())
    return hist


def check_inplace_counts(what, cor, due, hits) -> None:
    """The in-place code's accounting of one cell against its recomputed
    flips: every block with an odd number of flips reads as a single
    (columns of odd weight; a triple is miscorrected), so ``corrected``
    equals the odd blocks; ``due`` equals the double-flip blocks where no
    block took 4+ (an even 4+ may cancel to a zero syndrome)."""
    if hits[3] == 0 and hits["even4"] == 0 and (cor, due) != (hits[1],
                                                               hits[2]):
        fail(f"{what}: corrected/DUE {cor}/{due} != the blocks hit once "
             f"and twice {hits[1]}/{hits[2]}")
    if cor != hits["odd"]:
        fail(f"{what}: corrected {cor} != the blocks with an odd number of "
             f"flips {hits['odd']}")
    if not hits[2] <= due <= hits[2] + hits["even4"]:
        fail(f"{what}: DUE {due} outside [{hits[2]}, "
             f"{hits[2] + hits['even4']}] (double-flip blocks, + even 4+)")


def _cnn_cell_split(torch, enc, fwd, images, rate, be):
    """CUDA-event ms of one campaign cell's three parts over ``enc``:
    inject (every protected leaf's image copied and flipped at ``rate``),
    decode (every leaf, on route ``be``, to f32) and the forward over the
    eval images."""
    from repro_torch import tree
    from repro_torch.core import faults
    from repro_torch.protection import policy as policy_mod
    from repro_torch.protection.tensor import is_protected_tensor

    gen = torch.Generator(device=images.device)
    gen.manual_seed(99)
    leaves = [(p, pt) for p, pt in tree.leaves_with_path(enc)
              if is_protected_tensor(pt)]

    def inject():
        return {p: policy_mod._with_image(pt, faults.inject_torch_rate(
            policy_mod._image(pt), rate, gen, rate)[0]) for p, pt in leaves}

    inj_ms, dirty = event_ms(torch, inject)
    dec_ms, dec = event_ms(torch, lambda: tree.map_with_path(
        lambda p, x: policy_mod.decode_leaf(dirty[p], torch.float32,
                                            backend=be)
        if p in dirty else x, enc))
    with torch.no_grad():
        fwd(dec, images)   # warm: the cuDNN algorithms are chosen
        fwd_ms, _ = event_ms(torch, lambda: fwd(dec, images))
    return {"inject_ms": inj_ms, "decode_ms": dec_ms, "forward_ms": fwd_ms}


def _decode_cell_row(torch, enc, timer, rate=1e-3):
    """Row 1c: ``ecc_decode`` over one in-place campaign cell (every
    protected leaf's dirty image, one launch a leaf) against its plain
    version; bound 8 bytes read and 9 written per block."""
    from repro_torch import tree
    from repro_torch.core import faults
    from repro_torch.kernels import ecc_decode
    from repro_torch.protection.tensor import is_protected_tensor

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    imgs = [faults.inject_torch_rate(pt.enc.reshape(-1), rate, gen, rate)[0]
            .view(-1, 8) for _, pt in tree.leaves_with_path(enc)
            if is_protected_tensor(pt)]
    for x in imgs:
        kd, kf = ecc_decode.ecc_decode(x)
        pd, pf = ecc_decode.ecc_decode_plain(x)
        if not (torch.equal(kd, pd) and torch.equal(kf, pf)):
            fail("ecc_decode disagrees with its plain version on a campaign "
                 "cell's image")
    nblk = sum(x.shape[0] for x in imgs)
    bms, by = bound_ms(17 * nblk)
    return dict(
        leaves=len(imgs), blocks=nblk, rate=rate,
        ms=timer.ms(lambda: [ecc_decode.ecc_decode(x) for x in imgs]),
        plain_ms=timer.ms(lambda: [ecc_decode.ecc_decode_plain(x)
                                   for x in imgs]),
        bound_ms=bms, bound_by=by, library_ms=None, max_abs_err=0.0)


def _table2_lines(name, results, rates):
    log(f"Table 2, {name} (drop of top-1 accuracy in %, mean ± std over "
        f"trials; clean {results[next(iter(results))].clean:.4f}):")
    log(f"  {'scheme':11s} {'ovh%':5s} " +
        " ".join(f"{r:>13.0e}" for r in rates))
    for scheme, res in results.items():
        cells = " ".join(f"{d * 100:6.2f}±{s * 100:4.1f}"
                         for d, s in res.row())
        log(f"  {scheme:11s} {res.space_overhead * 100:4.1f}%  {cells}")


def _campaign_record(res) -> dict:
    return {"clean": res.clean, "grid": res.grid, "drop": res.drop(),
            "std": res.std(), "space_overhead": res.space_overhead,
            "warmup_s": res.compile_s, "sweep_s": res.wall_clock_s,
            "cells": len(res.rates) * res.trials,
            "ms_per_cell": 1e3 * res.wall_clock_s /
            max(len(res.rates) * res.trials, 1)}


def cnn_resnet18(torch, dev, scale, img, pre_steps, wot_steps, report, tag):
    """The paper's whole pipeline on ResNet18 (see :func:`phase_cnn`) at
    input ``img``, reported under ``tag``. -> (params, fwd, templates)."""
    from repro_torch.training import cnn_experiments as ce

    t0 = time.time()
    params, fwd, tmpl = ce.pretrain("resnet18", steps=pre_steps, scale=scale,
                                    img=img, n_classes=CNN_CLASSES,
                                    device=dev)
    sync(torch, dev)
    pre_s = time.time() - t0
    acc = {"f32": ce.accuracy(params, fwd, tmpl, img=img),
           "int8": ce.accuracy(params, fwd, tmpl, quantized=True, img=img)}
    large0 = ce.large_count(params)
    t0 = time.time()
    params, tmpl, _ = ce.wot_finetune(params, fwd, tmpl, steps=wot_steps,
                                      n_classes=CNN_CLASSES, img=img)
    sync(torch, dev)
    wot_s = time.time() - t0
    large = ce.large_count(params)
    acc["wot_int8"] = ce.accuracy(params, fwd, tmpl, quantized=True, img=img)
    n = sum(int(w.numel()) for _, w in _cnn_leaves(params))
    log(f"{tag} ({n} weights of >= 2 dims in {len(_cnn_leaves(params))} "
        f"leaves, {img} x {img} input): {pre_steps} Adam steps in "
        f"{pre_s:.1f}s, {wot_steps} WOT "
        f"steps in {wot_s:.1f}s; large values in protected positions "
        f"{large0} -> {large}; accuracy {acc}")
    if large != 0:
        fail(f"{tag} after WOT fine-tuning: {large} large values in "
             f"protected positions")
    report[tag] = {"weights": n, "img": img, "pretrain_s": pre_s,
                   "wot_s": wot_s, "large_before": large0, "accuracy": acc}
    return params, fwd, tmpl


def _cnn_leaves(params):
    from repro_torch import tree
    return [(p, w) for p, w in tree.leaves_with_path(params) if w.ndim >= 2]


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cnn_table2(torch, dev, params, fwd, tmpl, img, report, tag):
    """ResNet18's Table 2 on the kernel route and the plain route, fed the
    same per-cell seeds: equal accuracy grids cell for cell and equal
    clean values; the same for a grid of each cell's logit sum (f64 over
    the 256 x 4 eval logits), which any decoded byte that differs would
    move, so the routes agree on every cell's forward, not only on its
    argmaxes; zero-rate cells equal clean. -> {scheme: kernel-route
    accuracy result}."""
    from repro_torch.data import synthetic
    from repro_torch.protection import campaign
    from repro_torch.training import cnn_experiments as ce

    b, _ = synthetic.image_batch(CNN_CLASSES, 256, img, seed=777, step=0,
                                 templates=tmpl)
    images = ce._norm(torch.as_tensor(b["images"], device=dev))

    def logit_sum(dec):
        return fwd(dec, images).to(torch.float64).sum()

    out, sums = {}, {}
    for route in ("cuda", "torch"):
        out[route], sums[route] = {}, {}
        for i, s in enumerate(TABLE2_SCHEMES):
            out[route][s] = ce.run_scheme_campaign(
                params, fwd, tmpl, s, rates=CNN_RATES, trials=CNN_TRIALS,
                key=i, batch="scan", n_classes=CNN_CLASSES, img=img,
                backend=route, device=dev)
            sums[route][s] = campaign.run_campaign(
                params, None, None, ce.eval_policy(s, backend=route),
                rates=CNN_RATES, trials=CNN_TRIALS, key=i, batch="scan",
                eval_fn=logit_sum, device=dev)
    for s in TABLE2_SCHEMES:
        for what, res in (("accuracy", out), ("logit-sum", sums)):
            k, p = res["cuda"][s], res["torch"][s]
            if k.grid != p.grid or k.clean != p.clean:
                fail(f"{tag} {s} {what}: the kernel route's grid {k.grid} "
                     f"(clean {k.clean}) != the plain route's {p.grid} "
                     f"({p.clean})")
        z = ce.run_scheme_campaign(params, fwd, tmpl, s, rates=(0.0,),
                                   trials=1, key=50, batch="scan",
                                   n_classes=CNN_CLASSES, img=img,
                                   backend="cuda", device=dev)
        if z.grid != ((out["cuda"][s].clean,),):
            fail(f"{tag} {s}: the zero-rate cell {z.grid} != clean "
                 f"{out['cuda'][s].clean}")
    top = sums["cuda"]["faulty"]
    if all(v == top.clean for v in top.grid[-1]):
        fail(f"{tag}: faulty flips at {CNN_RATES[-1]} left every logit sum "
             f"at its clean value")
    log(f"{tag} Table 2: the kernel and plain routes give equal accuracy "
        f"and logit-sum grids, cell for cell, and equal clean values under "
        f"all four schemes; zero-rate cells equal clean")
    _table2_lines(f"{tag} ({img} x {img})", out["cuda"], CNN_RATES)
    report[tag]["table2"] = {s: _campaign_record(r)
                             for s, r in out["cuda"].items()}
    report[tag]["logit_sum_grids"] = {s: r.grid
                                      for s, r in sums["cuda"].items()}
    report[tag]["table2_plain_route_sweep_s"] = {
        s: r.wall_clock_s for s, r in out["torch"].items()}
    return out["cuda"]


def cnn_inplace_accounting(torch, dev, params, report):
    """ResNet18's in-place tree: the DUE, corrected and fidelity campaigns
    on both routes (equal), every cell's counts against its recomputed
    flips, and the compute (ABFT) campaigns (no checksum fires at rate
    0)."""
    from repro_torch.protection import campaign
    from repro_torch.training import cnn_experiments as ce

    enc = ce.eval_policy("in-place", backend="cuda").encode_tree(params)
    nw = sum(pt.n_weights for pt in _protected(enc))
    res = {}
    for route in ("cuda", "torch"):
        pol = ce.eval_policy("in-place", backend=route)
        for what in ("due", "corrected"):
            res[route, what] = campaign.due_campaign(
                enc, pol, rates=CNN_RATES, trials=CNN_TRIALS, key=20,
                batch="scan", what=what, device=dev)
        res[route, "fidelity"] = campaign.fidelity_campaign(
            enc, pol, rates=CNN_RATES, trials=CNN_TRIALS, key=20,
            batch="scan", device=dev)
    for what in ("due", "corrected", "fidelity"):
        if res["cuda", what].grid != res["torch", what].grid:
            fail(f"resnet18 in-place {what}: kernel route "
                 f"{res['cuda', what].grid} != plain route "
                 f"{res['torch', what].grid}")
    hist = []
    for r, rate in enumerate(CNN_RATES):
        for t in range(CNN_TRIALS):
            h = cell_block_hits(torch, enc, 20, r, t, rate, max(CNN_RATES),
                                dev)
            hist.append(h)
            check_inplace_counts(f"resnet18 cell ({rate:g}, {t})",
                                 int(res["cuda", "corrected"].grid[r][t]),
                                 int(res["cuda", "due"].grid[r][t]), h)
            fid = res["cuda", "fidelity"].grid[r][t]
            many = h["blocks"] - h[1]
            if fid < 1 - 8 * many / nw or (many == 0 and fid != 1.0):
                fail(f"resnet18 cell ({rate:g}, {t}): fidelity {fid} with "
                     f"{many} blocks of 2+ flips over {nw} weights")
    log(f"resnet18 in-place: corrected, DUE and fidelity grids equal on "
        f"both routes; every cell's counts match its recomputed flips "
        f"(blocks with 1/2/3 flips per cell: "
        f"{[(h[1], h[2], h[3]) for h in hist]}); DUE "
        f"{res['cuda', 'due'].grid}")
    comp = {}
    for j, tgt in enumerate(("acc", "wdec")):
        c = campaign.compute_campaign(params, rates=(1e-3, 1e-2, 1e-1),
                                      trials=CNN_TRIALS, key=100 + j,
                                      target=tgt, probe_m=64, device=dev)
        if c.clean != 0.0:
            fail(f"compute campaign ({tgt}): {c.clean} checksums fired at "
                 f"rate 0")
        comp[tgt] = {"coverage": c.grid, "rows": c.coverage_rows}
        log(f"resnet18 ABFT coverage ({tgt}): {c.mean()} at {c.rates}; no "
            f"checksum fires at rate 0")
    report["resnet18"]["inplace"] = {
        "due": res["cuda", "due"].grid,
        "corrected": res["cuda", "corrected"].grid,
        "fidelity": res["cuda", "fidelity"].grid, "block_hits": hist,
        "compute": comp}
    return enc


def cnn_seeded(torch, dev, name, scale, img, report, *, vmap=False):
    """``name`` built from seed 0 at ``scale`` (no training): in-place and
    faulty campaigns at CNN_SMALL_RATES x CNN_TRIALS on the kernel route;
    with ``vmap`` the in-place grid is also run batched and must equal the
    one-cell-at-a-time grid. -> (params, fwd, templates)."""
    from repro_torch.data import synthetic
    from repro_torch.models import cnn
    from repro_torch.training import cnn_experiments as ce

    init, fwd = cnn.CNNS[name]
    t0 = time.time()
    params = init(0, n_classes=CNN_CLASSES, scale=scale, img_size=img,
                  device=dev)
    _, tmpl = synthetic.image_batch(CNN_CLASSES, 1, img, seed=0, step=0)
    res = {}
    for i, s in enumerate(("in-place", "faulty")):
        res[s] = ce.run_scheme_campaign(
            params, fwd, tmpl, s, rates=CNN_SMALL_RATES, trials=CNN_TRIALS,
            key=30 + i, batch="scan", n_classes=CNN_CLASSES, img=img,
            device=dev)
    if vmap:
        v = ce.run_scheme_campaign(
            params, fwd, tmpl, "in-place", rates=CNN_SMALL_RATES,
            trials=CNN_TRIALS, key=30, batch="vmap", n_classes=CNN_CLASSES,
            img=img, device=dev)
        if v.grid != res["in-place"].grid or v.clean != res["in-place"].clean:
            fail(f"{name}: batch=vmap grid {v.grid} != batch=scan "
                 f"{res['in-place'].grid}")
        log(f"{name}: batch=vmap equals batch=scan cell for cell "
            f"({v.wall_clock_s:.3f}s against "
            f"{res['in-place'].wall_clock_s:.3f}s)")
    n = sum(int(w.numel()) for _, w in _cnn_leaves(params))
    log(f"{name} ({n} weights of >= 2 dims in {len(_cnn_leaves(params))} "
        f"leaves), seeded: campaigns in {time.time() - t0:.1f}s")
    _table2_lines(name, res, CNN_SMALL_RATES)
    report[name] = {"weights": n, "leaves": len(_cnn_leaves(params)),
                    "table2": {s: _campaign_record(r)
                               for s, r in res.items()}}
    return params, fwd, tmpl


def phase_cnn(torch, dev, build, *, scale=1.0, img=CNN_IMG,
              learn_img=CNN_LEARN_IMG, pre_steps=CNN_PRE_STEPS,
              wot_steps=CNN_WOT_STEPS):
    """The paper's experiment at full width (``scale`` 1.0, 224 input):
    ResNet18 through the whole pipeline (Adam pretraining, WOT fine-tuning
    through the ``quantize_throttle`` kernel to ``large_count == 0``, the
    four schemes' Table 2 on the kernel and plain routes; at the 32 x 32
    input too, where the synthetic task is learnable: see CNN_LEARN_IMG),
    the in-place accounting, fidelity and compute campaigns (224), VGG16 and SqueezeNet from
    a seed (in-place and faulty campaigns; SqueezeNet's batched layout
    against the one-cell one), each model's campaign cell split into
    inject, decode and forward (CUDA events), and row 1c (``ecc_decode``
    over one campaign cell of VGG16 and of ResNet18). The convs run in
    f32: TF32 is off (``main``), and cuDNN runs deterministic algorithms
    here so both routes' forwards over equal weights agree bit for bit.
    -> (launch counts, row 1c entries)."""
    from repro_torch.data import synthetic
    from repro_torch.training import cnn_experiments as ce

    report = {"img": img, "learn_img": learn_img, "scale": scale,
              "classes": CNN_CLASSES,
              "pre_steps": pre_steps, "wot_steps": wot_steps,
              "rates": CNN_RATES, "trials": CNN_TRIALS}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    log(f"phase 17: convs in f32 (TF32 off: cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}), cuDNN deterministic")
    try:
        t0 = time.time()
        b, tm = synthetic.image_batch(CNN_CLASSES, 64, img, seed=0, step=0)
        t1 = time.time()
        synthetic.image_batch(CNN_CLASSES, 256, img, seed=777, step=0,
                              templates=tm)
        report["host_images_s"] = {"train_batch_64": t1 - t0,
                                   "eval_batch_256": time.time() - t1}
        log(f"host image synthesis (NumPy): a 64-image train batch "
            f"{t1 - t0:.2f}s, the 256-image eval batch "
            f"{time.time() - t1:.2f}s")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        build.reset_counts()
        p32, f32_, t32 = cnn_resnet18(torch, dev, scale, learn_img,
                                      pre_steps, wot_steps, report,
                                      "resnet18_32")
        cnn_table2(torch, dev, p32, f32_, t32, learn_img, report,
                   "resnet18_32")
        del p32
        params, fwd, tmpl = cnn_resnet18(torch, dev, scale, img, pre_steps,
                                         wot_steps, report, "resnet18")
        cnn_table2(torch, dev, params, fwd, tmpl, img, report, "resnet18")
        enc = cnn_inplace_accounting(torch, dev, params, report)
        models = {"resnet18": (params, fwd, tmpl, enc)}
        for name in ("vgg16", "squeezenet"):
            p, f, tm = cnn_seeded(torch, dev, name, scale, img, report,
                                  vmap=name == "squeezenet")
            models[name] = (p, f, tm, ce.eval_policy(
                "in-place", backend="cuda").encode_tree(p))
        counts = dict(build.COUNTS)
        rows = {}
        if dev.type == "cuda":
            timer = Timer(torch, dev)
            for name, (p, f, tm, e) in models.items():
                bt, _ = synthetic.image_batch(CNN_CLASSES, 256, img,
                                              seed=777, step=0, templates=tm)
                images = ce._norm(torch.as_tensor(bt["images"], device=dev))
                split = _cnn_cell_split(torch, e, f, images, 1e-3, "cuda")
                report[name]["cell_split_ms"] = split
                log(f"{name} campaign cell at 1e-3 (device ms, CUDA "
                    f"events): {split}")
                if name != "squeezenet":
                    rows[name] = _decode_cell_row(torch, e, timer)
                    log(f"ecc_decode over one {name} campaign cell: "
                        f"{rows[name]}")
            report["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    finally:
        torch.backends.cudnn.deterministic = deterministic
    log(f"launch counts over the CNN path: {counts}; peak device memory "
        f"{report.get('peak_gb', 0.0):.2f} GB")
    report["row_1c"] = rows
    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / "chip_smoke_cnn.json", "w") as fh:
        json.dump(report, fh, indent=1, default=str)
    return counts, rows


# ---------------------------------------------------------------------------
# phase 18: the serve CLI's fault smoke-check at full width
# ---------------------------------------------------------------------------


SMOKE_RATE, SMOKE_TRIALS, SMOKE_SEED = 1e-4, 2, 0


def phase_smoke_check(torch, dev, build, cfg, *, tokens=4):
    """``fault_smoke_check`` (the serve CLI's check before a faulted serve:
    decode fidelity and DUE campaigns at SMOKE_RATE / 10, x 1, x 10 x
    SMOKE_TRIALS, one cell at a time) on ``cfg``'s encoded tree, then
    ``serve`` over the same tree (no second deploy) with SMOKE_RATE
    injected. Every cell's flips are recomputed from its seed: in-place
    fidelity at least 1 - 8 (blocks of 2+ flips) / weights, exactly 1.0
    where no block took two, and DUE counts equal to the double-flip
    blocks (where no block took an even 4+). Reports the check's seconds
    and peak device memory. -> the launch counts of the path."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import lm
    from repro_torch.protection import policy as policy_mod

    if dev.type == "cuda":
        torch.cuda.empty_cache()
    build.reset_counts()
    policy = policy_mod.ProtectionPolicy(backend="cuda" if dev.type ==
                                         "cuda" else "torch")
    plan = policy.plan(lm.param_shapes(cfg))
    t0 = time.time()
    enc = lm.init_params(cfg, SMOKE_SEED, device=dev,
                         leaf_fn=plan.encode_leaf)
    sync(torch, dev)
    leaves = _protected(enc)
    nw = sum(pt.n_weights for pt in leaves)
    log(f"{cfg.name}: drew and encoded {len(leaves)} protected leaves "
        f"({sum(pt.enc.numel() for pt in leaves) / 1e9:.3f} GB of image) in "
        f"{time.time() - t0:.1f}s")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t0 = time.time()
    fid, due = serve_mod.fault_smoke_check(
        enc, policy, SMOKE_RATE, SMOKE_SEED, trials=SMOKE_TRIALS,
        out_path=str(OUT_DIR / "chip_smoke_campaign.json"), device=dev,
        log=log)
    sync(torch, dev)
    check_s = time.time() - t0
    peak = extra = 0.0
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated() / 1e9
        extra = peak - base / 1e9
    log(f"smoke-check over {cfg.name}: {check_s:.2f}s (fidelity warm-up "
        f"{fid.compile_s:.2f}s, sweep {fid.wall_clock_s:.2f}s; DUE warm-up "
        f"{due.compile_s:.2f}s, sweep {due.wall_clock_s:.2f}s); peak device "
        f"memory {peak:.2f} GB, {extra:.2f} GB over the resident image")
    fkey, dkey = SMOKE_SEED + 1, SMOKE_SEED + 2
    cells = []
    for r, rate in enumerate(fid.rates):
        for t in range(SMOKE_TRIALS):
            hf = cell_block_hits(torch, enc, fkey, r, t, rate, max(fid.rates),
                                 dev)
            many = hf["blocks"] - hf[1]
            f = fid.grid[r][t]
            if f < 1 - 8 * many / nw or (many == 0 and f != 1.0):
                fail(f"smoke-check cell ({rate:g}, {t}): fidelity {f} with "
                     f"{many} blocks of 2+ flips over {nw} weights")
            hd = cell_block_hits(torch, enc, dkey, r, t, rate, max(due.rates),
                                 dev)
            d = int(due.grid[r][t])
            if (hd["even4"] == 0 and d != hd[2]) or \
                    not hd[2] <= d <= hd[2] + hd["even4"]:
                fail(f"smoke-check cell ({rate:g}, {t}): DUE {d} != the "
                     f"double-flip blocks {hd[2]} (even 4+: {hd['even4']})")
            cells.append({"rate": rate, "trial": t, "fidelity": f,
                          "blocks_2plus": many, "due": d,
                          "due_blocks": {k: hd[k] for k in (1, 2, 3, "even4")}})
    log(f"smoke-check cells hold against their recomputed flips: "
        f"{[(c['rate'], c['fidelity'], c['blocks_2plus'], c['due']) for c in cells]}")
    r = serve_mod.serve(cfg, weights=enc, fault_rate=SMOKE_RATE,
                        seed=SMOKE_SEED, tokens=tokens, batch=4,
                        backend=policy.backend.name, device=dev, log=log)
    if not bool(torch.isfinite(r["logits"].float()).all()):
        fail("the serve after the smoke-check gave non-finite logits")
    counts = dict(build.COUNTS)
    log(f"launch counts over the smoke-check path: {counts}")
    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / "chip_smoke_smoke_check.json", "w") as fh:
        json.dump({"config": cfg.name, "weights": nw, "seconds": check_s,
                   "peak_gb": peak, "over_image_gb": extra,
                   "fidelity": fid.to_dict(), "due": due.to_dict(),
                   "cells": cells, "serve_flags": r["flags"],
                   "serve_step_ms": r["step_ms"]}, fh, indent=1,
                  default=str)
    del enc
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return counts

# ---------------------------------------------------------------------------
# phase 19: the rest of training — QATT of the hybrid and ssm families at
# full width, crash and resume, the protected checkpoint, ADMM against QATT
# ---------------------------------------------------------------------------


# mamba2-2.7b's QATT would fit all 64 layers (2.83 G parameters x 12 B:
# f32 masters, momentum, one gradient set = 34.0 GB, 40.46 GB at its peak
# on the card) but takes 12-19 s a step there; the card run's time limit
# cuts it to SSM_QATT_LAYERS and 2 steps, and recurrentgemma-2b's QATT
# (all 26 layers: 2.89 G parameters, 34.7 GB; peak 40.04) to 2 steps.
# Time, not memory, also cuts the f32 step on both routes to
# the trained masters' first F32_LAYERS layers (f32 without tensor cores
# is several times a bf16 step), and the step profiles to one 1 x 2,048
# microbatch (a whole step launches hundreds of thousands of kernels,
# and the profiler's processing of them takes minutes).
SSM_QATT_LAYERS = 16
F32_LAYERS = 8
CKPT_LAYERS = 2          # the checkpoint cells: 0.34 G parameters
CKPT_STEPS, CKPT_EVERY, CKPT_CRASH = 6, 2, 3
CKPT_FLIPS = 1024        # blocks flipped in each protected image on disk
ADMM_STEPS, ADMM_PRE_STEPS = 25, 80   # the reference benchmark's


@contextlib.contextmanager
def deterministic(torch):
    """``torch.use_deterministic_algorithms(True)`` inside the block
    (``CUBLAS_WORKSPACE_CONFIG`` is set before CUDA starts, in ``main``):
    an op without a deterministic CUDA form raises, naming itself."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _batch(torch, dev, cfg, step, *, batch=8, seq=2048):
    from repro_torch.data import synthetic
    b = synthetic.token_batch(cfg.vocab_padded, batch, seq, seed=0,
                              step=step)
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def _bits_equal(torch, a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        torch.equal(_bits(torch, a), _bits(torch, b)))


def _trees_bit_equal(torch, a, b) -> tuple:
    """-> (every leaf bit-equal, the largest |a - b| over the leaves)."""
    from repro_torch import tree
    la = [t for _, t in tree.leaves_with_path(a)]
    lb = [t for _, t in tree.leaves_with_path(b)]
    if len(la) != len(lb):
        fail(f"trees of {len(la)} and {len(lb)} leaves")
    same, worst = True, 0.0
    for x, y in zip(la, lb):
        if not _bits_equal(torch, x, y):
            same = False
            worst = max(worst, float((x.float() - y.float()).abs().max()))
    return same, worst


def phase_train_rest(torch, dev, build):
    """Phase 19: the trainer side that phases 7, 11 and 12 leave out.

    * QATT of recurrentgemma-2b at full width and depth (:func:
      `phase_train`: 2 steps of 8 x 2,048 tokens in 8 microbatches, the
      last one's throttle on both routes, deploy on both routes, 8 served
      steps at batch 4 on its dense cache clean and correctable-only) and
      a profile of a one-microbatch step;
    * QATT of mamba2-2.7b at full width cut to SSM_QATT_LAYERS layers
      (:func:`ssm_train`: 2 steps, a profile), then one f32 step on both routes from the same
      masters (the first ``F32_LAYERS``), momentum and batch under
      deterministic algorithms; and the f32 gradient of a full-width
      2-layer mamba2 over 1 x 2,048 tokens with its blocks remat'ed
      against the same without remat, where autograd's version check
      would catch a write into a saved tensor (the SSD fault);
    * crash and resume (:func:`ckpt_crash_resume`) and the protected
      checkpoint of ``launch.train.train`` (:func:`ckpt_protected`) on
      full-width mamba2-2.7b cut to 2 layers;
    * ADMM against QATT on ResNet18 at full width and 32 x 32
      (:func:`admm_vs_qatt`).

    Writes ``chip_smoke_train19.json``. -> the launch counts of the
    path."""
    from repro_torch.configs import get

    report = {}
    build.reset_counts()
    t0 = time.time()
    rg = get("recurrentgemma-2b")
    _, params = phase_train(torch, dev, build, rg, steps=2, kv_policy=None,
                            fname="chip_smoke_train_hybrid.json")
    report["recurrentgemma-2b"] = json.loads(
        (OUT_DIR / "chip_smoke_train_hybrid.json").read_text())
    report["recurrentgemma-2b"]["profile"] = phase_train_profile(
        torch, dev, rg.with_(microbatch=1), params, batch=1,
        fname="chip_smoke_train_hybrid_profile.txt")
    del params
    torch.cuda.empty_cache()
    report["recurrentgemma-2b"]["seconds"] = time.time() - t0
    t0 = time.time()
    report["mamba2-2.7b"] = ssm_train(
        torch, dev, get("mamba2-2.7b").with_(n_layers=SSM_QATT_LAYERS),
        steps=2)
    report["mamba2-2.7b"]["seconds"] = time.time() - t0
    small = get("mamba2-2.7b").with_(n_layers=CKPT_LAYERS)
    t0 = time.time()
    report["remat_guard"] = ssm_remat_guard(torch, dev, small)
    report["crash_resume"] = ckpt_crash_resume(torch, dev, small)
    report["protected_checkpoint"] = ckpt_protected(torch, dev, small)
    report["checkpoint_seconds"] = time.time() - t0
    t0 = time.time()
    report["admm_vs_qatt"] = admm_vs_qatt(torch, dev)
    report["admm_vs_qatt"]["seconds"] = time.time() - t0
    counts = dict(build.COUNTS)
    log(f"launch counts over the rest-of-training path: {counts}")
    with open(OUT_DIR / "chip_smoke_train19.json", "w") as fh:
        json.dump(report, fh, indent=1, default=str)
    return counts


def ssm_train(torch, dev, cfg, *, steps=3, batch=8, seq=2048,
              lr=1e-4) -> dict:
    """QATT of ``cfg`` through ``launch.train.train`` on the kernel route
    (ms/step, peak memory), a profile of one more step over one 1 x
    ``seq`` microbatch, then one f32 step (f32 weights and activations) of
    the trained masters' first ``F32_LAYERS`` layers on both routes from
    the same masters, momentum and batch under deterministic algorithms:
    masters and momentum must be bit-equal (the throttle is the only
    route-dependent part, and deterministic algorithms leave no
    atomic-order noise)."""
    from repro_torch import tree
    from repro_torch.launch.train import train
    from repro_torch.models import lm
    from repro_torch.training import train as train_mod

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = train(cfg, steps=steps, batch=batch, seq=seq, lr=lr, seed=0,
                chunk=2048, backend="cuda", device=dev, log=log)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses, step_ms = out["losses"], out["step_ms"]
    if not all(math.isfinite(x) for x in losses):
        fail(f"{cfg.name} QATT losses not finite: {losses}")
    med = statistics.median(step_ms[1:])
    log(f"QATT {cfg.name} x {cfg.n_layers} layers, batch {batch} x {seq}: "
        f"losses {losses}; ms/step {[round(x, 2) for x in step_ms]}; median "
        f"of steps 2..{steps} {med:.2f} ms/step, "
        f"{batch * seq / med * 1e3:.1f} tokens/s; peak device memory "
        f"{peak_gb:.2f} GB")
    params, opt = out["params"], out["opt_state"]
    del out
    profile = phase_train_profile(torch, dev, cfg.with_(microbatch=1), params,
                                  batch=1,
                                  fname="chip_smoke_train_ssm_profile.txt")
    cut = cfg.with_(n_layers=min(F32_LAYERS, cfg.n_layers))

    def first_layers(path, t):   # the stacked leaves of params and opt
        return (t[:cut.n_layers] if "layers" in path else t).clone()
    state = [(tree.map_with_path(first_layers, params),
              tree.map_with_path(first_layers, opt)) for _ in range(2)]
    del params, opt
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    b = _batch(torch, dev, cfg, steps)
    res, f32_ms = {}, {}
    for route, (p, o) in zip(("cuda", "torch"), state):
        step = train_mod.make_train_step(
            cut, lr=lr, chunk=2048, bf16_weights=False, backend=route,
            loss_fn=lambda p, b: lm.loss_fn(cut, p, b, wt=train_mod.qat_wt,
                                            dtype=torch.float32, chunk=2048))
        torch.cuda.synchronize()
        with deterministic(torch):
            f32_ms[route], res[route] = event_ms(torch,
                                                 lambda: step(p, o, b))
    f32_peak = torch.cuda.max_memory_allocated() / 1e9
    (kp, ko, kl), (pp, po, pl) = res["cuda"], res["torch"]
    same_w, dw = _trees_bit_equal(torch, kp, pp)
    same_m, dm = _trees_bit_equal(torch, ko.momentum, po.momentum)
    if not (same_w and same_m and float(kl) == float(pl)):
        fail(f"{cfg.name} f32 step: the kernel and plain routes differ: "
             f"masters by {dw}, momentum by {dm}, loss {float(kl)!r} vs "
             f"{float(pl)!r}")
    if not math.isfinite(float(kl)):
        fail(f"{cfg.name} f32 step: loss {float(kl)}")
    log(f"{cfg.name} x {cut.n_layers} (the trained masters' first layers) f32 "
        f"step from the same masters on both routes (deterministic "
        f"algorithms): masters and momentum bit-equal, loss {float(kl):.6f}; "
        f"kernel route {f32_ms['cuda']:.1f} ms, plain route "
        f"{f32_ms['torch']:.1f} ms; peak {f32_peak:.2f} GB")
    del state, res, kp, ko, pp, po
    torch.cuda.empty_cache()
    return {"config": f"{cfg.name} n_layers={cfg.n_layers}", "batch": batch,
            "seq": seq, "losses": losses, "step_ms": step_ms,
            "median_ms": med, "tokens_per_s": batch * seq / med * 1e3,
            "peak_gb": peak_gb, "profile": profile, "f32_layers": cut.n_layers,
            "f32_step_ms": f32_ms, "f32_loss": float(kl),
            "f32_peak_gb": f32_peak}


def ssm_remat_guard(torch, dev, cfg, *, seq=2048) -> dict:
    """The f32 QAT loss's gradient over one 1 x ``seq`` microbatch of
    ``cfg`` with every block remat'ed (``torch.utils.checkpoint``: the
    training path) and without (autograd keeps every saved tensor and its
    version check raises on a write into one): bit-equal leaf for leaf
    under deterministic algorithms."""
    from repro_torch import tree
    from repro_torch.models import lm
    from repro_torch.training import train as train_mod

    params = lm.init_params(cfg, 1, device=dev)
    b = {k: v[:1] for k, v in _batch(torch, dev, cfg, 0, seq=seq).items()}
    grads = {}
    for remat in (True, False):
        c = cfg.with_(remat=remat)
        ws = tree.map_with_path(lambda _, t: t.detach().requires_grad_(),
                                params)
        with deterministic(torch):
            lm.loss_fn(c, ws, b, wt=train_mod.qat_wt, dtype=torch.float32,
                       chunk=2048).backward()
        grads[remat] = tree.map_with_path(lambda _, t: t.grad, ws)
    same, worst = _trees_bit_equal(torch, grads[True], grads[False])
    if not same:
        fail(f"{cfg.name} x {cfg.n_layers}: the f32 gradient with remat "
             f"differs from the one without by {worst}")
    a_log = grads[True]["layers"]["mixer"]["A_log"]
    log(f"{cfg.name} x {cfg.n_layers} f32 gradient: remat'ed blocks "
        f"bit-equal to blocks without remat, every leaf (A_log's gradient "
        f"max {float(a_log.abs().max()):.4e})")
    return {"layers": cfg.n_layers, "seq": seq, "bit_equal": True,
            "a_log_grad_max": float(a_log.abs().max())}


def _ckpt_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def ckpt_crash_resume(torch, dev, cfg, *, lr=1e-4) -> dict:
    """Train ``CKPT_STEPS`` steps with an unprotected ``AsyncCheckpointer``
    every ``CKPT_EVERY``, "crash" after ``CKPT_CRASH`` steps (the saves
    started by then finish, the process state is dropped), resume from
    ``checkpoint.latest_step`` into fresh params and run to the end: the
    final masters and momentum must equal an uninterrupted run's bit for
    bit (both under deterministic algorithms)."""
    import shutil

    from repro_torch.models import lm
    from repro_torch.training import checkpoint, optim
    from repro_torch.training import train as train_mod

    ck_dir = ROOT / "build" / "ckpt_resume"
    shutil.rmtree(ck_dir, ignore_errors=True)
    step = train_mod.make_train_step(cfg, lr=lr, chunk=2048, backend="cuda")

    def fresh():
        params = lm.init_params(cfg, 0, device=dev)
        return params, optim.sgd_init(params)

    def run(params, opt, start, end, ck=None, stop=None):
        for s in range(start, end):
            params, opt, _ = step(params, opt, _batch(torch, dev, cfg, s))
            if ck is not None and (s + 1) % CKPT_EVERY == 0:
                ck.save((params, opt), s + 1)
            if stop is not None and s + 1 == stop:
                break
        return params, opt

    with deterministic(torch):
        t0 = time.time()
        full = run(*fresh(), 0, CKPT_STEPS)
        torch.cuda.synchronize()
        full_s = time.time() - t0
        ck = checkpoint.AsyncCheckpointer(str(ck_dir), device=dev)
        t0 = time.time()
        crashed = run(*fresh(), 0, CKPT_STEPS, ck=ck, stop=CKPT_CRASH)
        ck.wait()
        del crashed                                   # the crash
        s0 = checkpoint.latest_step(str(ck_dir))
        if s0 != CKPT_CRASH // CKPT_EVERY * CKPT_EVERY:
            fail(f"crash after step {CKPT_CRASH}: latest checkpoint {s0}")
        t1 = time.time()
        (params, opt), got = checkpoint.restore(str(ck_dir), fresh(),
                                                device=dev)
        torch.cuda.synchronize()
        restore_s = time.time() - t1
        resumed = run(params, opt, s0, CKPT_STEPS, ck=ck)
        ck.wait()
        torch.cuda.synchronize()
        resumed_s = time.time() - t0
    same_w, dw = _trees_bit_equal(torch, resumed[0], full[0])
    same_m, dm = _trees_bit_equal(torch, resumed[1].momentum,
                                  full[1].momentum)
    if not (same_w and same_m):
        fail(f"resume from step {s0}: masters differ from the uninterrupted "
             f"run by {dw}, momentum by {dm}")
    nbytes = _ckpt_bytes(ck_dir / f"step_{CKPT_STEPS:08d}")
    log(f"crash after step {CKPT_CRASH}, resumed from step {s0} "
        f"({CKPT_STEPS} steps of {cfg.name} x {cfg.n_layers} layers, "
        f"unprotected async checkpoints every {CKPT_EVERY}): final masters "
        f"and momentum bit-equal to the uninterrupted run; restore "
        f"{restore_s:.2f}s; uninterrupted {full_s:.2f}s, crashed + resumed "
        f"{resumed_s:.2f}s; {nbytes / 1e9:.3f} GB a checkpoint")
    shutil.rmtree(ck_dir, ignore_errors=True)
    return {"resumed_from": s0, "bit_equal": True, "restore_s": restore_s,
            "uninterrupted_s": full_s, "crashed_resumed_s": resumed_s,
            "bytes": nbytes}


def ckpt_protected(torch, dev, cfg, *, steps=3, lr=1e-4) -> dict:
    """``launch.train.train(cfg, ckpt=..., ckpt_every=CKPT_EVERY)`` as the
    CLI runs it (protected, in-place ECC): the restore of the last
    checkpoint must equal, for every protected leaf (every weight and its
    momentum), f32(scale) x the throttled int8 of the final state, and
    every other leaf exactly; flips of one bit in each of ``CKPT_FLIPS``
    blocks of every stored image must restore to the same values. Then
    the seconds to save (synchronously) and restore, and the bytes on
    disk, protected against unprotected."""
    import shutil

    import numpy as np

    from repro_torch import tree
    from repro_torch.core import quant, wot
    from repro_torch.launch.train import train
    from repro_torch.training import checkpoint

    ck_dir = ROOT / "build" / "ckpt_protected"
    shutil.rmtree(ck_dir, ignore_errors=True)
    out = train(cfg, steps=steps, batch=8, seq=2048, lr=lr, seed=0,
                chunk=2048, backend="cuda", device=dev, ckpt=str(ck_dir),
                ckpt_every=CKPT_EVERY, log=log)
    state = (out["params"], out["opt_state"])
    del out
    if checkpoint.latest_step(str(ck_dir)) != steps:
        fail(f"protected checkpoint: latest step "
             f"{checkpoint.latest_step(str(ck_dir))}, not {steps}")
    clean, _ = checkpoint.restore(str(ck_dir), state, device=dev)
    n_prot = 0
    for (path, w), (_, r) in zip(tree.leaves_with_path(state),
                                 tree.leaves_with_path(clean)):
        if not wot.is_protected_weight(path, w):
            if not _bits_equal(torch, r, w):
                fail(f"unprotected leaf {tree.path_str(path)} restored "
                     f"other values")
            continue
        n_prot += 1
        scale = torch.tensor(np.float32(float(w.abs().max()) / quant.QMAX),
                             device=dev)
        q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
        q = wot.throttle_q(q.reshape(-1)).reshape(w.shape)
        if not _bits_equal(torch, r, q.to(torch.float32) * scale):
            fail(f"protected leaf {tree.path_str(path)}: restore != scale x "
                 f"the throttled int8 of the saved state")
    d = ck_dir / f"step_{steps:08d}"
    with np.load(d / "arrays.npz") as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads((d / "meta.json").read_text())
    rng = np.random.default_rng(19)
    for i in range(meta["n_leaves"]):
        if meta[f"leaf_{i}"]["protected"]:
            img = arrays[f"leaf_{i}"].reshape(-1, 8)
            n = min(CKPT_FLIPS, img.shape[0])
            blk = rng.choice(img.shape[0], n, replace=False)
            img[blk, rng.integers(0, 8, n)] ^= (
                np.uint8(1) << rng.integers(0, 8, n).astype(np.uint8))
    np.savez(d / "arrays.npz", **arrays)
    del arrays
    flipped, _ = checkpoint.restore(str(ck_dir), state, device=dev)
    same, worst = _trees_bit_equal(torch, flipped, clean)
    if not same:
        fail(f"protected checkpoint with {CKPT_FLIPS} single flips per "
             f"image restored other values (max diff {worst})")
    del flipped, clean
    timing = {}
    for prot in (False, True):
        p = ck_dir / ("prot" if prot else "plain")
        torch.cuda.synchronize()
        t0 = time.time()
        checkpoint.save(str(p), state, step=1, protected=prot, device=dev)
        t1 = time.time()
        checkpoint.restore(str(p), state, device=dev)
        torch.cuda.synchronize()
        timing["protected" if prot else "unprotected"] = {
            "save_s": t1 - t0, "restore_s": time.time() - t1,
            "bytes": _ckpt_bytes(p)}
    pr, un = timing["protected"], timing["unprotected"]
    log(f"protected checkpoint of {cfg.name} x {cfg.n_layers} layers through "
        f"launch.train.train (every {CKPT_EVERY} steps): {n_prot} protected "
        f"leaves (weights and their momenta) restore as scale x the "
        f"throttled int8, exactly; {CKPT_FLIPS} single flips in each stored "
        f"image corrected on restore; save {pr['save_s']:.2f}s vs "
        f"{un['save_s']:.2f}s unprotected, restore {pr['restore_s']:.2f}s vs "
        f"{un['restore_s']:.2f}s, {pr['bytes'] / 1e9:.3f} GB vs "
        f"{un['bytes'] / 1e9:.3f} GB on disk")
    shutil.rmtree(ck_dir, ignore_errors=True)
    del state
    torch.cuda.empty_cache()
    return {"protected_leaves": n_prot, "flips_per_image": CKPT_FLIPS,
            **timing}


def admm_vs_qatt(torch, dev) -> dict:
    """``benchmarks.wot_admm_compare.run`` on ResNet18 at full width and
    32 x 32 (phase 17's resnet18-32 cell), the kernel route: QATT must
    leave no large value in a protected position, nor must ADMM's final
    clamp (``finalize``); ADMM's residual large values before the clamp,
    and those of its Z (the 4-pass projection of W + U), are reported.
    Then the projection's 4 and 8 passes (the Z-step and ``finalize``)
    over ResNet18's leaves on both routes: bit-equal."""
    from repro_torch import tree
    from repro_torch.benchmarks import wot_admm_compare
    from repro_torch.models import cnn
    from repro_torch.training import admm

    rec = {}
    acc0, qatt_acc, admm_acc, admm_large = wot_admm_compare.run(
        "resnet18", steps=ADMM_STEPS, device=dev, scale=1.0, img=CNN_LEARN_IMG,
        pre_steps=ADMM_PRE_STEPS, backend="cuda", record=rec)
    print(f"admm_vs_qatt,{(rec['qatt_s'] + rec['admm_s']) * 1e6:.0f},"
          f"qatt={qatt_acc:.3f}_admm={admm_acc:.3f}"
          f"_admm_residual_large={admm_large}", flush=True)
    if rec["qatt_large"] != 0 or rec["admm_final_large"] != 0:
        fail(f"WOT constraint: QATT leaves {rec['qatt_large']} large values, "
             f"ADMM's finalize {rec['admm_final_large']}")
    log(f"ADMM vs QATT, resnet18 full width at {CNN_LEARN_IMG} x "
        f"{CNN_LEARN_IMG}: pretrained int8 accuracy {acc0:.3f} "
        f"({rec['pretrain_large']} large values); QATT {qatt_acc:.3f} (0 "
        f"large, {rec['qatt_s']:.2f}s); ADMM {admm_acc:.3f} after its clamp, "
        f"{admm_large} large values before it, Z's per step "
        f"{rec['admm_z_large']} ({rec['admm_s']:.2f}s)")
    init, _ = cnn.CNNS["resnet18"]
    w = init(3, n_classes=4, scale=1.0, img_size=CNN_LEARN_IMG, device=dev)
    gen = torch.Generator(device=dev).manual_seed(19)
    wu = tree.map_with_path(lambda _, t: t + t.abs().max() * torch.randn(
        t.shape, generator=gen, device=dev) * 0.3, w)
    proj = {}
    for iters in (4, 8):
        out = {}
        for route in ("cuda", "torch"):
            torch.cuda.synchronize()
            ms, out[route] = event_ms(torch, lambda: admm._project(
                wu, iters, backend=route))
            proj[f"{iters}_{route}_ms"] = ms
        same, worst = _trees_bit_equal(torch, out["cuda"], out["torch"])
        if not same:
            fail(f"the {iters}-pass projection differs between the routes "
                 f"by {worst}")
    log(f"ADMM projection over resnet18's leaves bit-equal on both routes: "
        f"4 passes {proj['4_cuda_ms']:.2f} ms (plain {proj['4_torch_ms']:.2f}),"
        f" 8 passes {proj['8_cuda_ms']:.2f} ms (plain "
        f"{proj['8_torch_ms']:.2f})")
    return {"pretrain_acc": acc0, "qatt_acc": qatt_acc, "admm_acc": admm_acc,
            "admm_residual_large": admm_large, **rec, "projection": proj}


# ---------------------------------------------------------------------------
# phase 4 (a): the whole-tree decode ablations of full-width deepseek-7b
# ---------------------------------------------------------------------------

# decode-at-use (ecc_qmatmul, bf16 out) against the whole-tree decode
# (torch.matmul over the bf16-decoded tree): the two round each projection
# at different points, so at full depth the logits differ by bf16 ulps;
# held to the bf16 full-depth route limits of phase 13
ABLATION_MAX_ATOL, ABLATION_MEAN_ATOL = HYBRID_MAX_ATOL, HYBRID_MEAN_ATOL
ABLATION_STEPS = 6


def decode_ablation(torch, dev, cfg, enc, *, batch=4, steps=ABLATION_STEPS):
    """The reference's whole-tree decode ablations on the kernel route
    (``in-place-fused`` KV), over ``enc``, phase 4's resident tree:
    ``steps`` lockstep steps each (the tokens fed are the decode-at-use
    run's greedy tokens) of the decode-at-use step, of
    ``decode_at_use=False`` (the whole tree decoded every step) and of
    ``decode_per_step=False`` (decoded once outside, its decode timed
    apart). The two whole-tree modes give bit-equal logits; decode at use
    is within ABLATION_*_ATOL of them. -> ms/step, the decode-once cost
    and the peak device memory above the resident tree per mode."""
    from repro_torch.models import lm
    from repro_torch.protection import policy as policy_mod
    from repro_torch.serving import kvcache, protected

    plan = policy_mod.ProtectionPolicy(backend="cuda").plan(
        lm.param_shapes(cfg))
    modes = {"decode-at-use": {}, "whole-tree": dict(decode_at_use=False),
             "decode-once": dict(decode_per_step=False)}
    fed, logits, report = None, {}, {}
    for name, kw in modes.items():
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step = protected.make_serve_step(
            cfg, plan=plan, backend="cuda", kv_policy="in-place-fused",
            with_flags=False, **kw)
        t0 = time.time()
        params = plan.decode_tree(enc) if name == "decode-once" else enc
        torch.cuda.synchronize()
        once_s = time.time() - t0
        cache = kvcache.init_cache(cfg, batch, 64, kv_policy="in-place-fused",
                                   device=dev)
        tok = torch.zeros((batch, 1), dtype=torch.long, device=dev)
        out, toks, ms = [], [], []
        for t in range(steps):
            pos = torch.full((batch,), t, dtype=torch.int32, device=dev)
            torch.cuda.synchronize()
            t1 = time.time()
            lg, cache = step(params, cache, tok if fed is None else fed[t],
                             pos)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.time() - t1))
            tok = lg.argmax(dim=-1)
            out.append(lg)
            toks.append(tok)
        if fed is None:
            fed = [torch.zeros_like(toks[0])] + toks[:-1]
        logits[name] = torch.stack(out)
        del params, cache
        report[name] = {"step_ms": ms, "median_ms": statistics.median(ms[1:]),
                        "peak_gb_over_resident":
                            (torch.cuda.max_memory_allocated() - base) / 1e9}
        if name == "decode-once":
            report[name]["decode_once_s"] = once_s
        log(f"(a) {cfg.name} {name}: {report[name]['median_ms']:.2f} ms/step "
            f"median of steps 2-{steps}, peak "
            f"{report[name]['peak_gb_over_resident']:.2f} GB above the "
            f"resident tree" + (f", decoded once in {once_s:.2f} s"
                                if name == "decode-once" else ""))
    if not bool(torch.isfinite(logits["decode-at-use"].float()).all()):
        fail("(a) decode-at-use logits are not finite")
    if not torch.equal(_bits(torch, logits["whole-tree"]),
                       _bits(torch, logits["decode-once"])):
        fail("(a) the two whole-tree modes serve the same decoded tree, yet "
             "their logits differ")
    mx, mean = _max_mean_diff(torch, logits["decode-at-use"],
                              logits["whole-tree"])
    report["at_use_vs_whole_tree"] = {"max": mx, "mean": mean}
    log(f"(a) decode-at-use vs whole-tree logits: max {mx:.4g}, mean "
        f"{mean:.4g} (limits {ABLATION_MAX_ATOL}, {ABLATION_MEAN_ATOL}); "
        f"the whole-tree modes bit-equal")
    if mx > ABLATION_MAX_ATOL or mean > ABLATION_MEAN_ATOL:
        fail(f"(a) decode-at-use logits {mx:.4g} / {mean:.4g} from the "
             f"whole-tree decode's")
    return report


# ---------------------------------------------------------------------------
# phases 13-15 (b): guarded steps of the hybrid, ssm and moe families
# ---------------------------------------------------------------------------


def guarded_routes(torch, dev, cfg, enc, *, steps=3, batch=4,
                   rate=MOE_FAULT_RATE):
    """Static int8 with clamps and ABFT (``with_act_quant("static", scales,
    clamp=True).with_abft(True)``, ``act_quant="plan"``) over ``enc`` with
    single and double flips injected at ``rate``, ``steps`` steps on the
    kernel and plain routes in lockstep from the scales of a (2, 64)
    seeded calibration batch on the kernel route: the ECC flags and the
    ABFT rows (mismatches, clamp hits) equal across routes at every step,
    no mismatch. -> ms/step per route, the rows of the last step, the
    largest logit difference."""
    from repro_torch.models import lm
    from repro_torch.protection import policy as policy_mod
    from repro_torch.serving import kvcache, protected

    shapes = lm.param_shapes(cfg)
    plans = {r: policy_mod.ProtectionPolicy(backend=r).plan(shapes)
             for r in ("cuda", "torch")}
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    cal = torch.randint(0, cfg.vocab, (2, 64), generator=gen, device=dev)
    t0 = time.time()
    scales = protected.calibrate_act_scales(cfg, enc, cal,
                                            plan=plans["cuda"],
                                            backend="cuda")
    cal_s = time.time() - t0
    dirty, _ = _inject(torch, enc, rate, gen)
    run = {}
    for r in plans:
        plan = plans[r].with_act_quant("static", scales,
                                       clamp=True).with_abft(True)
        run[r] = [protected.make_serve_step(cfg, plan=plan, backend=r,
                                            act_quant="plan"),
                  kvcache.init_cache(cfg, batch, 64, device=dev), []]
    tok = torch.zeros((batch, 1), dtype=torch.long, device=dev)
    diff, rows = 0.0, None
    for t in range(steps):
        pos = torch.full((batch,), t, dtype=torch.int32, device=dev)
        out = {}
        for r, (step, cache, ms) in run.items():
            torch.cuda.synchronize()
            t1 = time.time()
            lg, run[r][1], fl = step(dirty, cache, tok, pos)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.time() - t1))
            out[r] = (lg, {k: v.tolist() for k, v in fl.items()})
        (lk, fk), (lp, fp) = out["cuda"], out["torch"]
        if fk != fp:
            fail(f"(b) {cfg.name} guarded step {t}: routes disagree on flags "
                 f"and ABFT rows: cuda {fk} vs torch {fp}")
        if not bool(torch.isfinite(lk.float()).all()):
            fail(f"(b) {cfg.name} guarded step {t}: non-finite logits")
        mm = sum(sum(x[0] for x in ([v] if k == "top_abft" else v))
                 for k, v in fk.items() if k.endswith("_abft"))
        if mm:
            fail(f"(b) {cfg.name} guarded step {t}: {mm} ABFT mismatches on "
                 f"a clean compute")
        diff = max(diff, float((lk.float() - lp.float()).abs().max()))
        rows = fk
        tok = lk.argmax(dim=-1)
    del dirty
    rep = {"calibration_s": cal_s, "rate": rate,
           "cuda_ms": statistics.median(run["cuda"][2]),
           "torch_ms": statistics.median(run["torch"][2]),
           "rows": rows, "max_logit_diff": diff}
    totals = {k: [sum(x[j] for x in (v if isinstance(v[0], list) else [v]))
                  for j in (0, 1)] for k, v in rows.items()}
    log(f"(b) {cfg.name} static int8 + clamps + ABFT, {steps} steps on both "
        f"routes in lockstep: flags and ABFT rows equal at every step (the "
        f"last step's row totals {totals}); cuda {rep['cuda_ms']:.2f} "
        f"ms/step, plain {rep['torch_ms']:.2f}; largest logit difference "
        f"{diff:.4g}; calibration {cal_s:.2f} s")
    return rep


def counted_apart(build, fn, *args, **kw):
    """``fn(*args, **kw)`` with its kernel launches counted apart from the
    running path's, whose counts resume where they were. -> (its result,
    its launch counts)."""
    before = dict(build.COUNTS)
    build.reset_counts()
    out = fn(*args, **kw)
    own = dict(build.COUNTS)
    build.COUNTS.update(before)
    log(f"launch counts of {fn.__name__}, counted apart: {own}")
    return out, own


def _inject(torch, enc, rate, gen):
    from repro_torch.protection import policy as policy_mod
    return policy_mod.inject_tree_device(enc, rate, gen)


# ---------------------------------------------------------------------------
# phase 20 (c): mixed schemes and self-healing on full-width deepseek-7b
# ---------------------------------------------------------------------------

# Full width; the MILR kit's host side (a float64 copy of one leaf at a
# time, 10.8 GB for each stacked MLP leaf at 30 layers, and 32 probe
# responses a column) fits the host; the phase logs its time and peak.
# Cut to 16 of 30 layers since PR 27 for phase 21's time (its checks are
# per leaf and per page: depth scales the time, not what is checked)
HEAL_SLOTS, HEAL_MAX_LEN = 4, 64
HEAL_LAYERS = 16
HEAL_MIGRATE_AT = 30     # the burst's middle: it runs 61 steps


def _flip_singles(torch, pt, n, gen, hit):
    """One bit in each of ``n`` distinct 64-bit blocks of ``pt.enc`` that
    no earlier call hit (``hit``: the set of block ids so far) -> a new
    leaf."""
    import dataclasses
    enc = pt.enc.clone()
    words = enc.view(-1, 8).view(torch.int64)[:, 0]
    picks = []
    while len(picks) < n:
        b = int(torch.randint(0, words.numel(), (1,), generator=gen,
                              device=enc.device))
        if b not in hit:
            hit.add(b)
            picks.append(b)
    idx = torch.tensor(picks, device=enc.device)
    bits = torch.randint(0, 64, (n,), generator=gen, device=enc.device)
    words[idx] ^= torch.ones_like(bits) << bits
    return dataclasses.replace(pt, enc=enc)


def phase_heal(torch, dev, build):
    """(c) deepseek-7b at full width, cut to ``HEAL_LAYERS`` layers:

    1. mixed schemes: planned under ``attn-inplace-mlp-secded`` (the MLP
       leaves under secded72, the rest in place), encoded, 4 steps on the
       kernel (``in-place-fused``) and plain (``in-place``) routes in
       lockstep: flags equal; ms/step beside the all-in-place plan's on
       the kernel route, and a profile of two kernel-route steps of each;
    2. self-healing: from ``all-in-place``, a MILR repair kit pinned on
       the clean tree (its time and host peak), then a burst of two waves of 4 requests
       (prompts of 18-30 tokens: 2-3 pages each) through the front-end on
       HEAL_SLOTS slots with a scrub pass every step (two weight leaves,
       four pages) and the kit. Before every 3rd step: single flips into
       the in-place weight leaves and into live pages no slot is writing;
       once, a DUE block (two flips) into ``layers/attn/wo``; once, two
       flips into every block of a free page never handed out. At step
       HEAL_MIGRATE_AT, ``start_migration`` to ``attn-inplace-mlp-secded``
       (one leaf a step). Then the final at-rest pass.
    3. The DUE leaf is repaired (rows <= the kit's samples: the solve is
       determined); the healed tree decodes to the int8 values of a clean
       encode under the plan it ended on, whose logits it serves bit for
       bit; no page leaks; the free page is zero again. Then the times
       of a full scrub pass over the weights and the pages, and a
       profile of each.
    -> the launch counts of the path."""
    import dataclasses
    import resource
    import tracemalloc

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tree
    from repro_torch.configs import get
    from repro_torch.models import lm
    from repro_torch.protection import get_policy_preset, repair
    from repro_torch.protection.schemes import get_scheme
    from repro_torch.serving import (frontend, kvcache, protected, scrubber,
                                     telemetry)

    cfg = get("deepseek-7b").with_(n_layers=HEAL_LAYERS)
    shapes = lm.param_shapes(cfg)
    torch.cuda.empty_cache()
    build.reset_counts()
    report = {"layers": cfg.n_layers}
    presets = ("attn-inplace-mlp-secded", "all-in-place")
    plans = {(p, r): get_policy_preset(p, backend=r).plan(shapes)
             for p in presets for r in ("cuda", "torch")}
    mixed = plans[("attn-inplace-mlp-secded", "cuda")]
    log(f"(c) {cfg.name} at {cfg.n_layers} layers under "
        f"attn-inplace-mlp-secded: {mixed.summary()['by_scheme']}")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def profiled(fn, what, fname, reps):
        """``reps`` calls of ``fn`` in one profiler window (its first
        device events can go unrecorded) -> device and wall ms a call."""
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t1 = time.time()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = 1e3 * (time.time() - t1) / reps
        kernels = _profile_table(torch, prof, wall * reps,
                                 f"{reps} x {what}", fname, rows=12,
                                 steps=reps)
        busy = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
        split = {k: v / reps for k, v in _kernel_split(kernels, {
            "ecc_qmatmul": QMM_KERNELS, "ecc_decode": ("decode_kernel",),
            "ecc_encode": ("encode_kernel",)}).items()}
        split["the rest"] = busy - sum(split.values())
        log(f"(c) profile, {what}, per call: device busy {busy:.2f} ms of "
            f"{wall:.2f} ms wall, split {split}")
        return {"reps": reps, "wall_ms": wall, "busy_ms": busy,
                "split": split}

    # 1. the mixed plan on both routes; all-in-place (the burst's start) on
    # the kernel route beside it. Both clean trees stay resident: the
    # burst starts from one and the healed tree is held to the other.
    ms_by, prof_by, encs = {}, {}, {}
    for preset in presets:
        encs[preset] = enc = lm.init_params(
            cfg, 0, device=dev, leaf_fn=plans[(preset, "cuda")].encode_leaf)
        routes = (("cuda", "in-place-fused"), ("torch", "in-place"))
        run = {r: [protected.make_serve_step(
                       cfg, plan=plans[(preset, r)], backend=r,
                       kv_policy=kv),
                   kvcache.init_cache(cfg, 4, 64, kv_policy=kv, device=dev),
                   []]
               for r, kv in routes[:2 if preset == presets[0] else 1]}
        tok = torch.zeros((4, 1), dtype=torch.long, device=dev)
        for t in range(4):
            pos = torch.full((4,), t, dtype=torch.int32, device=dev)
            rows = {}
            for r, (step, cache, ms) in run.items():
                torch.cuda.synchronize()
                t1 = time.time()
                lg, run[r][1], fl = step(enc, cache, tok, pos)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.time() - t1))
                rows[r] = ({k: v.tolist() for k, v in fl.items()}, lg)
            if "torch" in rows and rows["cuda"][0] != rows["torch"][0]:
                fail(f"(c) {preset} step {t}: routes disagree on flags "
                     f"{rows['cuda'][0]} vs {rows['torch'][0]}")
            tok = rows["cuda"][1].argmax(dim=-1)
        ms_by[preset] = {r: statistics.median(v[2][1:])
                         for r, v in run.items()}
        step, cache, _ = run["cuda"]
        pos = iter(range(4, 6))
        prof_by[preset] = profiled(
            lambda: step(enc, cache, tok, torch.full(
                (4,), next(pos), dtype=torch.int32, device=dev)),
            f"{preset} decode step of {cfg.name} (kernel route)",
            f"chip_smoke_heal_{preset}_profile.txt", reps=2)
        del enc, run, step, cache
    report["mixed_vs_all_in_place_ms"] = ms_by
    report["step_profiles"] = prof_by
    log(f"(c) {cfg.name} ms/step (median of steps 2-4): "
        f"attn-inplace-mlp-secded cuda {ms_by[presets[0]]['cuda']:.2f}, "
        f"plain {ms_by[presets[0]]['torch']:.2f} (flags equal across the "
        f"routes); all-in-place cuda {ms_by[presets[1]]['cuda']:.2f}")

    # 2. the healing burst
    torch.cuda.empty_cache()
    base, target = plans[("all-in-place", "cuda")], mixed
    enc = encs["all-in-place"]
    torch.cuda.synchronize()
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    tracemalloc.start()
    t0 = time.time()
    kit = repair.build_repair_kit(enc, seed=0, backend="cuda")
    report["kit_build_s"] = time.time() - t0
    _, np_peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    pinned = sum(e.x.nbytes + e.y.nbytes for e in kit.entries.values()
                 if e.x is not None)
    twins = sum(e.twin.enc.nbytes + e.twin.checks.nbytes
                for e in kit.entries.values() if e.twin is not None)
    report["kit"] = {"build_s": report["kit_build_s"],
                     "host_peak_gb": np_peak / 1e9,
                     "pinned_host_gb": pinned / 1e9,
                     "twins_device_gb": twins / 1e9,
                     "process_maxrss_gib": [rss0, rss1]}
    log(f"(c) pinned the MILR kit over {len(kit)} leaves in "
        f"{report['kit_build_s']:.1f} s: host peak {np_peak / 1e9:.2f} GB "
        f"of NumPy arrays (tracemalloc), {pinned / 1e9:.4f} GB of probes "
        f"and responses kept, {twins / 1e9:.3f} GB of secded72 twins on "
        f"the card; the process's peak RSS {rss0:.1f} -> {rss1:.1f} GiB")
    fe = frontend.ServingFrontend(
        cfg, enc, plan=base, slots=HEAL_SLOTS, max_len=HEAL_MAX_LEN,
        kv_policy="in-place-fused", scrub_every=1, scrub_weight_leaves=2,
        scrub_kv_pages=4, repair_kit=kit, backend="cuda", device=dev)
    free_pid = fe.allocator.n_pages - 1
    repair_s = []
    real_repair = fe._repair

    def timed_repair(paths):
        torch.cuda.synchronize()
        t1 = time.time()
        out = real_repair(paths)
        repair_s.append(time.time() - t1)
        return out
    fe._repair = timed_repair
    waves = frontend.make_waves(seed=5, n_waves=2, wave_size=4,
                                vocab=cfg.vocab, prompt_len=(18, 30),
                                max_new=(4, 8), gap_steps=6)
    pending = sorted(waves, key=lambda r: (r.arrival_step, r.rid))
    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    hits: dict = {}
    kv_hits: set = set()
    i, n_w, n_kv, mig_start, mig_done = 0, 0, 0, None, None
    for _ in range(10_000):
        while i < len(pending) and pending[i].arrival_step <= fe.step_no:
            fe.submit(pending[i])
            i += 1
        if i >= len(pending) and not fe.queue.peek() and fe.active == 0:
            break
        t = fe.step_no
        if fe.active and t % 3 == 0:
            def flip(path, pt):
                nonlocal n_w
                if getattr(pt, "scheme_id", None) != "in-place":
                    return pt
                n_w += 4
                return _flip_singles(torch, pt, 4, gen,
                                     hits.setdefault(tree.path_str(path),
                                                     set()))
            fe.enc_params = tree.map_with_path(flip, fe.enc_params)
            quiet = sorted(set(fe.allocator.live_pages())
                           - fe._busy_pages())
            for pid in quiet:
                for key in ("k_pages", "v_pages"):
                    # a block hit before may not be scrubbed yet: a second
                    # flip there would make a live-page DUE, which no
                    # scrub can heal
                    while True:
                        layer = int(torch.randint(0, cfg.n_layers, (1,),
                                                  generator=gen, device=dev))
                        pool = fe.cache[key][layer, pid].view(-1, 8)
                        b = int(torch.randint(0, pool.shape[0], (1,),
                                              generator=gen, device=dev))
                        if (key, layer, pid, b) not in kv_hits:
                            break
                    kv_hits.add((key, layer, pid, b))
                    pool[b, int(torch.randint(0, 8, (1,), generator=gen,
                                              device=dev))] ^= 4
                    n_kv += 1
        if t == 4:
            wo = fe.enc_params["layers"]["attn"]["wo"]
            enc_wo = wo.enc.clone()
            enc_wo.view(-1)[:2] ^= 1           # two flips in block 0
            hits.setdefault("layers/attn/wo", set()).add(0)
            fe.enc_params["layers"]["attn"]["wo"] = dataclasses.replace(
                wo, enc=enc_wo)
            for key in ("k_pages", "v_pages"):  # two flips in every block
                fe.cache[key][:, free_pid, ..., ::8] = 3
        if t == HEAL_MIGRATE_AT:
            fe.start_migration(target, leaves_per_step=1, every=1)
            mig_start = t
        fe.step()
        if mig_start is not None and mig_done is None and fe.migration_done:
            mig_done = fe.step_no - mig_start
    final = fe.final_scrub()
    summ = telemetry.summarize(fe.telemetry.events)
    ev = fe.telemetry.events
    reps = [e for e in ev if e["event"] == "repair"]
    log(f"(c) burst: {summ['requests']['finished']}/"
        f"{summ['requests']['submitted']} requests in {summ['steps']} "
        f"steps; injected {n_w} weight and {n_kv} KV single flips, one "
        f"weight DUE block, one DUE free page; healing {summ['healing']}; "
        f"repairs {[(r['path'], r['status'], r['rows']) for r in reps]}; "
        f"migration done {mig_done} steps after its start; final {final}")
    if summ["requests"]["finished"] != summ["requests"]["submitted"]:
        fail("(c) the healing burst did not finish every request")
    if summ["pool"]["leaked_pages"]:
        fail(f"(c) {summ['pool']['leaked_pages']} pages leaked")
    if [(r["path"], r["status"]) for r in reps] != [("layers/attn/wo",
                                                     "repaired")]:
        fail(f"(c) the DUE leaf was not repaired as the kit's rules decide "
             f"(rows <= {kit.n_samples}: a determined solve): {reps}")
    if final["w_due"] or final["kv_due"]:
        fail(f"(c) residual DUE after the final pass: {final}")
    heal = summ["healing"]
    if not (heal["w_corrected"] and heal["kv_corrected"]):
        fail(f"(c) the scrub wrote back no weight or no KV single: {heal}")
    if mig_done is None or heal["migrated_leaves"] != len(
            base.diff(target).paths):
        fail(f"(c) the migration did not drain: {heal}")
    for key in ("k_pages", "v_pages"):
        if int(fe.cache[key][:, free_pid].count_nonzero()):
            fail(f"(c) scrub_free left the free page {free_pid} non-zero")

    # 3. the healed tree against a clean encode under the plan it ended on
    clean = encs.pop("attn-inplace-mlp-secded")
    for (path, h), (_, c) in zip(tree.leaves_with_path(fe.enc_params),
                                 tree.leaves_with_path(clean)):
        if getattr(c, "scheme_id", None) is None:
            continue
        qh = get_scheme(h.scheme_id).decode(h.enc, h.checks, "cuda")
        qc = get_scheme(c.scheme_id).decode(c.enc, c.checks, "cuda")
        if not torch.equal(qh, qc) or h.scheme_id != c.scheme_id:
            fail(f"(c) healed leaf {tree.path_str(path)} ({h.scheme_id}) "
                 f"does not decode to the clean {c.scheme_id} encode's int8")
    step = protected.make_serve_step(cfg, plan=target, backend="cuda",
                                     kv_policy="in-place-fused")
    lgs = []
    for t_ in (fe.enc_params, clean):
        cache = kvcache.init_cache(cfg, 4, 64, kv_policy="in-place-fused",
                                   device=dev)
        lgs.append(step(t_, cache, torch.ones((4, 1), dtype=torch.long,
                                             device=dev),
                        torch.zeros((4,), dtype=torch.int32, device=dev))[0])
    if not torch.equal(_bits(torch, lgs[0]), _bits(torch, lgs[1])):
        fail("(c) the healed tree's logits differ from the clean tree's")
    log("(c) the healed tree decodes to the clean encode's int8 under "
        "attn-inplace-mlp-secded, and serves its logits bit for bit")

    # scrub and repair times on the healed state
    leaves = [x for _, x in tree.leaves_with_path(fe.enc_params)
              if getattr(x, "scheme_id", None) not in (None, "faulty")]
    torch.cuda.synchronize()
    t0 = time.time()
    scrubber.scrub_tree(fe.enc_params, backend="cuda")
    torch.cuda.synchronize()
    leaf_ms = 1e3 * (time.time() - t0) / len(leaves)
    pages = list(range(HEAL_SLOTS, fe.allocator.n_pages))
    torch.cuda.synchronize()
    t0 = time.time()
    fe.scrubber.scrub_kv(fe.cache, fe.policy, occupied=pages, n=-1)
    torch.cuda.synchronize()
    page_ms = 1e3 * (time.time() - t0) / len(pages)
    report["scrub_profiles"] = {
        "weights": profiled(
            lambda: scrubber.scrub_tree(fe.enc_params, backend="cuda"),
            f"scrub pass over {cfg.name}'s {len(leaves)} weight leaves",
            "chip_smoke_heal_scrub_profile.txt", reps=2),
        "pages": profiled(
            lambda: fe.scrubber.scrub_kv(fe.cache, fe.policy,
                                         occupied=pages, n=-1),
            f"scrub pass over {len(pages)} KV pages",
            "chip_smoke_heal_scrub_kv_profile.txt", reps=8)}
    report.update(
        scrub_ms_per_leaf=leaf_ms, scrub_ms_per_page=page_ms,
        repair_s=repair_s, migration_steps=mig_done, final=final,
        healing=heal, injected={"weight_singles": n_w, "kv_singles": n_kv},
        steps=summ["steps"], leaked_pages=summ["pool"]["leaked_pages"],
        n_leaves=len(leaves), n_pages=len(pages))
    log(f"(c) scrub {leaf_ms:.2f} ms per leaf (mean of {len(leaves)}, "
        f"{sum(x.enc.numel() for x in leaves) / 1e9:.3f} GB), "
        f"{page_ms:.3f} ms per page ({len(pages)} pages x {cfg.n_layers} "
        f"layers, K and V); repair {repair_s} s; kit build "
        f"{report['kit_build_s']:.1f} s; migration {mig_done} steps")
    with open(OUT_DIR / "chip_smoke_heal.json", "w") as fh:
        json.dump({"config": cfg.name, **report}, fh, indent=1)
    counts = dict(build.COUNTS)
    del fe, enc, encs, clean, kit
    torch.cuda.empty_cache()
    log(f"launch counts over the mixed-scheme and self-healing path: "
        f"{counts}")
    return counts



# ---------------------------------------------------------------------------
# phase 21: distribution — the sharded cells on a world-1 NCCL mesh
# ---------------------------------------------------------------------------

# (b)'s decode cell: deepseek-7b at full width cut to 8 layers (its check
# is the lockstep against the unsharded step, which depth does not change)
DIST_LAYERS, DIST_STEPS, DIST_BATCH, DIST_MAX_LEN = 8, 8, 4, 64
DIST_RATE = 1e-6
# (c)'s train cell: full width, 2 layers, 8 x 2,048 tokens, 2 steps
DIST_TRAIN_LAYERS, DIST_TRAIN_STEPS = 2, 2
# (d)'s gradient: 64 M f32 values
DIST_PSUM_N = 64 * 2 ** 20


def _world1(torch, tmp):
    """A world-1 process group over NCCL (a FileStore in ``tmp``, no
    network) and the (1, 1) ('data', 'model') mesh on the card."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    return make_production_mesh(shape=(1, 1), device="cuda")


def phase_dist(torch, dev, build):
    """(a) a world-1 NCCL process group and a (1, 1) mesh; (b) the sharded
    decode cell of deepseek-7b (``DIST_LAYERS`` layers, in-place policy,
    in-place fused paged KV with per-slot rows, batch 4, correctable and
    uncorrectable weight flips) for ``DIST_STEPS`` steps in lockstep with
    the unsharded serve step: flags, per-slot rows, page tables and logits
    equal bit for bit, ms/step of both; (c) the sharded train cell at
    ``DIST_TRAIN_LAYERS`` layers, 8 x 2,048, against ``make_train_step``:
    loss and masters bit-equal; (d) ``compressed_psum`` of a 64 M-value
    f32 gradient against the local ``compress`` formula, timed beside a
    plain f32 all-reduce; (e) a protected 2-layer checkpoint restored with
    ``shardings=`` equal to ``restore(device="cuda")``. Writes
    ``chip_smoke_dist.json``. -> (the sharded paths' launch counts, the
    report)."""
    import tempfile

    import torch.distributed as dist
    tmp = tempfile.mkdtemp(dir=str(ROOT / "build"))
    try:
        mesh = _world1(torch, tmp)
        log(f"(a) world-1 NCCL process group, mesh {mesh}")
        report = {}
        counts = {k: 0 for k in build.COUNTS}
        for name, fn in (("decode", dist_decode), ("train", dist_train),
                         ("psum", dist_psum), ("restore", dist_restore)):
            t0 = time.time()
            out, own = counted_apart(build, fn, torch, dev, mesh, tmp)
            report[name] = {**out, "launches": own,
                            "phase_s": time.time() - t0}
            for k, v in out.get("sharded_launches", {}).items():
                counts[k] += v
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    with open(OUT_DIR / "chip_smoke_dist.json", "w") as fh:
        json.dump(report, fh, indent=1)
    return counts, report


def _tally(build, acc: dict, fn, *args):
    """``fn(*args)`` with its kernel launches added to ``acc`` (the sharded
    runs' own, apart from the unsharded steps beside them)."""
    before = dict(build.COUNTS)
    out = fn(*args)
    for k, v in build.COUNTS.items():
        acc[k] = acc.get(k, 0) + v - before[k]
    return out


def dist_decode(torch, dev, mesh, tmp):
    """(b) -> the report. The fed tokens are the unsharded step's greedy
    tokens, the same for both."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.configs import get
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import specs
    from repro_torch.models.config import ShapeConfig
    from repro_torch.protection import policy as policy_mod
    from repro_torch.serving import kvcache

    cfg = get("deepseek-7b").with_(n_layers=DIST_LAYERS)
    kvp = dataclasses.replace(kvcache.get_kv_policy("in-place-fused"),
                              per_slot_flags=True)
    pol = policy_mod.ProtectionPolicy(backend="cuda")
    plan, abstract = specs.serving_plan(cfg, mesh, policy=pol)
    step, _, in_sh, out_sh = specs.decode_cell(
        cfg, ShapeConfig("dist", DIST_MAX_LEN, DIST_BATCH, "decode"), mesh,
        plan=plan, abstract=abstract, with_flags=True, kv_policy=kvp,
        backend="cuda")
    enc = lm_params(torch, dev, cfg, plan)
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    enc, _ = _inject(torch, enc, DIST_RATE, gen)
    run = specs.sharded(step, mesh, in_sh, out_sh)
    cache = kvcache.init_cache(cfg, DIST_BATCH, DIST_MAX_LEN, kv_policy=kvp,
                               device=dev)
    placed = specs.place((enc, cache), tuple(in_sh[:2]), mesh)
    ucache = tree.map_with_path(lambda _, t: t.clone(), cache)
    del cache
    from repro_torch.kernels import build
    tok = torch.zeros((DIST_BATCH, 1), dtype=torch.int32, device=dev)
    ms = {"sharded": [], "unsharded": []}
    dcache, launches = placed[1], {}
    for t in range(DIST_STEPS):
        pos = torch.full((DIST_BATCH,), t, dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        t0 = time.time()
        lg, dcache, fl = _tally(build, launches, run, placed[0], dcache, tok,
                                pos)
        torch.cuda.synchronize()
        ms["sharded"].append(1e3 * (time.time() - t0))
        t0 = time.time()
        ulg, ucache, ufl = step(enc, ucache, tok, pos)
        torch.cuda.synchronize()
        ms["unsharded"].append(1e3 * (time.time() - t0))
        lg = lg.to_local()
        if not torch.equal(lg, ulg):
            fail(f"(b) step {t}: sharded logits differ from the unsharded "
                 f"step's (max {float((lg.float() - ulg.float()).abs().max())})")
        for k, v in ufl.items():
            if not torch.equal(fl[k].to_local(), v):
                fail(f"(b) step {t}: flags row {k!r} differs")
        tok = ulg.argmax(dim=-1).to(torch.int32)
    table = sh.local_tree(dcache)["kv_table"]
    if not torch.equal(table, ucache["kv_table"]):
        fail("(b) the sharded cache's page tables differ")
    for k in ("k_pages", "v_pages", "k_scale", "v_scale"):
        if not torch.equal(dcache[k].to_local(), ucache[k]):
            fail(f"(b) the sharded cache's {k} differ")
    n_fl = {k: int(v.sum()) for k, v in ufl.items()}
    if not n_fl.get("layers"):
        fail(f"(b) no weight flag was raised at rate {DIST_RATE}: {n_fl}")
    missing = [k for k in ("ecc_qmatmul", "fused_page_attention", "kv_write")
               if launches.get(k, 0) <= 0]
    if missing:
        fail(f"(b) kernels never launched on the sharded decode: {missing}")
    med = {k: statistics.median(v[1:]) for k, v in ms.items()}
    log(f"(b) sharded decode cell, {cfg.name} x {cfg.n_layers} layers, "
        f"batch {DIST_BATCH}, {DIST_STEPS} steps in lockstep: logits, flags "
        f"(last step {n_fl}), per-slot rows, page tables and pools "
        f"bit-equal; {med['sharded']:.2f} ms/step sharded (DTensor "
        f"dispatch) against {med['unsharded']:.2f} unsharded; sharded "
        f"launches {launches}")
    del enc, placed, dcache, ucache
    torch.cuda.empty_cache()
    return {"layers": cfg.n_layers, "step_ms": ms, "median_ms": med,
            "flags_last_step": n_fl, "sharded_launches": launches}


def lm_params(torch, dev, cfg, plan):
    """``cfg``'s seeded weights encoded leaf by leaf under ``plan``."""
    from repro_torch.models import lm
    return lm.init_params(cfg, 0, device=dev, leaf_fn=plan.encode_leaf)


def dist_train(torch, dev, mesh, tmp):
    """(c) -> the report: the sharded train cell's steps against the
    unsharded step on the same masters and batches, loss and every master
    bit-equal after each step."""
    from repro_torch import tree
    from repro_torch.configs import get
    from repro_torch.kernels import build
    from repro_torch.launch import specs
    from repro_torch.models import lm
    from repro_torch.models.config import ShapeConfig
    from repro_torch.training import optim, train as train_mod

    batch, seq = 8, 2048
    cfg = get("deepseek-7b").with_(n_layers=DIST_TRAIN_LAYERS)
    step, _, in_sh, out_sh = specs.train_cell(
        cfg, ShapeConfig("dist", seq, batch, "train"), mesh, chunk=2048,
        backend="cuda")
    run = specs.sharded(step, mesh, in_sh, out_sh)
    ustep = train_mod.make_train_step(cfg.with_(microbatch=1), chunk=2048,
                                      backend="cuda")
    params = lm.init_params(cfg, 0, device=dev)
    uparams = tree.map_with_path(lambda _, t: t.clone(), params)
    state = [specs.place((params, optim.sgd_init(params)), tuple(in_sh[:2]),
                         mesh), (uparams, optim.sgd_init(uparams))]
    del params, uparams
    ms = {"sharded": [], "unsharded": []}
    losses, launches = [], {}
    for i in range(DIST_TRAIN_STEPS):
        _dist_train_step(torch, dev, cfg, mesh, run, ustep, state, i, batch,
                         seq, ms, launches, losses)
    if launches.get("quantize_throttle", 0) <= 0:
        fail("(c) quantize_throttle never launched on the sharded step")
    log(f"(c) sharded train cell, {cfg.name} x {cfg.n_layers} layers, "
        f"{batch} x {seq}: losses {losses} and every master bit-equal to "
        f"the unsharded step's; ms/step sharded {ms['sharded']}, unsharded "
        f"{ms['unsharded']}; sharded launches {launches}")
    del state
    torch.cuda.empty_cache()
    return {"layers": cfg.n_layers, "losses": losses, "step_ms": ms,
            "sharded_launches": launches}


def _dist_train_step(torch, dev, cfg, mesh, run, ustep, state, i, batch, seq,
                     ms, launches, losses):
    """One step of (c) on both sides (``state``: [sharded (params, opt),
    unsharded (params, opt)], updated in place by the steps)."""
    from repro_torch import tree
    from repro_torch.data import synthetic
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import build
    b = synthetic.token_batch(cfg.vocab_padded, batch, seq, seed=0, step=i)
    b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    t_ms, (p2, _, loss) = _tally(build, launches, event_ms, torch,
                                 lambda: run(*state[0], b))
    ms["sharded"].append(t_ms)
    t_ms, (up, _, uloss) = event_ms(torch, lambda: ustep(*state[1], b))
    ms["unsharded"].append(t_ms)
    if not torch.equal(loss.to_local(), uloss):
        fail(f"(c) step {i}: sharded loss {float(loss.to_local())} != "
             f"unsharded {float(uloss)}")
    for path, w in tree.leaves_with_path(sh.local_tree(p2)):
        if not torch.equal(w, tree.get_path(up, path)):
            fail(f"(c) step {i}: master {tree.path_str(path)} differs")
    losses.append(float(uloss))


def dist_psum(torch, dev, mesh, tmp):
    """(d) -> the report: ``compressed_psum`` over the world-1 NCCL group
    equals the local ``compress`` (payload, residual, the mean as q *
    scale); CUDA-event ms beside a plain f32 all-reduce of the same
    gradient."""
    import torch.distributed as dist

    from repro_torch.training import compress

    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    g = torch.randn(DIST_PSUM_N, generator=gen, device=dev)
    r = torch.randn(DIST_PSUM_N, generator=gen, device=dev) * 1e-3
    group = dist.group.WORLD
    mean, nr, q = compress.compressed_psum(g, r, group, with_payload=True)
    q0, s0, r0 = compress.compress(g, r)
    if not (torch.equal(q, q0) and torch.equal(nr, r0)):
        fail("(d) compressed_psum's payload or residual differs from "
             "compress's")
    if not torch.equal(mean, compress.decompress(q0, s0)):
        fail("(d) compressed_psum's mean differs from q * scale")
    timer = Timer(torch, dev)
    psum_ms = timer.ms(lambda: compress.compressed_psum(g, r, group))
    buf = g.clone()
    plain_ms = timer.ms(lambda: dist.all_reduce(buf, group=group))
    log(f"(d) compressed_psum of {DIST_PSUM_N / 2 ** 20:.0f} M f32 values "
        f"over NCCL (world 1): payload and residual equal compress's; "
        f"{psum_ms:.3f} ms against a plain f32 all_reduce {plain_ms:.3f} ms")
    del g, r, buf, mean, nr, q, q0, r0
    return {"n": DIST_PSUM_N, "compressed_psum_ms": psum_ms,
            "all_reduce_f32_ms": plain_ms}


def dist_restore(torch, dev, mesh, tmp):
    """(e) -> the report: a protected (params, momentum) checkpoint of
    deepseek-7b at 2 layers, full width, restored with ``shardings=`` onto
    the mesh, equal to ``restore(device="cuda")`` leaf for leaf; the
    restore's peak device memory above what was allocated before it (each
    chunk is decoded alone on the card: the restored shards plus one
    leaf's codec and dequantize buffers at most, held under the shards'
    bytes plus twice the largest leaf's)."""
    from repro_torch import tree
    from repro_torch.configs import get
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import lm
    from repro_torch.training import checkpoint, optim

    cfg = get("deepseek-7b").with_(n_layers=2)
    params = lm.init_params(cfg, 0, device=dev)
    state = (params, optim.sgd_init(params))
    path = os.path.join(tmp, "ckpt")
    t0 = time.time()
    checkpoint.save(path, state, step=1, protected=True, device=dev)
    save_s = time.time() - t0
    pspec = sh.param_specs(lm.param_shapes(cfg))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    got, _ = checkpoint.restore(path, state, device=dev,
                                shardings=(pspec, optim.SgdState(pspec)),
                                mesh=mesh)
    sharded_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated() - base
    sizes = [d.to_local().nelement() * d.to_local().element_size()
             for part in got for _, d in tree.leaves_with_path(part)]
    if peak > sum(sizes) + 2 * max(sizes):
        fail(f"(e) the sharded restore peaked at {peak} bytes, above its "
             f"shards' {sum(sizes)} plus twice the largest leaf's "
             f"{max(sizes)}")
    whole, _ = checkpoint.restore(path, state, device=dev)
    n = 0
    for part_got, part_whole in zip(got, whole):
        for p, w in tree.leaves_with_path(part_whole):
            d = tree.get_path(part_got, p)
            if not torch.equal(d.to_local(), w):
                fail(f"(e) restored leaf {tree.path_str(p)} differs")
            n += 1
    log(f"(e) protected checkpoint of {cfg.name} x {cfg.n_layers} layers "
        f"({n} leaves) restored with shardings= onto the mesh bit-equal to "
        f"restore(device='cuda'); save {save_s:.2f} s, sharded restore "
        f"{sharded_s:.2f} s, its peak {peak / 2**30:.3f} GiB above the "
        f"{base / 2**30:.3f} GiB before it for {sum(sizes) / 2**30:.3f} GiB "
        f"of shards (largest leaf {max(sizes) / 2**30:.3f} GiB)")
    del params, state, got, whole
    torch.cuda.empty_cache()
    return {"leaves": n, "save_s": save_s, "sharded_restore_s": sharded_s,
            "restore_peak_bytes": peak, "shard_bytes": sum(sizes),
            "largest_leaf_bytes": max(sizes)}

if __name__ == "__main__":
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    # before CUDA starts: cuBLAS's deterministic workspace, for phase 19's
    # runs under torch.use_deterministic_algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    main()
