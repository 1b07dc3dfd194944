"""Kernel micro-benchmarks of the port, and its autotune artifact.

Counterpart of the reference's ``benchmarks/kernel_bench.py``, with its CLI
(``--json PATH``, ``--tiles-smoke``) and its CSV row names, plus
``--device``. Per kernel it reports the time of the device's route (on the
card the CUDA kernel, timed with CUDA events: the median of ``reps``
launches, each after a 128 MiB write that flushes the 50 MB L2; on the CPU
the plain PyTorch version, host clock) beside ``h100_bound_us``, the least
time an H100 SXM could take for the same work: max(bytes / 3.35 TB/s,
operations / peak), with each input read once and each output written
once, at 989 TFLOP/s bf16, 1,979 TOP/s int8 and 67 TFLOP/s f32.

``--json PATH`` also times, per weight shape, the in-place decode on both
routes (``best`` names the faster: ``"torch"`` or ``"cuda"``), the fused
decode + matmul kernel (``kernels.ecc_qmatmul``) in its float, int8
requantize, ABFT and int8 ABFT modes beside the plain decode-then-matmul
versions, the strip page-attention kernel against its plain version per KV
scheme (``bitexact``), and the chunked kernel against the strip kernel at
long contexts with the strip kernel's shared-memory working set and the
chunked output's error against the fp64 oracle (``within_tol``: within 2%
of ``max|oracle|``, the reference's gate). It writes the
``bench_kernels/v6`` payload that ``protection.AutotuneTable`` loads and
``launch.serve --autotune`` consumes, round-tripped through the table
first.

The CUDA ``ecc_qmatmul`` plans its own launch (``plan_launch``: regime,
tile and K splits from the shapes), so there is no tile sweep: each entry
records the plans (``launch``, ``int8_launch``) and no ``tiles`` or
``int8_tiles``. ``--tiles-smoke`` keeps the short sweep's meaning: the
short attention lengths. On ``--device cpu`` only the plain route runs:
the CUDA columns are null, ``best`` is ``"torch"`` and the artifact says
``"platform": "cpu"``.

  PYTHONPATH=src python -m repro_torch.benchmarks.kernel_bench \\
      [--device cpu] [--json PATH] [--tiles-smoke]
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import ecc
from repro_torch.protection.backends import (BENCH_KERNELS_SCHEMAS,
                                             AutotuneTable)

HBM_BW = 3.35e12        # H100 SXM HBM3, B/s
PEAK_BF16 = 989e12      # dense bf16 FLOP/s
PEAK_INT8 = 1979e12     # dense int8 OP/s
PEAK_F32 = 67e12        # f32 FLOP/s outside the tensor cores

# the reference's shape lists
AUTOTUNE_SHAPES = ((256, 256), (256, 1024), (1024, 1024), (2048, 4096))
# (batch, seq, kv_heads, head_dim); queries use 2x the kv heads (rep 2)
ATTENTION_SHAPES = ((2, 128, 2, 32), (2, 256, 4, 64))
ATTENTION_LONG_LENGTHS = (2048, 4096, 8192, 10240)
ATTENTION_LONG_LENGTHS_SMOKE = (512, 1024)
ORACLE_RTOL = 0.02      # the chunked kernel's gate: 2% of max|oracle|


def bound_us(nbytes: float, ops: float = 0.0, peak: float = PEAK_BF16):
    """The H100's least time for the work, in microseconds."""
    return 1e6 * max(nbytes / HBM_BW, ops / peak)


class Timer:
    """Median time of a call in microseconds: CUDA events around each
    launch on the card (the L2 flushed before it, the card kept busy while
    the host enqueues), the host clock on the CPU. One untimed warm-up
    call first."""

    def __init__(self, dev: torch.device, reps: int = 10):
        self.dev, self.reps = dev, reps
        self.flush = (torch.empty(128 * 2 ** 20, dtype=torch.uint8,
                                  device=dev) if dev.type == "cuda" else None)

    def us(self, fn) -> float:
        fn()
        times = []
        for _ in range(self.reps):
            if self.flush is None:
                t0 = time.perf_counter()
                fn()
                times.append(1e6 * (time.perf_counter() - t0))
                continue
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(1e3 * a.elapsed_time(b))
        return statistics.median(times)


def _enc_weight(rng, k, n, dev):
    """A random WOT-compliant (k, n) int8 weight's in-place image."""
    w = rng.integers(-64, 64, size=(k, n)).astype(np.int8)
    blocks = torch.from_numpy(w.view(np.uint8).reshape(k, n // 8, 8))
    return ecc.encode64(blocks).reshape(k, n).to(dev)


def bench_decode(dev, n_weights=2 ** 22, reps=5):
    """The in-place decode of ``n_weights`` on the device's route ->
    (us, bytes moved, bound us): reads n bytes, writes n + n/8 flags."""
    from repro_torch.kernels.ecc_decode import ecc_decode
    rng = np.random.default_rng(0)
    enc = _enc_weight(rng, n_weights // 8, 8, dev)
    us = Timer(dev, reps).us(lambda: ecc_decode(enc))
    nbytes = 2 * n_weights + n_weights // 8
    return us, nbytes, bound_us(nbytes)


def bench_qmatmul(dev, m=512, k=1024, n=1024, reps=5):
    """The fused decode + raw int8 matmul (int32 out) -> (us, ops, bound
    us)."""
    from repro_torch.kernels.ecc_qmatmul import ecc_qmatmul
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.integers(-127, 128, size=(m, k))
                         .astype(np.int8)).to(dev)
    enc = _enc_weight(rng, k, n, dev)
    us = Timer(dev, reps).us(lambda: ecc_qmatmul(a, enc))
    ops = 2 * m * k * n
    return us, ops, bound_us(m * k + k * n + 4 * m * n, ops, PEAK_INT8)


def bench_throttle(dev, n=2 ** 22, reps=5):
    """The WOT throttle of n int8 values -> (us, bytes, bound us)."""
    from repro_torch.kernels.throttle import throttle
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.integers(-128, 128, size=(n // 8, 8))
                         .astype(np.int8)).to(dev)
    us = Timer(dev, reps).us(lambda: throttle(q))
    return us, 2 * n, bound_us(2 * n)


def bench_backend_decode(dev, shapes=AUTOTUNE_SHAPES, reps=3):
    """Per weight shape, the in-place decode on both routes -> autotune
    entries (``torch_us``, ``cuda_us``: null on the CPU, ``best``)."""
    from repro_torch.protection.backends import get_backend
    rng = np.random.default_rng(7)
    timer = Timer(dev, reps)
    routes = ("torch", "cuda") if dev.type == "cuda" else ("torch",)
    entries = []
    for k, n in shapes:
        blocks = _enc_weight(rng, k, n, dev).reshape(k, n // 8, 8)
        us = {r: timer.us(lambda be=get_backend(r): be.decode64(blocks))
              for r in routes}
        entries.append({"shape": [k, n], "nblocks": k * n // 8,
                        "torch_us": us["torch"], "cuda_us": us.get("cuda"),
                        "best": min(us, key=us.get),
                        "h100_bound_us": bound_us(k * n + k * n + k * n // 8)})
    return entries


def _plan(m, n, k, dtype) -> dict:
    from repro_torch.kernels.ecc_qmatmul import plan_launch
    p = plan_launch(m, n, k, dtype)
    return {"regime": p.regime, "bm": p.bm, "bn": p.bn, "splits": p.splits}


def bench_fused_tiles(dev, entries, m=128, reps=3):
    """Per entry's shape, the fused decode + matmul kernel at ``m`` rows in
    its four modes (``fused_us`` float bf16, ``fused_abft_us``,
    ``fused_int8_us`` the int8 requantize epilogue to bf16,
    ``fused_int8_abft_us``; null on the CPU) beside the plain
    decode-then-matmul versions (``fused_ref_us``, ``int8_ref_us``), the
    kernel's launch plans (``launch``, ``int8_launch``) and their bounds.
    The bf16 and int8 activations are seeded per shape."""
    from repro_torch.kernels.ecc_qmatmul import (ecc_qmatmul,
                                                 ecc_qmatmul_plain)
    rng = np.random.default_rng(11)
    timer = Timer(dev, reps)
    card = dev.type == "cuda"
    w_scale = torch.full((), 0.01, dtype=torch.float32, device=dev)
    for e in entries:
        k, n = e["shape"]
        enc = _enc_weight(rng, k, n, dev)
        a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)
                             ).to(dev, torch.bfloat16)
        aq = torch.from_numpy(rng.integers(-127, 128, size=(m, k))
                              .astype(np.int8)).to(dev)
        a_scale = torch.from_numpy(rng.uniform(0.005, 0.02, size=(m, 1))
                                   .astype(np.float32)).to(dev)
        calls = {
            "fused": lambda f: f(a, enc, w_scale),
            "fused_abft": lambda f: f(a, enc, w_scale, with_abft=True),
            "fused_int8": lambda f: f(aq, enc, w_scale, a_scale=a_scale),
            "fused_int8_abft": lambda f: f(aq, enc, w_scale, a_scale=a_scale,
                                           with_abft=True)}
        for name, call in calls.items():
            e[name + "_us"] = (timer.us(lambda c=call: c(ecc_qmatmul))
                               if card else None)
        e["fused_ref_us"] = timer.us(lambda: calls["fused"](ecc_qmatmul_plain))
        e["int8_ref_us"] = timer.us(
            lambda: calls["fused_int8"](ecc_qmatmul_plain))
        e["launch"] = _plan(m, n, k, torch.bfloat16)
        e["int8_launch"] = _plan(m, n, k, torch.int8)
        ops = 2 * m * k * n
        e["fused_bound_us"] = bound_us(2 * m * k + k * n + 4 * m * n, ops)
        e["int8_bound_us"] = bound_us(m * k + k * n + 2 * m * n, ops,
                                      PEAK_INT8)
    return entries


def _strips(rng, b, s, kv, hd, rep, scheme, dev):
    """Seeded q (B, rep*KV, 1, hd) bf16 and the encoded K/V strips of one
    scheme -> (q, (ke, kch, ksc, ve, vch, vsc), pos at the last token)."""
    from repro_torch.serving import kvcache
    q = torch.from_numpy(rng.standard_normal((b, rep * kv, 1, hd))
                         .astype(np.float32)).to(torch.bfloat16)
    kf = torch.from_numpy(rng.standard_normal((b, s, kv, hd))
                          .astype(np.float32))
    vf = torch.from_numpy(rng.standard_normal((b, s, kv, hd))
                          .astype(np.float32))
    pol = kvcache.KVProtectionPolicy(scheme=scheme)
    strips = (*kvcache._encode_kv(kf, pol), *kvcache._encode_kv(vf, pol))
    strips = tuple(None if t is None else t.to(dev) for t in strips)
    pos = torch.full((b,), s - 1, dtype=torch.int32, device=dev)
    return q.to(dev), strips, pos


def _attention_bound(b, s, kv, hd, rep, scheme) -> float:
    """Each live token's K and V (and check bytes) and scales read once, q
    read and o written once; QK and PV in f32."""
    h = rep * kv
    per_tok = 2 * kv * hd + (2 * kv * hd // 8 if scheme == "parity-zero"
                             else 0) + 8
    nbytes = b * s * per_tok + 2 * 2 * b * h * hd
    return bound_us(nbytes, 4 * b * h * s * hd, PEAK_F32)


def bench_paged_attention(dev, shapes=ATTENTION_SHAPES, reps=3):
    """The strip page-attention kernel (``fused_us``; null on the CPU)
    against its plain version (``ref_us``) per shape and KV scheme;
    ``bitexact``: the kernel's output and flags equal the plain version's
    on the same strips (null on the CPU, where only the plain version
    runs)."""
    from repro_torch.kernels import paged_attention as pa
    rng = np.random.default_rng(13)
    timer = Timer(dev, reps)
    card = dev.type == "cuda"
    rows = []
    for b, s, kv, hd in shapes:
        for scheme in pa.KV_SCHEMES:
            q, strips, pos = _strips(rng, b, s, kv, hd, 2, scheme, dev)

            def kernel():
                return pa.fused_page_attention(q, *strips, pos,
                                               scheme=scheme)

            def plain():
                return pa.fused_page_attention_plain(q, *strips, pos,
                                                     scheme=scheme)
            row = {"shape": [b, s, kv, hd], "scheme": scheme,
                   "fused_us": timer.us(kernel) if card else None,
                   "ref_us": timer.us(plain),
                   "h100_bound_us": _attention_bound(b, s, kv, hd, 2,
                                                     scheme),
                   "bitexact": None}
            if card:
                (o, f), (o_p, f_p) = kernel(), plain()
                row["bitexact"] = bool(torch.equal(o, o_p)
                                       and torch.equal(f, f_p))
            rows.append(row)
    return rows


def bench_chunked_attention(dev, lengths=ATTENTION_LONG_LENGTHS,
                            chunk_tokens=2048, hd=128, rep=2, reps=3):
    """The chunked kernel (``chunked_us``) against the strip kernel
    (``strip_us``, null past its shared-memory limit) and the chunked
    plain version (``chunked_plain_us``) per length (batch 1, one KV head,
    GQA rep 2) and KV scheme; kernel columns null on the CPU. Each row
    records the strip kernel's shared-memory working set against the
    card's limit (``over_limit``: only the chunked kernel serves) and the
    chunked output's (the kernel's on the card, the plain version's on
    the CPU) max abs error against the fp64 oracle with the gate
    ``ORACLE_RTOL * max|oracle|``. ``chunk_tokens`` sets the plain
    version's chunks. -> (rows, crossover): the strip kernel's crossover
    length per scheme for this (head_dim, rep)."""
    from repro_torch.kernels import paged_attention as pa
    rng = np.random.default_rng(17)
    timer = Timer(dev, reps)
    card = dev.type == "cuda"
    b, kv = 1, 1
    rows = []
    for s in lengths:
        for scheme in pa.KV_SCHEMES:
            q, strips, pos = _strips(rng, b, s, kv, hd, rep, scheme, dev)
            smem = pa.smem_bytes(s, hd, rep)
            over = smem > pa.SMEM_LIMIT_BYTES

            def chunked(f=pa.chunked_page_attention):
                return f(q, *strips, pos, scheme=scheme,
                         chunk_tokens=chunk_tokens)[0]

            def strip():
                return pa.fused_page_attention(q, *strips, pos,
                                               scheme=scheme)[0]
            oracle = pa.oracle_page_attention(q, *strips, pos, scheme=scheme)
            out = chunked() if card else chunked(
                pa.chunked_page_attention_plain)
            err = float(np.max(np.abs(out.float().cpu().numpy()
                                      .astype(np.float64) - oracle)))
            tol = ORACLE_RTOL * (float(np.max(np.abs(oracle))) + 1e-6)
            rows.append({
                "shape": [b, s, kv, hd], "scheme": scheme,
                "chunk_tokens": chunk_tokens,
                "chunked_us": timer.us(chunked) if card else None,
                "strip_us": timer.us(strip) if card and not over else None,
                "chunked_plain_us": timer.us(
                    lambda: chunked(pa.chunked_page_attention_plain)),
                "h100_bound_us": _attention_bound(b, s, kv, hd, rep, scheme),
                "strip_smem_bytes": smem,
                "chunked_smem_bytes": pa.chunked_smem_bytes(
                    hd, rep, checks=scheme == "parity-zero"),
                "over_limit": over,
                "oracle_max_abs_err": err, "tol": tol,
                "within_tol": err <= tol})
    crossover = {
        "head_dim": hd, "rep": rep,
        "smem_limit_bytes": pa.SMEM_LIMIT_BYTES,
        "chunk_tokens": chunk_tokens,
        "tokens_by_scheme": {scheme: pa.strip_smem_crossover(hd, rep)
                             for scheme in pa.KV_SCHEMES}}
    return rows, crossover


def write_bench_kernels(path, dev, entries=None, *, attention=None,
                        attention_long=None, crossover=None) -> dict:
    """Write the port's ``bench_kernels/v6`` artifact for ``dev`` (checked
    by a round trip through ``AutotuneTable.from_dict`` first) -> the
    payload."""
    if entries is None:
        entries = bench_fused_tiles(dev, bench_backend_decode(dev))
    if attention is None:
        attention = bench_paged_attention(dev)
    if attention_long is None:
        attention_long, crossover = bench_chunked_attention(dev)
    card = dev.type == "cuda"
    payload = {"schema": BENCH_KERNELS_SCHEMAS[0],
               "platform": "cuda" if card else "cpu",
               "device": torch.cuda.get_device_name(dev) if card else "cpu",
               "op": "in-place-decode64+fused-qmatmul",
               "entries": entries,
               "attention": attention,
               "attention_long": attention_long}
    if crossover:
        payload["crossover"] = crossover
    AutotuneTable.from_dict(payload)  # schema self-check
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    return payload


def _us(x) -> str:
    return "null" if x is None else f"{x:.0f}us"


def _flag(x) -> str:
    return "null" if x is None else str(x).lower()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the per-shape torch-vs-cuda decode + "
                         "fused-kernel + paged-attention table "
                         "(bench_kernels/v6)")
    ap.add_argument("--tiles-smoke", action="store_true",
                    help="short attention lengths (CI smoke)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (the plain "
                         "route only)")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)
    us, b, r = bench_decode(dev)
    print(f"kernel_ecc_decode,{us:.0f},h100_bound_us={r:.1f}_bytes={b}")
    us, fl, r = bench_qmatmul(dev)
    print(f"kernel_ecc_qmatmul,{us:.0f},h100_bound_us={r:.1f}_flops={fl}")
    us, b, r = bench_throttle(dev)
    print(f"kernel_throttle,{us:.0f},h100_bound_us={r:.1f}_bytes={b}")
    if not args.json:
        return None
    lengths = (ATTENTION_LONG_LENGTHS_SMOKE if args.tiles_smoke
               else ATTENTION_LONG_LENGTHS)
    chunk = 256 if args.tiles_smoke else 2048
    attention_long, crossover = bench_chunked_attention(
        dev, lengths=lengths, chunk_tokens=chunk)
    payload = write_bench_kernels(args.json, dev,
                                  attention_long=attention_long,
                                  crossover=crossover)
    for e in payload["entries"]:
        lp, ip = e["launch"], e["int8_launch"]
        print(f"autotune_decode_{e['shape'][0]}x{e['shape'][1]},"
              f"torch={_us(e['torch_us'])},cuda={_us(e['cuda_us'])},"
              f"best={e['best']},"
              f"launch={lp['regime']}:{lp['bm']}x{lp['bn']}/{lp['splits']},"
              f"fused={_us(e['fused_us'])},abft={_us(e['fused_abft_us'])},"
              f"int8_launch={ip['regime']}:{ip['bm']}x{ip['bn']}/"
              f"{ip['splits']},fused_int8={_us(e['fused_int8_us'])},"
              f"int8_abft={_us(e['fused_int8_abft_us'])},"
              f"ref={_us(e['fused_ref_us'])},"
              f"int8_ref={_us(e['int8_ref_us'])}")
    for r in payload["attention"]:
        shp = "x".join(str(t) for t in r["shape"])
        print(f"paged_attention_{shp}_{r['scheme']},"
              f"{_us(r['fused_us'])},ref_us={r['ref_us']:.0f}"
              f"_bitexact={_flag(r['bitexact'])}")
    for r in payload["attention_long"]:
        shp = "x".join(str(t) for t in r["shape"])
        print(f"chunked_attention_{shp}_{r['scheme']},"
              f"{_us(r['chunked_us'])},strip_us={_us(r['strip_us'])}"
              f"_plain_us={r['chunked_plain_us']:.0f}"
              f"_over_limit={_flag(r['over_limit'])}"
              f"_oracle_err={r['oracle_max_abs_err']:.2e}"
              f"_within_tol={_flag(r['within_tol'])}")
    co = payload["crossover"]
    toks = ",".join(f"{k}={v}" for k, v in
                    sorted(co["tokens_by_scheme"].items()))
    print(f"# strip shared-memory crossover (hd={co['head_dim']} "
          f"rep={co['rep']}): {toks} tokens @ {co['smem_limit_bytes']} B "
          f"limit")
    print(f"# wrote {args.json} ({payload['platform']}, "
          f"{payload['device']})")
    return payload


if __name__ == "__main__":
    main()
