"""Roofline terms of the port's dry-run cells at the H100's peaks.

Counterpart of the reference's ``benchmarks/roofline.py``: the same
formulas over the port's records (``python -m repro_torch.launch.dryrun``,
whose per-rank counts come from ``launch.op_analysis``: rank 0's local
FLOPs, buffer bytes and collective wire bytes on a fake process group, not
parsed HLO), with one H100 SXM's numbers in place of the TPU's. Per
(arch x shape x mesh):

  compute    = FLOPs a rank / 989 TFLOP/s (dense bf16)
  memory     = buffer bytes a rank / 3.35 TB/s (HBM3)
  collective = wire bytes a rank / 450 GB/s (NVLink, each way)

plus MODEL_FLOPS = 6 N D (train; 2 N D prefill, 2 N B decode) with N the
active parameters, the useful-compute ratio and the roofline fraction.
``fused_vs_decode_rows`` gives the fused decode + matmul kernel's
structural bound against decode-then-matmul per shape of the port's own
autotune artifact (``kernel_bench --json``); ``kv_traffic_rows`` the paged
protected KV cache's bytes a decode step reads per KV scheme, sized
through ``serving.kvcache.kv_bytes`` on meta tensors (nothing allocated).

  PYTHONPATH=src python -m repro_torch.benchmarks.roofline \\
      [DRYRUN.jsonl [AUTOTUNE.json]] [--device cpu]
"""
from __future__ import annotations

import argparse
import json

from repro_torch import configs
from repro_torch import device as device_mod
from repro_torch.models.config import SHAPES

PEAK_FLOPS = 989e12   # bf16 FLOP/s, dense
PEAK_INT8 = 1979e12   # int8 OP/s, dense
HBM_BW = 3.35e12      # B/s
LINK_BW = 450e9       # B/s, NVLink each way


def param_counts(cfg):
    """(total_params, active_params) analytic."""
    d, v = cfg.d_model, cfg.vocab_padded
    emb = v * d * (1 if cfg.tie_embeddings else 2)
    per_layer_total = per_layer_active = 0
    f = cfg.family
    if f in ("dense", "vlm"):
        attn = d * cfg.n_heads * cfg.head_dim + \
            2 * d * cfg.n_kv_heads * cfg.head_dim + \
            cfg.n_heads * cfg.head_dim * d
        mlp = 3 * d * cfg.d_ff
        per_layer_total = per_layer_active = attn + mlp
        n_layers = cfg.n_layers
    elif f == "moe":
        r, qr, qn, vd, h = (cfg.kv_lora_rank, cfg.qk_rope_dim,
                            cfg.qk_nope_dim, cfg.v_head_dim, cfg.n_heads)
        attn = d * (r + qr) + r * h * qn + r * h * vd + h * vd * d
        attn += (d * cfg.q_lora_rank + cfg.q_lora_rank * h * (qn + qr)) \
            if cfg.q_lora_rank else d * h * (qn + qr)
        experts = cfg.n_experts * 3 * d * cfg.moe_d_ff
        active = cfg.top_k * 3 * d * cfg.moe_d_ff
        shared = cfg.n_shared_experts * 3 * d * cfg.moe_d_ff
        router = d * cfg.n_experts
        per_layer_total = attn + experts + shared + router
        per_layer_active = attn + active + shared + router
        n_layers = cfg.n_layers
    elif f == "ssm":
        di, n, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
        h = di // hd
        per_layer_total = per_layer_active = \
            d * (2 * di + 2 * n + h) + di * d
        n_layers = cfg.n_layers
    elif f == "hybrid":
        w = cfg.lru_width or d
        rg = d * w * 2 + 2 * w * w + w * d
        attn = d * cfg.n_heads * cfg.head_dim + \
            2 * d * cfg.n_kv_heads * cfg.head_dim + \
            cfg.n_heads * cfg.head_dim * d
        mlp = 3 * d * cfg.d_ff
        per_layer_total = per_layer_active = \
            (2 * (rg + mlp) + attn + mlp) / 3  # per-layer average
        n_layers = cfg.n_layers
    elif f == "encdec":
        attn = 4 * d * d
        per_layer_total = per_layer_active = attn * 2 + 2 * d * cfg.d_ff
        n_layers = cfg.n_layers + cfg.enc_layers
    total = emb + n_layers * per_layer_total
    active = emb + n_layers * per_layer_active
    return total, active


def model_flops(cfg, shape):
    _, active = param_counts(cfg)
    if shape.kind == "train":
        return 6 * active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2 * active * shape.global_batch * shape.seq_len
    return 2 * active * shape.global_batch  # decode: one token per sequence


def analyze(rec):
    """One dry-run record -> its roofline row. The counts are a rank's, so
    every term is per rank (per card). MODEL_FLOPS is the published
    config's, a smoke record's too, as in the reference."""
    cfg = configs.get(rec["arch"])
    shape = SHAPES[rec["shape"]]
    chips = rec.get("n_devices", 256)
    flops = rec.get("hlo_flops", 0.0)
    bytes_ = rec.get("hlo_buffer_bytes", 0.0)
    wire = rec.get("collectives", {}).get("total_wire_bytes", 0.0)
    terms = {"compute_s": flops / PEAK_FLOPS, "memory_s": bytes_ / HBM_BW,
             "collective_s": wire / LINK_BW}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    useful = mf / chips / flops if flops else 0.0
    bound_time = max(terms.values())
    frac = (mf / chips / PEAK_FLOPS) / bound_time if bound_time else 0.0
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        **{k: round(v, 6) for k, v in terms.items()},
        "dominant": dominant.replace("_s", ""),
        "model_flops": mf, "hlo_flops_per_chip": flops,
        "useful_flops_ratio": round(useful, 4),
        "roofline_fraction": round(frac, 4),
    }


DEFAULT_SHAPES = ((1024, 1024), (2048, 4096))


def fused_vs_decode_rows(bench_path=None, m=128):
    """The fused decode + matmul's structural bound against
    decode-then-matmul, per weight shape of the port's autotune artifact
    at ``bench_path`` (``kernel_bench --json``; DEFAULT_SHAPES without
    one). The formulas are the reference's:

    fused (raw int8): a (M*K int8) + enc (K*N) + out (M*N*4) bytes;
    decode-then-matmul adds the decoded weight's write and read (2*K*N);
    float serving path: bf16 activations (2*M*K) + f32 out at the bf16
    peak; int8 epilogue: int8 activations + bf16 out at the int8 peak."""
    shapes = list(DEFAULT_SHAPES)
    if bench_path:
        with open(bench_path) as f:
            shapes = [tuple(e["shape"]) for e in json.load(f)["entries"]]
    rows = []
    for k, n in shapes:
        flops = 2 * m * k * n
        fused_bytes = m * k + k * n + m * n * 4
        split_bytes = fused_bytes + 2 * k * n
        t_fused = max(flops / PEAK_INT8, fused_bytes / HBM_BW) * 1e6
        t_split = max(flops / PEAK_INT8, split_bytes / HBM_BW) * 1e6
        float_bytes = 2 * m * k + k * n + 4 * m * n
        int8_bytes = m * k + k * n + 2 * m * n
        t_float = max(flops / PEAK_FLOPS, float_bytes / HBM_BW) * 1e6
        t_int8 = max(flops / PEAK_INT8, int8_bytes / HBM_BW) * 1e6
        r = {"shape": [k, n], "fused_roof_us": round(t_fused, 2),
             "decode_then_matmul_roof_us": round(t_split, 2),
             "traffic_ratio": round(split_bytes / fused_bytes, 3),
             "float_fused_roof_us": round(t_float, 2),
             "int8_fused_roof_us": round(t_int8, 2),
             "int8_speedup": round(t_float / t_int8, 3),
             "int8_traffic_ratio": round(float_bytes / int8_bytes, 3)}
        rows.append(r)
        print(f"roofline_fused_qmatmul_{k}x{n},{t_fused:.1f},"
              f"decode_then_matmul_us={t_split:.1f}"
              f"_traffic_ratio={r['traffic_ratio']}")
        print(f"roofline_int8_fused_{k}x{n},{t_int8:.1f},"
              f"float_us={t_float:.1f}_speedup={r['int8_speedup']}"
              f"_traffic_ratio={r['int8_traffic_ratio']}")
    return rows


def kv_traffic_rows(arch="deepseek-7b", batch=8, seqs=(4096, 32768)):
    """A decode step's reads of the paged protected KV cache (every cached
    token's stored bytes, checks and scales once), per KV scheme, against
    the dense bf16 cache's K and V (the reference's rows; smoke widths)."""
    from repro_torch.serving import kvcache
    cfg = configs.get_smoke(arch)
    nl, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    rows = []
    for s in seqs:
        dense = 2 * 2 * batch * s * kv * hd * nl       # bf16 K+V read
        for scheme in kvcache.KV_SCHEMES:
            pol = kvcache.KVProtectionPolicy(scheme=scheme)
            cache = kvcache.init_paged_cache(cfg, batch, s, pol,
                                             device="meta")
            kb = kvcache.kv_bytes(cache)
            read = kb["stored"] + kb["checks"] + kb["scales"]
            r = {"arch": arch, "seq": s, "scheme": scheme,
                 "read_bytes_per_step": read,
                 "check_bytes": kb["checks"],
                 "dense_bf16_bytes": dense,
                 "vs_dense_ratio": round(read / dense, 4),
                 "kv_roof_us": round(read / HBM_BW * 1e6, 2)}
            rows.append(r)
            print(f"roofline_kv_{arch}_{s}_{scheme},{r['kv_roof_us']},"
                  f"read={read}_checks={kb['checks']}"
                  f"_vs_dense={r['vs_dense_ratio']}")
    return rows


def rows(path):
    """Print and return the roofline rows of every ``ok`` record of a
    dry-run JSONL (a ``skipped`` record prints a row of its own)."""
    out = []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("status") != "ok":
                if rec.get("status") == "skipped":
                    print(f"roofline_{rec['arch']}_{rec['shape']},0,skipped")
                continue
            r = analyze(rec)
            out.append(r)
            t = max(r["compute_s"], r["memory_s"], r["collective_s"])
            print(f"roofline_{r['arch']}_{r['shape']}_{r['mesh']},"
                  f"{t * 1e6:.0f},dom={r['dominant']}"
                  f"_frac={r['roofline_fraction']}"
                  f"_useful={r['useful_flops_ratio']}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path", nargs="?", default="results/dryrun_16x16.jsonl",
                    help="a dry-run JSONL (repro_torch.launch.dryrun --out)")
    ap.add_argument("bench", nargs="?", default=None,
                    help="the port's autotune artifact (kernel_bench "
                         "--json) for the fused-kernel rows")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; the rows are computed "
                         "from counts and shapes on meta tensors")
    args = ap.parse_args(argv)
    device_mod.resolve(args.device)
    out = rows(args.path)
    fused_vs_decode_rows(args.bench)
    kv_traffic_rows()
    return out


if __name__ == "__main__":
    main()
