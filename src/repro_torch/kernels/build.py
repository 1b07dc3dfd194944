"""Build, load and count the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc -gencode
arch=compute_90a,code=sm_90a`` into a shared library with a plain C
interface and bound with ``ctypes``. The build runs at first use, from the
sources in the package only, into ``build/kernels/`` at the root of the
checkout (listed in ``.gitignore``); a library is named by a hash of its
sources and flags, so an edited source rebuilds. :func:`load_all` starts
every ``nvcc`` at once.

Every kernel wrapper adds one to its entry of :data:`COUNTS` where it
launches its kernel, and nowhere else, so a run can show that its main path
went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("ecc_codec", "ecc_qmatmul", "paged_attention", "chunked_attention",
           "flash_attention", "quant_throttle", "throttle", "kv_write")
HEADERS = ("secded64.cuh", "parity8.cuh", "mma_sm90.cuh", "kv_attention.cuh",
           "wot8.cuh")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_U = ctypes.c_uint
# C entry point -> (source, argtypes)
SIGNATURES = {
    "ecc_decode_launch": ("ecc_codec", [_P, _P, _P, _LL, _P]),
    "ecc_encode_launch": ("ecc_codec", [_P, _P, _LL, _P]),
    "ecc_qmatmul_launch": ("ecc_qmatmul",
                           [_P, _I, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P,
                            _P, _P, _P, _I, _I, _I, _U, _I, _I, _P, _P, _P]),
    "fused_page_attention_launch": ("paged_attention",
                                    [_P] * 13 + [_I] * 8 +
                                    [_F, _LL, _I, _I, _P]),
    "chunked_page_attention_launch": ("chunked_attention",
                                      [_P] * 14 + [_I] * 10 +
                                      [_F, _LL, _I, _I, _P]),
    "flash_attention_launch": ("flash_attention",
                               [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I,
                                _P]),
    "quantize_throttle_launch": ("quant_throttle",
                                 [_P, _P, _P, _P, _LL, _I, _P]),
    "quantize_throttle_pass_launch": ("quant_throttle",
                                      [_P, _P, _P, _P, _LL, _I, _I, _P]),
    "throttle_launch": ("throttle", [_P, _P, _LL, _P]),
    "kv_write_launch": ("kv_write", [_P] * 16 + [_I] * 8 + [_P]),
}

COUNTS = {"ecc_decode": 0, "ecc_encode": 0, "ecc_qmatmul": 0,
          "fused_page_attention": 0, "chunked_page_attention": 0,
          "flash_attention": 0, "quantize_throttle": 0, "throttle": 0,
          "kv_write": 0}

_LIBS: dict = {}
BUILD_LOG: dict = {}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH)"
                           "; the CUDA kernels build only where the CUDA "
                           "toolkit is installed")
    return found


def _lib_path(src: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (f"{src}.cu",) + HEADERS:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"lib{src}-{h.hexdigest()[:16]}.so"


def load_all(sources=SOURCES) -> dict:
    """Build (in parallel) and load every library not loaded yet;
    returns ``{source: ctypes.CDLL}``. Raises on a failed build."""
    todo = [s for s in sources if s not in _LIBS]
    procs = {}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for src in todo:
        out = _lib_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{src}.cu")]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    failed = []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[src] = log
        if proc.returncode != 0:
            failed.append(f"--- {src}.cu (nvcc exit {proc.returncode}) ---\n"
                          f"{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    for src in todo:
        lib = ctypes.CDLL(str(_lib_path(src)))
        for fn, (fsrc, argtypes) in SIGNATURES.items():
            if fsrc == src:
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        _LIBS[src] = lib
    return dict(_LIBS)


def entry(fn: str):
    """The ctypes function ``fn``, building its library on first use."""
    src = SIGNATURES[fn][0]
    return getattr(load_all((src,))[src], fn)


def check(err: int, fn: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
    """PyTorch's current stream on ``device``, as a pointer for ctypes."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
