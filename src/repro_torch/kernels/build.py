"""Build the hand-written CUDA kernels and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled with ``nvcc`` for ``sm_90a`` into ``<repo>/build/kernels/`` as
``lib<name>-<hash>.so``, the hash taken over the source and the shared
headers (``csrc/*.cuh``), and loaded with ctypes, so a changed source
rebuilds and an unchanged one is reused.  :func:`build_all` starts
one ``nvcc`` per source, all at once.  Nothing here runs at import time:
the CPU tests import every module on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# argtypes of every C entry point, by source name and function name
SIGNATURES = {
    "sparsify_ef": {"fused_ef_topk": [_P, _P, _P, _P, _P, _P, _I, _P, _P,
                                      _P, _P, _P, _P, _P, _L, _I, _I, _I,
                                      _F, _I, _P],
                    "sparsify_ef": [_P, _P, _P, _P, _F, _P, _P, _P, _L, _P]},
    "matmul_lrelu": {"matmul_bias_lrelu": [_P, _P, _P, _P, _I, _I, _I, _I,
                                           _P]},
    "segmented_topk": {"segmented_topk": [_P, _P, _P, _P, _I, _P, _P, _P,
                                          _P, _P, _L, _I, _I, _I, _P]},
    "block_topk": {"block_topk": [_P, _P, _P, _P, _P, _I, _I, _I, _P]},
    "bitpack": {"pack_bits": [_P, _P, _I, _I, _I, _P],
                "unpack_bits": [_P, _P, _I, _I, _I, _I, _P],
                "quantize_pack": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _F, _P]},
}

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_all(names: Sequence[str] = tuple(SIGNATURES)) -> Dict[str, dict]:
    """Compile every missing library, one nvcc process per source started
    together.  Returns {name: {"seconds", "ptxas"}} for what was built;
    raises with the compiler's output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    report = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0,
                        "ptxas": [l for l in log.splitlines()
                                  if "registers" in l or "spill" in l]}
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    if name not in _loaded:
        build_all((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _loaded[name] = lib
    return _loaded[name]


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
