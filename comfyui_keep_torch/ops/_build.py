"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` is compiled by its own `nvcc` process into
`build/kernels/lib<name>-<hash>.so` (a plain C interface, no PyTorch
headers, so a build takes seconds), all sources at once. The hash covers the
source and the shared headers, so an edited kernel is rebuilt and a stale
library is never loaded. Nothing here runs at import time.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")
_REPO = os.path.dirname(os.path.dirname(_CSRC))
BUILD_DIR = os.path.join(_REPO, "build", "kernels")
SOURCES = ("attention", "mlp")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of every exported function: pointers and the stream as c_void_p
_SIGNATURES = {
    "attention": {
        "keep_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P),
        "keep_corr_expectation": (_P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    },
    "mlp": {
        "keep_mlp_fused": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _P),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}  # ptxas report of each build, by source


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc for sm_90a) on this machine")
    return path


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(_CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(_CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}-{_digest(name)}.so")


def build_all() -> Dict[str, str]:
    """Compile every source that has no up-to-date library, one nvcc per
    source, all started together. Returns {name: library path}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in SOURCES}
    procs = {}
    for name, path in paths.items():
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(_CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built on first use."""
    with _lock:
        if name not in _libs:
            path = build_all()[name]
            lib = ctypes.CDLL(path)
            for fn, argtypes in _SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]
