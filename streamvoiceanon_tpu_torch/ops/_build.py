"""Build and load the port's native code (compiler -> shared library -> ctypes).

Each `csrc/<name>.cu` is compiled for sm_90a into its own shared library
with a plain C interface, named by a hash of the sources so that a changed
source rebuilds.  `csrc/<name>.cpp` (the audio transport's SPSC ring) is
built the same way with the host compiler (`load_host`).  The build
directory, `streamvoiceanon_tpu_torch/_build/`, is listed in `.gitignore`.
`build_all` starts one nvcc per source, all together.  Nothing here runs
at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U64 = ctypes.c_uint64
_FP = ctypes.POINTER(ctypes.c_float)

# C signatures of the entry points, by source
SIGNATURES = {
    "slow_decode": ("svd_slow_decode_step",
                    [_I, _I] + [_P] * 11 + [_I] + [_P] * 14 + [_I] * 7
                    + [_F, _F, _F, _I, _P]),
    "fast_decode": ("svd_fast_decode",
                    [_I] + [_P] * 25 + [_I] * 10 + [_F] * 4 + [_I, _P]),
    "wt_stream": ("svd_wt_stream_step", [_I, _I] + [_P] * 21 + [_I] * 10 + [_F, _F, _P]),
    "hifigan_head": ("svd_hifigan_head_step", [_P] * 6 + [_I] + [_P] * 2 + [_I] * 2 + [_P]),
    "convnext_enc": ("svd_convnext_enc_step", [_P, _P, _I, _I] + [_P] * 10 + [_I] * 10 + [_P]),
    "decode_attention": ("svd_decode_attention", [_I] + [_P] * 8 + [_I] * 7 + [_F, _P]),
}
# further entry points, by name: (source, C signature)
EXTRA_ENTRY_POINTS = {
    "svd_slow_attention": ("slow_decode", [_I, _I] + [_P] * 4 + [_I] + [_P] * 5 + [_I] * 4
                           + [_P]),
}

# host-compiled sources: flags, and (return type, argument types) by entry point
HOST_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
HOST_SIGNATURES = {
    "ringbuffer": {
        "svan_ring_create": (_P, [_U64]),
        "svan_ring_destroy": (None, [_P]),
        "svan_ring_capacity": (_U64, [_P]),
        "svan_ring_available": (_U64, [_P]),
        "svan_ring_space": (_U64, [_P]),
        "svan_ring_write": (_U64, [_P, _FP, _U64]),
        "svan_ring_read": (_U64, [_P, _FP, _U64]),
        "svan_ring_peek": (_U64, [_P, _FP, _U64]),
        "svan_ring_overruns": (_U64, [_P]),
        "svan_ring_underruns": (_U64, [_P]),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, str]:
    """Compile every source whose library is missing, one nvcc each, all
    started together.  Returns the compiler's messages (ptxas register and
    shared-memory use) by source.  Raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SIGNATURES:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(
            f"{n}:\n{logs[n]}" for n in failed))
    return logs


def load(name: str):
    """The entry point of `csrc/<name>.cu`, or the entry point `name` of
    EXTRA_ENTRY_POINTS, as a ctypes function (built on first use)."""
    if name in EXTRA_ENTRY_POINTS:
        src, argtypes = EXTRA_ENTRY_POINTS[name]
        fn_name = name
    else:
        src = name
        fn_name, argtypes = SIGNATURES[name]
    with _lock:
        if src not in _libs:
            path = library_path(src)
            if not path.exists():
                build_all()
            _libs[src] = ctypes.CDLL(str(path))
        fn = getattr(_libs[src], fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn


def host_library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes())
    h.update(" ".join(HOST_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def load_host(name: str) -> ctypes.CDLL:
    """The library of `csrc/<name>.cpp`, built with the host compiler ($CXX,
    else g++) on first use, its entry points typed from HOST_SIGNATURES.
    Raises if the build fails: there is no fallback."""
    key = f"host:{name}"
    with _lock:
        if key not in _libs:
            path = host_library_path(name)
            if not path.exists():
                cxx = shutil.which(os.environ.get("CXX", "g++"))
                if cxx is None:
                    raise RuntimeError(f"no host C++ compiler to build csrc/{name}.cpp")
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                r = subprocess.run([cxx, *HOST_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp")],
                                   capture_output=True, text=True)
                if r.returncode != 0:
                    raise RuntimeError(f"{cxx} failed for csrc/{name}.cpp:\n{r.stdout}{r.stderr}")
                os.replace(tmp, path)
            lib = ctypes.CDLL(str(path))
            for fn_name, (restype, argtypes) in HOST_SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.restype, fn.argtypes = restype, argtypes
            _libs[key] = lib
        return _libs[key]
