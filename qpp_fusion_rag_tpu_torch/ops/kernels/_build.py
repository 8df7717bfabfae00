"""Build the port's CUDA kernels and load them through ctypes.

Every ``csrc/*.cu`` source compiles with nvcc into ONE shared library with
a plain C interface, ``build/torch_kernels/lib<hash>.so`` under the
checkout, keyed by a hash of the sources and flags, so an unchanged tree
builds once. No PyTorch headers are included: a plain-C build takes
seconds where a ``torch.utils.cpp_extension`` build takes minutes.

The flags deliberately omit ``-use_fast_math`` / ``-ftz=true``: the dense
kernel packs a 7-bit lane index into the low mantissa bits of each score,
which turns a zero score into a denormal; flush-to-zero would corrupt both
the group max and the unpacked lane.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises on a non-zero code, so a refused launch never passes
silently.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry point -> argtypes (every entry returns int: a cudaError_t)
SIGNATURES = {
    # src, P, starts, G, cap, out, vec, stream
    "qfr_gather_windows": (_P, _LL, _P, _LL, _I, _P, _I, _P),
    # keys, B, M, start_block, plus_one, sums, sids, stream
    "qfr_bitonic_segsum": (_P, _I, _I, _I, _I, _P, _P, _P),
    # q, corpus_rows, d_scale, M, N, D, n_real, out, stream
    "qfr_group_max_packed_int8": (_P, _P, _P, _I, _I, _I, _I, _P, _P),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{h.hexdigest()[:16]}.so"


def build_library():
    """Compile csrc/*.cu unless the hashed library exists.
    -> (path, seconds spent compiling (0.0 on a hit), compiler log)."""
    path = library_path()
    if path.is_file():
        return path, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = r.stdout + r.stderr
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, path)
    return path, seconds, log


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels, argtypes declared."""
    path, _, _ = build_library()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.qfr_error_string.argtypes = [ctypes.c_int]
    lib.qfr_error_string.restype = ctypes.c_char_p
    return lib


def check(lib, rc: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if rc != 0:
        msg = lib.qfr_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """The raw cudaStream_t of PyTorch's current stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream
