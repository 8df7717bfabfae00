"""Build the port's CUDA kernels and load them through ctypes.

Every ``csrc/*.cu`` source compiles with its own nvcc process, all started
together, and the objects link into ONE shared library with a plain C
interface, ``build/torch_kernels/lib<hash>.so`` under the checkout, keyed
by a hash of the sources (``*.cuh`` included) and flags, so an unchanged
tree builds once. No PyTorch headers are included: a plain-C build takes
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry point -> argtypes (every entry returns int: a cudaError_t)
SIGNATURES = {
    # src, P, starts, G, cap, out, vec, stream
    "qfr_gather_windows": (_P, _LL, _P, _LL, _I, _P, _I, _P),
    # keys, B, M, start_block, plus_one, sums, sids, stream
    "qfr_bitonic_segsum": (_P, _I, _I, _I, _I, _P, _P, _P),
    # keys, B, M, start_block, out, stream
    "qfr_bitonic_sort": (_P, _I, _I, _I, _P, _P),
    # keys, B, M, bs, start_block, out, stream
    "qfr_bitonic_topp": (_P, _I, _I, _I, _I, _P, _P),
    # doc_packed, N, Td, cand_ids, B, C, q_terms, q_weights, Tq, imp_bits, vec, out,
    # matched (nullable), stream
    "qfr_rescore_match": (_P, _LL, _I, _P, _I, _I, _P, _P, _I, _I, _I, _P, _P, _P),
    # q, corpus_rows, d_scale, M, N, D, n_real, out, stream
    "qfr_group_max_packed_int8": (_P, _P, _P, _I, _I, _I, _I, _P, _P),
    # q, corpus, M, N, D, n_real, transposed, out, stream
    "qfr_group_max_packed": (_P, _P, _I, _I, _I, _I, _I, _P, _P),
    # q, corpus, M, N, D, n_real, n_out, g, stride, vals, ids, stream
    "qfr_group_max_scores": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    # q, corpus_rows, M, N, D, n_real, out, stream
    "qfr_group_max_int8_global": (_P, _P, _I, _I, _I, _I, _P, _P),
    # q, corpus, M, N, D, n_real, n_groups, vals, ids, stream
    "qfr_streaming_group_max": (_P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
    # x, M, G, k, vec, vals, cols, stream
    "qfr_row_topk": (_P, _I, _I, _I, _I, _P, _P, _P),
    # sids, svals, B, M, k, vec, scratch (nullable), scores, ids, stream
    "qfr_run_sums_topk": (_P, _P, _I, _I, _I, _I, _P, _P, _P, _P),
    # M -> floats of global scratch a row (0: staged)
    "qfr_run_sums_scratch": (_I,),
    # sums, sids, wmax, B, M, k, vec, wide, scores, ids, stream
    "qfr_q8_topk": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
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
    """Compile csrc/*.cu unless the hashed library exists: one nvcc process
    per source, all running at once, then one link.
    -> (path, seconds spent compiling (0.0 on a hit), compiler log)."""
    path = library_path()
    if path.is_file():
        return path, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    t0 = time.perf_counter()
    try:
        procs = [(src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src, obj in zip(_sources(), objs)]
        logs, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
        tmp = BUILD_DIR / f"{tag}.tmp.so"
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n{' '.join(cmd)}\n"
                               f"{r.stdout}{r.stderr}")
        os.replace(tmp, path)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return path, time.perf_counter() - t0, log


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
