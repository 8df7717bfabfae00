"""ctypes binding of the native tokenizer and CSR builder
(native/sparse_index.cpp, native/porter.hpp at the root of the checkout).

Counterpart of qpp_fusion_rag_tpu/index/native.py, with the same
NativeIndexBuilder API. The C++ side owns tokenization (lowercase alnum
split, stopwords, Porter stemming) and the CSR / impact-list build; this
module is a thin typed wrapper. The port builds its own copy of the shared
library with g++, called directly, into
``build/torch_native/lib<hash of the sources and flags>.so`` on first use
(written under a private name, then renamed into place, so concurrent
builders never load a half-written file). It never writes into native/.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
SOURCES = ("sparse_index.cpp", "porter.hpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"lib{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile native/sparse_index.cpp unless the hashed library exists."""
    path = library_path()
    if path.is_file():
        return path
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found (set CXX); the native index builder cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{path.stem}.{os.getpid()}.tmp.so"
    cmd = [cxx, *CXX_FLAGS, str(NATIVE_DIR / "sparse_index.cpp"), "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"native build failed ({r.returncode}):\n{' '.join(cmd)}\n"
                               f"{r.stdout}{r.stderr}")
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return path


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the native library, argtypes declared."""
    lib = ctypes.CDLL(str(build_library()))
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    P = ctypes.c_void_p
    for name, restype, argtypes in (
            ("qpp_idx_new", P, [ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int]),
            ("qpp_idx_free", None, [P]),
            ("qpp_idx_add_doc", None, [P, ctypes.c_char_p]),
            ("qpp_idx_add_docs", None, [P, ctypes.c_char_p, ctypes.c_int]),
            ("qpp_idx_finalize", None, [P, ctypes.c_int]),
            ("qpp_idx_num_terms", ctypes.c_int32, [P]),
            ("qpp_idx_num_docs", ctypes.c_int32, [P]),
            ("qpp_idx_num_postings", ctypes.c_int64, [P]),
            ("qpp_idx_export", None, [P, i64, i32, f32]),
            ("qpp_idx_export_doclens", None, [P, i32]),
            ("qpp_idx_vocab_dump", ctypes.c_int64, [P, ctypes.c_char_p, ctypes.c_int64]),
            ("qpp_idx_vocab_load", None, [P, ctypes.c_char_p]),
            ("qpp_idx_query_terms", ctypes.c_int32,
             [P, ctypes.c_char_p, i32, f32, ctypes.c_int32])):
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


class NativeIndexBuilder:
    """RAII handle over the C++ index builder."""

    def __init__(self, k1: float = 0.9, b: float = 0.4,
                 stem: bool = True, stopwords: bool = True):
        self.lib = load_library()
        self.h = self.lib.qpp_idx_new(k1, b, int(stem), int(stopwords))

    @staticmethod
    def _to_bytes(text: str) -> bytes:
        # NUL separates documents on the C side (and ends a c_char_p): an
        # embedded NUL would split one doc into two and shift every later
        # docno -> row mapping, so it becomes a space
        return text.replace("\x00", " ").encode("utf-8", "ignore")

    def add_doc(self, text: str) -> None:
        self.lib.qpp_idx_add_doc(self.h, self._to_bytes(text))

    def add_docs(self, texts) -> None:
        blob = b"\0".join(self._to_bytes(t) for t in texts) + b"\0"
        self.lib.qpp_idx_add_docs(self.h, blob, len(texts))

    def finalize(self, bm25_weights: bool = True) -> None:
        self.lib.qpp_idx_finalize(self.h, int(bm25_weights))

    @property
    def num_terms(self) -> int:
        return int(self.lib.qpp_idx_num_terms(self.h))

    @property
    def num_docs(self) -> int:
        return int(self.lib.qpp_idx_num_docs(self.h))

    @property
    def num_postings(self) -> int:
        return int(self.lib.qpp_idx_num_postings(self.h))

    def export(self):
        """-> (offsets int64 [T+1], docs int32 [P], weights f32 [P], doc_lens)."""
        T, P, D = self.num_terms, self.num_postings, self.num_docs
        offsets = np.zeros(T + 1, dtype=np.int64)
        docs = np.zeros(P, dtype=np.int32)
        weights = np.zeros(P, dtype=np.float32)
        doc_lens = np.zeros(D, dtype=np.int32)
        self.lib.qpp_idx_export(self.h, offsets, docs, weights)
        self.lib.qpp_idx_export_doclens(self.h, doc_lens)
        return offsets, docs, weights, doc_lens

    def vocab_dump(self) -> str:
        need = self.lib.qpp_idx_vocab_dump(self.h, None, 0)
        buf = ctypes.create_string_buffer(int(need) + 1)
        self.lib.qpp_idx_vocab_dump(self.h, buf, need + 1)
        return buf.raw[:need].decode("utf-8")

    def vocab_load(self, dump: str) -> None:
        self.lib.qpp_idx_vocab_load(self.h, dump.encode("utf-8"))

    def query_terms(self, text: str, max_terms: int = 64):
        ids = np.zeros(max_terms, dtype=np.int32)
        counts = np.zeros(max_terms, dtype=np.float32)
        n = self.lib.qpp_idx_query_terms(self.h, text.encode("utf-8", "ignore"), ids, counts,
                                         max_terms)
        return ids[:n].copy(), counts[:n].copy()

    def close(self) -> None:
        if self.h:
            self.lib.qpp_idx_free(self.h)
            self.h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
