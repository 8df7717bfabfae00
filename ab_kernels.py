#!/usr/bin/env python3
"""A/B of the port's CUDA kernels between two checkouts, on one card.

    python3 ab_kernels.py dense --other PATH [--entry]
    python3 ab_kernels.py rescore --other PATH

PATH is the root of another checkout of this repository (for example an
earlier commit unpacked with ``git archive`` into a directory that
.gitignore lists). Both libraries are built from their own ``csrc/`` and
loaded side by side, and their C entry points are called on the same
tensors, made on the card from a seed. Each time is the median of single
calls between two CUDA events, taken in the order other, this, this, other.
The last line is one JSON object of the times.

``dense``: the dense group-max kernels. K1 (qfr_group_max_packed_int8) at
1024 and 5,120 rows, K7 (qfr_group_max_packed, [N, D] rows) at 5,120 rows,
K8 (qfr_group_max_scores) at stride 4 and 1 (tn 2048), K9
(qfr_group_max_int8_global, on K1's int8 rows) and K10
(qfr_streaming_group_max) at 1024 rows, over N docs of width D. K1, K7 and
K9 must be bit-equal between the two builds; K8 and K10 are compared on
integer-valued inputs (bit-equal) and their random-data outputs reported as
the count of differing entries. The ptxas registers and spills of both
builds' dense sources are printed. With --entry it times instead the three
entry points that launch K8, K9 and K10, ``pallas_dense_topk(packed=False,
stride=4)``, ``pallas_dense_topk_int8_global`` and ``streaming_dense_topk``,
at 1024 queries: one process per checkout (each imports its own package),
in the order other, this, this, other, each reporting the median of --reps
calls after a warm-up (host clock around a synchronised call).

``rescore``: K6 (qfr_rescore_match, the doc-vector rescore match) at the
rank-safe and certified bench shape: 1024 queries of Tq 8 and 16 terms, 256
candidates each, rows of Td 128 int32 entries (imp_bits 14) over N docs; the
two builds' sums must be bit-equal. This checkout's instance with the
matched-weight output (when its entry point takes one) is timed after them
and its sums must equal the others. The SASS of every
``rescore_match_kernel`` instance of both libraries (``cuobjdump -sass``:
the instruction text of each function, encodings and addresses dropped) is
hashed and keyed by the instance's template arguments; an instance without
the matched output is compared with the other build's instance of the same
query bucket and load width.

It needs a CUDA card and the toolkit's nvcc; without a card it exits
non-zero.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
DENSE_SOURCES = ("dense_topk_int8.cu", "group_max_packed.cu", "group_max_scores.cu",
                 "group_max_int8_global.cu")
IMP_BITS, TD, C = 14, 128, 256


def _load_build(root: Path, tag: str):
    """The _build module of the checkout at root, imported by file path
    (it locates csrc/ and build/ from its own file)."""
    path = root / "qpp_fusion_rag_tpu_torch" / "ops" / "kernels" / "_build.py"
    spec = importlib.util.spec_from_file_location(f"_ab_build_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ptxas(log: str):
    src, lines = None, []
    for line in log.splitlines():
        if line.startswith("== "):
            src = line[3:].strip()
        elif src in DENSE_SOURCES and any(k in line for k in ("Compiling entry", "registers",
                                                              "spill", "C7517")):
            lines.append(f"{src}: {line.strip()[:200]}")
    return lines


def _time(fn, reps):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return float(statistics.median(out))


def _calls(lib, q1, q5, qi1, qi5, rows_bf16, rows_i8, scale, stream):
    """name -> (launch, outputs) of one library's C entry points."""
    N, D = rows_bf16.shape
    dev = rows_bf16.device
    G = -(-N // 128)
    n_pad = -(-N // 2048) * 2048
    n_sup = -(-N // 16384) * 16384 // 128
    out = {}

    def packed_int8(q):
        o = torch.empty((q.shape[0], G), dtype=torch.float32, device=dev)
        return (lambda: lib.qfr_group_max_packed_int8(
            q.data_ptr(), rows_i8.data_ptr(), scale.data_ptr(), q.shape[0], N, D, N,
            o.data_ptr(), stream)), (o,)

    def packed(q):
        o = torch.empty((q.shape[0], G), dtype=torch.float32, device=dev)
        return (lambda: lib.qfr_group_max_packed(
            q.data_ptr(), rows_bf16.data_ptr(), q.shape[0], N, D, N, 0, o.data_ptr(),
            stream)), (o,)

    def packed_int8_global(q):
        o = torch.empty((q.shape[0], G), dtype=torch.int32, device=dev)
        return (lambda: lib.qfr_group_max_int8_global(
            q.data_ptr(), rows_i8.data_ptr(), q.shape[0], N, D, N, o.data_ptr(), stream)), (o,)

    def argmax(q, n_out, entry, *extra):
        v = torch.empty((q.shape[0], n_out), dtype=torch.float32, device=dev)
        i = torch.empty((q.shape[0], n_out), dtype=torch.int32, device=dev)
        return (lambda: entry(q.data_ptr(), rows_bf16.data_ptr(), q.shape[0], N, D, N, n_out,
                              *extra, v.data_ptr(), i.data_ptr(), stream)), (v, i)

    out["K1_1024"] = packed_int8(qi1)
    out["K1_5120"] = packed_int8(qi5)
    out["K7_5120"] = packed(q5)
    out["K8_stride4"] = argmax(q1, n_pad // 512, lib.qfr_group_max_scores, 16, 4)
    out["K8_stride1"] = argmax(q1, n_pad // 128, lib.qfr_group_max_scores, 16, 1)
    out["K10"] = argmax(q1, n_sup, lib.qfr_streaming_group_max)
    out["K9_1024"] = packed_int8_global(qi1)
    return out


ENTRY = """
import json, statistics, sys, time, torch
from qpp_fusion_rag_tpu_torch.ops.kernels import dense_topk, streaming_topk
N, D, reps, seed = map(int, sys.argv[1:5])
gen = torch.Generator(device="cuda").manual_seed(seed)
rows = torch.empty((N, D), dtype=torch.bfloat16, device="cuda")
for n0 in range(0, N, 262_144):
    rows[n0:n0 + 262_144] = torch.randn((min(N, n0 + 262_144) - n0, D), generator=gen,
                                        device="cuda")
q = torch.randn((1024, D), generator=gen, device="cuda")
scale = rows.abs().amax().float() / 127          # one global scale, as quantize_global
rows_g = torch.empty((N, D), dtype=torch.int8, device="cuda")
for n0 in range(0, N, 262_144):
    rows_g[n0:n0 + 262_144] = torch.clamp(torch.round(rows[n0:n0 + 262_144].float() / scale),
                                          -127, 127).to(torch.int8)
calls = {
    "pallas_dense_topk_stride4": lambda: dense_topk.pallas_dense_topk(
        q, rows, k=100, packed=False, stride=4),
    "pallas_dense_topk_int8_global": lambda: dense_topk.pallas_dense_topk_int8_global(
        q, rows_g, scale, k=100),
    "streaming_dense_topk": lambda: streaming_topk.streaming_dense_topk(q, rows, k=100),
}
out = {}
for name, fn in calls.items():
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out[name] = statistics.median(times)
print(json.dumps(out))
"""


def entry_ab(other: Path, here: Path, args) -> dict:
    """The entry points' times in one process per checkout."""
    times = {}
    for tag, root in (("other", other), ("this", here), ("this", here), ("other", other)):
        r = subprocess.run([sys.executable, "-c", ENTRY, str(args.docs), str(args.dim),
                            str(args.reps), str(args.seed)], cwd=root, capture_output=True,
                           text=True, env={**os.environ, "PYTHONPATH": str(root)})
        if r.returncode != 0:
            raise RuntimeError(f"{tag} entry points failed:\n{r.stdout}{r.stderr}")
        for name, ms in json.loads(r.stdout.strip().splitlines()[-1]).items():
            times.setdefault(name, []).append(ms)
    for name, t in times.items():
        print(f"{name}: other / this / this / other ms " + " / ".join(f"{x:.3f}" for x in t))
    return times


def dense(args, smi: str) -> int:
    """The dense group-max kernels (K1, K7-K10), or with --entry the K8 / K9
    / K10 entry points."""
    if args.entry:
        times = entry_ab(args.other.resolve(), HERE, args)
        print(json.dumps({"card": smi, "docs": args.docs, "dim": args.dim, "entry_ms": times}))
        return 0
    libs = {}
    for tag, root in (("other", args.other.resolve()), ("this", HERE)):
        b = _load_build(root, tag)
        path, secs, log = b.build_library()
        libs[tag] = b.load_library()
        print(f"{tag}: {path} built in {secs:.1f} s", flush=True)
        for line in _ptxas(log):
            print(f"  {tag} ptxas {line}")

    from qpp_fusion_rag_tpu_torch.ops.kernels.dense_topk import quantize_rows

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    N, D = args.docs, args.dim
    rows_bf16 = torch.empty((N, D), dtype=torch.bfloat16, device=dev)
    rows_i8 = torch.empty((N, D), dtype=torch.int8, device=dev)
    scale = torch.empty(N, dtype=torch.float32, device=dev)
    for n0 in range(0, N, 262_144):
        x = torch.randn((min(N, n0 + 262_144) - n0, D), generator=gen, device=dev)
        qx, s = quantize_rows(x)
        rows_bf16[n0:n0 + x.shape[0]] = x
        rows_i8[n0:n0 + x.shape[0]] = qx
        scale[n0:n0 + x.shape[0]] = s[:, 0]
    q5f = torch.randn((5120, D), generator=gen, device=dev)
    q5 = q5f.to(torch.bfloat16)
    q1 = q5[:1024].contiguous()
    qi5 = quantize_rows(q5f)[0]
    qi1 = qi5[:1024].contiguous()
    stream = torch.cuda.current_stream().cuda_stream
    calls = {tag: _calls(lib, q1, q5, qi1, qi5, rows_bf16, rows_i8, scale, stream)
             for tag, lib in libs.items()}

    times = {name: [] for name in calls["this"]}
    for tag in ("other", "this", "this", "other"):
        for name, (launch, _) in calls[tag].items():
            rc = launch()
            if rc != 0:
                raise RuntimeError(f"{tag} {name}: CUDA error {rc}")
            times[name].append(_time(launch, args.reps))
    torch.cuda.synchronize()
    same = {}
    for name in times:
        a, b = calls["other"][name][1], calls["this"][name][1]
        same[name] = [int((x.view(torch.int32) != y.view(torch.int32)).sum()) for x, y in zip(a, b)]
        print(f"{name}: other / this / this / other ms "
              + " / ".join(f"{t:.3f}" for t in times[name])
              + f"; entries that differ between the builds {same[name]}", flush=True)
    for name in ("K1_1024", "K1_5120", "K7_5120", "K9_1024"):
        if any(same[name]):
            raise AssertionError(f"{name}: the two builds disagree")

    # K8 and K10 on integer-valued inputs: every f32 sum exact in any order
    gi = torch.Generator(device=dev).manual_seed(args.seed + 1)
    rows_bf16 = torch.randint(-2, 3, (65_536, D), generator=gi, device=dev).to(torch.bfloat16)
    q1 = torch.randint(-2, 3, (1000, D), generator=gi, device=dev).to(torch.bfloat16)
    ints = {tag: _calls(lib, q1, q1, qi1, qi1, rows_bf16, rows_i8[:65_536], scale[:65_536],
                        stream) for tag, lib in libs.items()}
    for name in ("K8_stride4", "K8_stride1", "K10"):
        for tag in ints:
            ints[tag][name][0]()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(ints["other"][name][1],
                                                     ints["this"][name][1])):
            raise AssertionError(f"{name}: the builds disagree on integer-valued inputs")
    print("K8 (stride 4 and 1) and K10 on integer-valued inputs [1000, D] x [65536, D]: "
          "bit-equal between the builds")
    print(json.dumps({"card": smi, "docs": N, "dim": D, "ms": times, "differ": same}))
    return 0


def sass_hashes(build, lib_path: Path) -> dict:
    """{template args of each rescore_match_kernel instance (strings): md5
    of its SASS instruction text}."""
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    out, key, body = {}, None, []
    for line in text.splitlines() + ["Function : end"]:
        if m := re.search(r"Function : (\S+)", line):
            if key is not None:
                out[key] = hashlib.md5("\n".join(body).encode()).hexdigest()
            k = re.search(r"rescore_match_kernelI((?:L[ib]-?\d+E)+)E", m.group(1))
            key = tuple(re.findall(r"L[ib](-?\d+)E", k.group(1))) if k else None
            body = []
        elif key is not None and (m := re.search(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", line)):
            body.append(m.group(1).strip())
    return out


def _call(lib, doc, ids, qt, qw, out, matched=None):
    """One launch of a build's entry point: the matched pointer goes only
    to an entry point that takes one."""
    B, Tq = qt.shape
    args = [doc.data_ptr(), doc.shape[0], TD, ids.data_ptr(), B, C, qt.data_ptr(),
            qw.data_ptr(), Tq, IMP_BITS, 1, out.data_ptr()]
    if len(lib.qfr_rescore_match.argtypes) == 14:
        args.append(None if matched is None else matched.data_ptr())
    elif matched is not None:
        raise ValueError("this build's K6 has no matched output")
    rc = lib.qfr_rescore_match(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qfr_rescore_match: CUDA error {rc}")


def rescore(args, smi: str) -> int:
    """K6 (the doc-vector rescore match) and its SASS hashes."""
    libs, sass = {}, {}
    for tag, root in (("other", args.other.resolve()), ("this", HERE)):
        b = _load_build(root, tag)
        path, secs, _ = b.build_library()
        libs[tag] = b.load_library()
        sass[tag] = sass_hashes(b, path)
        print(f"{tag}: {path} built in {secs:.1f} s; K6 instances {sorted(sass[tag])}",
              flush=True)
    same_sass = {",".join(k): sass["this"][k + ("0",)] == h for k, h in sass["other"].items()
                 if k + ("0",) in sass["this"]}
    print(f"SASS of the instances without the matched output equal to the other build's: "
          f"{same_sass}", flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    N, B = args.docs, args.batch
    doc = ((torch.randint(0, 100_000, (N, TD), generator=gen, device=dev) << IMP_BITS)
           | torch.randint(0, 1 << IMP_BITS, (N, TD), generator=gen, device=dev)).int()
    ids = torch.randint(0, N, (B, C), generator=gen, device=dev, dtype=torch.int32)
    res = {}
    for tq in (8, 16):
        qt = torch.randint(0, 100_000, (B, tq), generator=gen, device=dev, dtype=torch.int32)
        qw = torch.rand((B, tq), generator=gen, device=dev) + 0.1
        rows = doc[ids[:, ::2].reshape(-1).long()]          # every other candidate matches
        rows[:, :tq] = (qt.repeat_interleave(C // 2, dim=0) << IMP_BITS) | 7
        doc[ids[:, ::2].reshape(-1).long()] = rows
        outs = {tag: torch.empty((B, C), device=dev) for tag in libs}
        times = {"other": [], "this": []}
        for tag in ("other", "this", "this", "other"):
            times[tag].append(_time(lambda: _call(libs[tag], doc, ids, qt, qw, outs[tag]),
                                    args.reps))
        torch.cuda.synchronize()
        if not torch.equal(outs["other"], outs["this"]):
            raise AssertionError(f"Tq {tq}: the two builds' sums differ")
        entry = {"other_ms": times["other"], "this_ms": times["this"]}
        if len(libs["this"].qfr_rescore_match.argtypes) == 14:
            out, matched = torch.empty_like(outs["this"]), torch.empty_like(outs["this"])
            entry["this_matched_ms"] = _time(
                lambda: _call(libs["this"], doc, ids, qt, qw, out, matched), args.reps)
            torch.cuda.synchronize()
            if not torch.equal(out, outs["this"]):
                raise AssertionError(f"Tq {tq}: the matched instance's sums differ")
        res[f"tq{tq}"] = entry
        print(f"Tq {tq}: other / this / this / other ms "
              + " / ".join(f"{t:.4f}" for t in (*times["other"][:1], *times["this"],
                                                 times["other"][1]))
              + (f"; with the matched output {entry['this_matched_ms']:.4f} ms"
                 if "this_matched_ms" in entry else "")
              + "; sums bit-equal between the builds", flush=True)
    print(json.dumps({"card": smi, "docs": N, "batch": B, "ms": res, "same_sass": same_sass,
                      "sass": {t: {",".join(k): h for k, h in v.items()}
                               for t, v in sass.items()}}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="kernels", required=True)
    d = sub.add_parser("dense", help="K1, K7-K10 (or the K8 / K9 / K10 entry points)")
    r = sub.add_parser("rescore", help="K6")
    for p, reps in ((d, 5), (r, 20)):
        p.add_argument("--other", required=True, type=Path, help="root of the other checkout")
        p.add_argument("--docs", type=int, default=2_621_440)
        p.add_argument("--reps", type=int, default=reps)
        p.add_argument("--seed", type=int, default=0)
    d.add_argument("--dim", type=int, default=768)
    d.add_argument("--entry", action="store_true", help="time the K8 / K9 / K10 entry points")
    r.add_argument("--batch", type=int, default=1024)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_kernels: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    return (dense if args.kernels == "dense" else rescore)(args, smi)


if __name__ == "__main__":
    sys.exit(main())
