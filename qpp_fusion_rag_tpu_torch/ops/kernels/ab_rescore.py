"""A/B of K6 (the doc-vector rescore match) between two checkouts, on one card.

    python -m qpp_fusion_rag_tpu_torch.ops.kernels.ab_rescore --other PATH

PATH is the root of another checkout of this repository (for example an
earlier commit unpacked with ``git archive`` into a directory that
.gitignore lists). Both libraries are built from their own ``csrc/`` and
loaded side by side; their ``qfr_rescore_match`` entry points are called on
the same tensors, made on the card from a seed at the rank-safe and
certified bench shape: 1024 queries of Tq 8 and 16 terms, 256 candidates
each, rows of Td 128 int32 entries (imp_bits 14) over N docs. Each time is
the median of single calls between two CUDA events, taken in the order
other, this, this, other; the two builds' sums must be bit-equal. This
checkout's instance with the matched-weight output (when its entry point
takes one) is timed after them and its sums must equal the others.

The SASS of every ``rescore_match_kernel`` instance of both libraries
(``cuobjdump -sass``: the instruction text of each function, encodings
and addresses dropped) is hashed and keyed by the instance's template
arguments; an instance without the matched output is compared with the
other build's instance of the same query bucket and load width. The last
line is one JSON object of the times and hashes.

It needs a CUDA card and the toolkit's nvcc; without a card it exits
non-zero.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from qpp_fusion_rag_tpu_torch.ops.kernels.ab_dense import _load_build, _time

IMP_BITS, TD, C = 14, 128, 256


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, type=Path, help="root of the other checkout")
    ap.add_argument("--docs", type=int, default=2_621_440)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_rescore: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parents[3]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    libs, sass = {}, {}
    for tag, root in (("other", args.other.resolve()), ("this", here)):
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


if __name__ == "__main__":
    sys.exit(main())
