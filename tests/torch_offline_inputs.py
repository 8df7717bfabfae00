"""Seeded inputs shared by the offline-path parity tests (tests/test_torch_
{data,metrics,evaluation,fusion_engine,trainer}.py): TREC-style run dicts,
qrels and BEIR-shaped files, made with numpy from a seed."""

import json

import numpy as np


def make_runs(seed, R=4, Q=40, K=30, n_docs=150, missing=((0, 3),), integer=True):
    """{retriever: {qid: [(docid, score, rank)]}}: rows of 1..K docs drawn
    from n_docs docnos, scores descending with ties (multiples of 0.25 when
    `integer`, exact in f32 and in .6f; else uniform draws); each row's
    entries are listed in shuffled order, ranks 1..n by position. The
    (retriever, query) pairs in `missing` have no row (an all-PAD row)."""
    rng = np.random.default_rng(seed)
    qids = [f"test{i}" for i in range(Q)]
    runs = {}
    for r in range(R):
        run = {}
        for qi, q in enumerate(qids):
            if (r, qi) in missing:
                continue
            n = int(rng.integers(1, K + 1))
            docs = rng.choice(n_docs, n, replace=False)
            if integer:
                s = rng.integers(0, 24, n).astype(np.float64) * 0.25 + r
            else:
                s = rng.uniform(0.0, 10.0, n).astype(np.float32).astype(np.float64)
            s = np.sort(s)[::-1]
            entries = [(f"d{d}", float(v), i + 1) for i, (d, v) in enumerate(zip(docs, s))]
            order = rng.permutation(n)
            run[q] = [entries[i] for i in order]
        runs[f"ret{r}"] = run
    return runs


def make_qrels(seed, qids, n_docs=150, judged_frac=0.8):
    """{qid: {docno: grade}} for a share of the qids: 1-4 positive docs at
    grades 1-2, a judged non-relevant doc (grade 0) and, for some queries,
    a docno no run holds."""
    rng = np.random.default_rng(seed)
    qrels = {}
    for qi, q in enumerate(qids):
        if rng.uniform() > judged_frac:
            continue
        rel = {f"d{d}": int(rng.integers(1, 3))
               for d in rng.choice(n_docs, int(rng.integers(1, 5)), replace=False)}
        rel[f"d{int(rng.integers(0, n_docs))}"] = 0
        if qi % 5 == 0:
            rel[f"unknown{qi}"] = 2
        qrels[q] = rel
    return qrels


def write_beir(root, qrels, qids, n_docs=150, header=True):
    """queries.jsonl, qrels/test.tsv and corpus.jsonl under `root`."""
    (root / "qrels").mkdir(parents=True, exist_ok=True)
    with open(root / "queries.jsonl", "w") as f:
        for i, q in enumerate(qids + ["train0", "train1"]):
            f.write(json.dumps({"_id": q, "text": f"query {i} about term{i % 7} and w{i}"})
                    + "\n")
    with open(root / "qrels" / "test.tsv", "w") as f:
        if header:
            f.write("query-id\tcorpus-id\tscore\n")
        for q, rels in qrels.items():
            for d, g in rels.items():
                f.write(f"{q}\t{d}\t{g}\n")
    with open(root / "corpus.jsonl", "w") as f:
        for i in range(n_docs):
            f.write(json.dumps({"_id": f"d{i}", "title": f"title {i}" if i % 3 else "",
                                "text": f"body {i} alpha beta"}) + "\n")
