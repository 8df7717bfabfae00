"""Configuration with ${VAR:default} environment expansion and dot access.

Counterpart of qpp_fusion_rag_tpu/config.py. The JAX package reads
config/defaults.yaml with pyyaml, which the card's machine lacks, so the
port keeps its own copy of that file as a Python literal (DEFAULTS, with
the ``${VAR}`` / ``${VAR:default}`` placeholders intact) and expands it at
load time exactly as JAX expands the YAML. ``Config.load(path)`` (or the
``QPP_CONFIG`` environment variable, as in JAX) reads a user YAML file
through an optional ``import yaml`` and raises ImportError naming pyyaml
when it is absent; with no path it never imports yaml.
tests/test_torch_config.py holds ``config.to_dict()`` equal to JAX's, so a
change to defaults.yaml that is not copied here fails a test.
"""

from __future__ import annotations

import copy
import os
import re
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional

# Default part excludes braces so innermost placeholders expand first;
# _expand iterates to a fixpoint, supporting ${A:${B}/suffix} nesting.
_PLACEHOLDER = re.compile(r"\$\{([A-Za-z_][A-Za-z0-9_]*)(?::([^{}]*))?\}")

PROJECT_ROOT = Path(__file__).resolve().parent.parent
# The YAML file that DEFAULTS copies. Config.load() does not read it: the
# tests hold the copy equal to it.
DEFAULT_CONFIG_PATH = PROJECT_ROOT / "config" / "defaults.yaml"

_QA_SYSTEM = (
    "You are a precise question answering assistant.\n"
    "Answer the question using ONLY the provided context.\n"
    "If the answer is not in the context, say 'I cannot answer.'\n"
    "Be concise and direct.\n")
_QA_USER = "Context:\n{context}\n\nQuestion: {query}\n\nAnswer:\n"
_FV_SYSTEM = (
    "You are a scientific fact verification assistant.\n"
    "Your task is to verify whether the given claim is supported or contradicted by "
    "the provided evidence.\n"
    "\n"
    "You MUST respond with EXACTLY one of these labels:\n"
    "- SUPPORT: The evidence supports the claim\n"
    "- CONTRADICT: The evidence contradicts the claim\n"
    "- NOT_ENOUGH_INFO: The evidence neither supports nor contradicts the claim\n"
    "\n"
    "First provide a brief rationale (1-2 sentences), then state your final verdict "
    "on a new line starting with \"Verdict:\"\n")
_FV_USER = ("Evidence:\n{context}\n\nClaim: {claim}\n\nBased on the evidence above, is "
            "this claim SUPPORT, CONTRADICT, or NOT_ENOUGH_INFO?\n")
_LABELS = ["SUPPORT", "CONTRADICT", "NOT_ENOUGH_INFO"]

# config/defaults.yaml as yaml.safe_load reads it, placeholders unexpanded.
DEFAULTS: Dict[str, Any] = {
    "paths": {
        "cache_root": "${PROJECT_ROOT}/cache",
        "data_root": "${PROJECT_ROOT}/data",
        "beir_datasets": "${BEIR_PATH:${PROJECT_ROOT}/data/beir}",
    },
    "datasets": {
        "supported": ["nq", "hotpotqa", "scifact"],
        "nq": {"name": "Natural Questions", "corpus_subdir": "BEIR-nq",
               "qrels_file": "qrels/test.tsv", "task_type": "qa",
               "gold_answers_file": "nq_gold_answers.json"},
        "hotpotqa": {"name": "HotpotQA", "corpus_subdir": "BEIR-hotpotqa",
                     "qrels_file": "qrels/test.tsv", "task_type": "qa",
                     "gold_answers_file": "hotpotqa_gold_answers.json"},
        "scifact": {"name": "SciFact", "corpus_subdir": "BEIR-scifact",
                    "qrels_file": "qrels/test.tsv", "task_type": "fact_verification",
                    "gold_answers_file": "scifact_gold_answers.json",
                    "labels": list(_LABELS)},
    },
    "models": {
        "bge": {"name": "BAAI/bge-base-en-v1.5", "embedding_dim": 768},
        "tct_colbert": {"name": "castorini/tct_colbert-v2-hnp-msmarco", "embedding_dim": 768},
        "splade": {"name": "naver/splade-cocondenser-ensembledistil"},
        "cross_encoder": {"name": "cross-encoder/ms-marco-MiniLM-L-6-v2"},
        "llm": {"base_url": "${LLM_URL:http://localhost:1234/v1}",
                "default_model": "qwen/qwen3-4b-2507",
                "embed_model": "text-embedding-bge-small-en-v1.5",
                "timeout_seconds": 60},
    },
    "processing": {
        "batch_sizes": {"encoding": 256, "retrieval": 1024, "rerank": 256},
        "retrieval": {"top_k": 100, "first_stage_k": 100},
    },
    "qpp": {
        "n_methods": 13,
        "cutoff_k": 50,
        "methods": ["nqc", "smv", "wig", "SigmaMax", "SigmaX", "RSD", "UEF", "MaxIDF",
                    "avgidf", "cumnqc", "snqc", "dense-qpp", "dense-qpp-m"],
        "method_index": {"SMV": 0, "Sigma_max": 1, "Sigma(%)": 2, "NQC": 3, "UEF": 4,
                         "RSD": 5, "QPP-PRP": 6, "WIG": 7, "SCNQC": 8, "QV-NQC": 9,
                         "DM": 10, "NQA-QPP": 11, "BERTQPP": 12},
        "default_method": "RSD",
        "default_index": 5,
        "normalization": "minmax",
    },
    "fusion": {
        "rrf_k": 60,
        "ranx_norm": "min-max",
        "methods": ["combsum", "combmnz", "rrf", "wcombsum", "wcombmnz", "wrrf", "learned"],
    },
    "evaluation": {
        "ir_metrics": ["nDCG@5", "nDCG@10", "nDCG@20", "RR@5", "RR@10", "R@5", "R@10",
                       "R@100", "P@10", "AP"],
        "qa_metrics": ["em", "f1", "containment", "semantic", "llm_judge"],
        "default_k_shots": [0, 1, 2, 3, 4, 5, 6, 10],
    },
    "training": {
        "train_ratio": 0.8,
        "gbdt": {"num_leaves": 31, "learning_rate": 0.05, "feature_fraction": 0.8,
                 "bagging_fraction": 0.8, "bagging_freq": 5, "num_boost_round": 200,
                 "early_stopping_rounds": 20, "max_bin": 255, "min_data_in_leaf": 20,
                 "lambda_l2": 0.0},
        "mlp": {"hidden_sizes": [128, 64], "dropout": 0.2, "learning_rate": 0.001,
                "epochs": 100, "batch_size": 64, "patience": 15, "qpp_indices": [5],
                "rsd_hidden_sizes": [32, 16]},
    },
    "generation": {
        "temperature": 0.1,
        "max_tokens": 256,
        "prompts": {
            "qa": {"system": _QA_SYSTEM, "user_template": _QA_USER},
            "fact_verification": {"system": _FV_SYSTEM, "user_template": _FV_USER,
                                  "labels": list(_LABELS)},
        },
    },
    "tpu": {
        "mesh": {"axes": ["data", "corpus"], "shape": [1, -1]},
        "dense": {"corpus_dtype": "bfloat16", "chunk_docs": 131072, "use_pallas": False},
        "sparse": {"doc_tile": 8192, "max_query_terms": 64, "bm25_k1": 0.9, "bm25_b": 0.4,
                   "engine": "exact", "presorted": False},
        "fusion": {"max_candidates": 512},
    },
}


def _expand(value: str, env: Dict[str, str]) -> str:
    """Expand ${VAR} / ${VAR:default} placeholders, innermost first.
    Capped at 10 rewrite passes: a self-referential variable
    (LOOP='x${LOOP}') raises instead of hanging the import."""
    prev = None
    for _ in range(10):
        if prev == value:
            break
        prev = value

        def repl(m: "re.Match[str]") -> str:
            var, default = m.group(1), m.group(2)
            if var in env:
                return env[var]
            if default is not None:
                return default
            return m.group(0)  # leave unresolved placeholders intact

        value = _PLACEHOLDER.sub(repl, value)
    else:
        if _PLACEHOLDER.search(value):
            raise ValueError(
                f"environment placeholder expansion did not converge for {value!r}")
    return value


def _expand_tree(node: Any, env: Dict[str, str]) -> Any:
    if isinstance(node, str):
        return _expand(node, env)
    if isinstance(node, dict):
        return {k: _expand_tree(v, env) for k, v in node.items()}
    if isinstance(node, list):
        return [_expand_tree(v, env) for v in node]
    return node


class ConfigDict:
    """Read-only dict wrapper with attribute access and dict-style access."""

    __slots__ = ("_data",)

    def __init__(self, data: Dict[str, Any]):
        object.__setattr__(self, "_data", data)

    def __getattr__(self, name: str) -> Any:
        try:
            return self._wrap(self._data[name])
        except KeyError as e:
            raise AttributeError(
                f"config has no key {name!r}; available: {sorted(self._data)}") from e

    def __getitem__(self, name: str) -> Any:
        return self._wrap(self._data[name])

    def __contains__(self, name: str) -> bool:
        return name in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def get(self, name: str, default: Any = None) -> Any:
        return self._wrap(self._data.get(name, default))

    def keys(self):
        return self._data.keys()

    def items(self):
        return ((k, self._wrap(v)) for k, v in self._data.items())

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._data)

    @staticmethod
    def _wrap(v: Any) -> Any:
        return ConfigDict(v) if isinstance(v, dict) else v

    def __setattr__(self, name: str, value: Any) -> None:
        raise AttributeError("config is read-only; use Config.load(overrides=...) in tests")

    def __repr__(self) -> str:
        return f"ConfigDict({sorted(self._data)})"


def _read_yaml(path: Path) -> Dict[str, Any]:
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            f"reading the config file {path} needs pyyaml, which is not installed; "
            "call Config.load() with no path for the built-in defaults") from e
    with open(path) as f:
        return yaml.safe_load(f) or {}


class Config(ConfigDict):
    """Root config object. Loaded once at import; reloadable via Config.load()."""

    def __init__(self, data: Dict[str, Any], path: Optional[Path] = None):
        super().__init__(data)
        object.__setattr__(self, "_path", path)

    @classmethod
    def load(
        cls,
        path: Optional[os.PathLike] = None,
        overrides: Optional[Dict[str, Any]] = None,
    ) -> "Config":
        """The built-in DEFAULTS, or the YAML file at `path` (else at
        $QPP_CONFIG), expanded against the environment (PROJECT_ROOT always
        defined), then `overrides` deep-merged."""
        path = path or os.environ.get("QPP_CONFIG")
        if path is None:
            raw = copy.deepcopy(DEFAULTS)
        else:
            path = Path(path)
            raw = _read_yaml(path)
        env = dict(os.environ)
        env.setdefault("PROJECT_ROOT", str(PROJECT_ROOT))
        data = _expand_tree(raw, env)
        if overrides:
            data = _deep_merge(data, overrides)
        return cls(data, path=path)

    # Reference-style weighted-fusion names -> the kernel's column names
    # (ops/qpp.py METHOD_NAMES == qpp.methods order). The reference's
    # method_index table indexes ITS OWN .qpp column layout; only RSD shares
    # its index with the kernel's.
    _QPP_NAME_ALIASES = {
        "sigma_max": "sigmamax",
        "sigma(%)": "sigmax",
        "scnqc": "snqc",
    }

    def get_qpp_index(self, model_name: str, layout: str = "kernel") -> int:
        """A weighted-fusion QPP model name (e.g. 'RSD') -> its column;
        'fusion' means average-all (-1). layout="kernel": the kernel's
        column order (qpp.methods); layout="reference": the reference's
        method_index table, for .qpp files the reference wrote."""
        key = model_name.lower()
        if key == "fusion":
            return -1
        if layout == "reference":
            table = self.qpp.method_index.to_dict()
            if model_name in table:
                return int(table[model_name])
            lowered = {str(k).lower(): v for k, v in table.items()}
            if key in lowered:
                return int(lowered[key])
            raise KeyError(
                f"Unknown reference QPP model {model_name!r}; known: {sorted(table)}")
        key = self._QPP_NAME_ALIASES.get(key, key)
        methods = [str(m).lower() for m in self.qpp.methods]
        if key in methods:
            return methods.index(key)
        raise KeyError(f"Unknown QPP model {model_name!r}; known: {sorted(set(methods))}")

    def dataset(self, name: str) -> ConfigDict:
        if name not in self.datasets.supported:
            raise KeyError(f"Unsupported dataset {name!r}; supported: {self.datasets.supported}")
        return self.datasets[name]


def _deep_merge(base: Dict[str, Any], extra: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in extra.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def detect_dataset(path: os.PathLike, supported: Optional[List[str]] = None) -> Optional[str]:
    """Infer a dataset name from a path: a path part equal to the name (or
    beir-<name>), else the longest name found between non-alphanumerics."""
    supported = supported or list(config.datasets.supported)
    parts = [p.lower() for p in Path(path).parts]
    for name in supported:
        if any(name == p or f"beir-{name}" == p for p in parts):
            return name
    s = str(path).lower()
    hits = [
        name for name in supported
        if re.search(rf"(?<![a-z0-9]){re.escape(name)}(?![a-z0-9])", s)
    ]
    return max(hits, key=len) if hits else None


config = Config.load()
