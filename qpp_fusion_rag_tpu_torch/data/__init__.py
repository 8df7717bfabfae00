"""Data plumbing of the port (host side, numpy): BEIR loaders, TREC and
.qpp interop, RunTensor, DocVocab; the same names as
qpp_fusion_rag_tpu.data."""

from qpp_fusion_rag_tpu_torch.data.loaders import (  # noqa: F401
    LazyCorpus,
    doc_text,
    get_gold_answer_for_query,
    iter_corpus,
    load_corpus,
    load_gold_answers,
    load_qpp_file,
    load_qpp_scores,
    load_qrels,
    load_queries,
    load_run_as_dict,
    load_run_file,
    load_run_pairs,
    qid_sort_key,
    write_qpp_file,
    write_run_file,
)
from qpp_fusion_rag_tpu_torch.data.runtensor import RunTensor, load_runs_dir  # noqa: F401
from qpp_fusion_rag_tpu_torch.data.vocab import PAD_ID, DocVocab  # noqa: F401
