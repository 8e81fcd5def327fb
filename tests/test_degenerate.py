"""Degenerate-input robustness: the reference crashes or hardcodes its way
through these (dataset size 10,619 is hardcoded at src/main.rs:96; a
sequence shorter than k produces zero k-mers and an empty edge space).
The pipeline must handle every shape of "nothing survives" without
special-casing by the caller: one protein, no repeated k-mers (W=0 bit
space), sequences shorter than k, and an all-one-class corpus (the
cross-AMR filter removes everything).
"""

import numpy as np
import pytest

from uniprot_kmer_based_clustering_tpu.config import PipelineConfig
from uniprot_kmer_based_clustering_tpu.pipeline import run_pipeline
from uniprot_kmer_based_clustering_tpu.similarity.query import QueryServer

CFG = dict(tile=16, strip=32, engine="xla", threshold=2)


def _write(path, recs):
    with open(path, "w") as f:
        for rid, seq in recs:
            f.write(f">{rid}\n{seq}\n")
    return str(path)


@pytest.fixture(scope="module")
def degen_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("degen")


def _run(path, **over):
    return run_pipeline(path, PipelineConfig(**{**CFG, **over}))


def test_single_protein(degen_dir):
    p = _write(degen_dir / "one.fasta",
               [("A|x|u|classA|g", "MKTLLVLLFAGCSTA")])
    r = _run(p)
    rep = r.parity_report()
    assert rep["proteins"] == 1
    assert rep["repeated_kmers"] == 0  # every 5-mer has docfreq 1
    assert rep["pairs_over_threshold"] == 0
    assert r.pairwise.pairs.shape[0] == 0


def test_no_repeated_kmers_w0_bitspace(degen_dir):
    # two proteins, zero shared 5-mers -> the packed bit matrix has zero
    # word columns; every engine stage must survive W=0
    p = _write(degen_dir / "none.fasta",
               [("A|x|u|classA|g", "MKTLLVLLF"),
                ("B|x|u|classB|g", "WWWWYYYYFF")])
    for cluster in ("components", "tree"):
        r = _run(p, cluster=cluster)
        assert r.parity_report()["repeated_kmers"] == 0
        assert r.pairwise.pairs.shape[0] == 0
        assert r.cluster_summary()["singletons"] == 2

    # query serving over the W=0 corpus: empty hit lists, no crash
    r = _run(p)
    for mode in ("host", "device"):
        q = QueryServer(r.index, r.bitset, mode=mode)
        (hits,) = q.query(["MKTLLVLLF"])
        assert hits.shape[0] == 0


def test_sequence_shorter_than_k(degen_dir):
    # a 3-residue protein yields zero 5-mers but must stay a first-class
    # corpus member (the reference's seq_len-4 loop would underflow)
    p = _write(degen_dir / "short.fasta",
               [("A|x|u|classA|g", "MKT"),
                ("B|x|u|classB|g", "MKTLLVLLF"),
                ("C|x|u|classC|g", "MKTLLVLLF")])
    r = _run(p)
    rep = r.parity_report()
    assert rep["proteins"] == 3
    # B and C share all 5 of their 5-mers; A contributes none
    assert rep["pairs_over_threshold"] == 1
    i, j = int(r.pairwise.pairs[0, 0]), int(r.pairwise.pairs[0, 1])
    assert {i, j} == {1, 2}
    assert int(r.pairwise.pairs[0, 2]) == 5


def test_all_same_class_filtered_empty(degen_dir):
    # identical sequences, identical AMR class: the cross-AMR filter
    # (src/graph/mod.rs:580-587 semantics) leaves nothing
    p = _write(degen_dir / "same.fasta",
               [("A|x|u|classA|g", "MKTLLVLLF"),
                ("B|x|u|classA|g", "MKTLLVLLF")])
    r = _run(p)
    rep = r.parity_report()
    assert rep["repeated_kmers"] == 5
    assert rep["edges_after_amr_filter"] == 0
    assert rep["pairs_after_merge"] == 0
    assert r.pairwise.pairs.shape[0] == 0
    # --all-pairs keeps them: the counters must track the surfaced pair
    # list (mode-aware parity_counters — same-class lanes count when the
    # AMR gate is off)
    r2 = _run(p, cross_amr_only=False)
    assert r2.pairwise.pairs.shape[0] == 1
    assert r2.pairwise.same_over == 1
    rep2 = r2.parity_report()
    assert rep2["pairs_over_threshold"] == 1
    assert rep2["pairs_after_merge"] == 1
    assert rep2["max_shared_kmers"] == int(r2.pairwise.pairs[0, 2])


def test_engines_agree_on_degenerate(degen_dir):
    p = _write(degen_dir / "short2.fasta",
               [("A|x|u|classA|g", "MKT"),
                ("B|x|u|classB|g", "MKTLLVLLF"),
                ("C|x|u|classC|g", "MKTLLVLLF")])
    runs = [_run(p, engine=e) for e in ("xla", "mxu", "stream")]
    for r in runs[1:]:
        assert r.parity_report() == runs[0].parity_report()
        assert np.array_equal(r.pairwise.pairs, runs[0].pairwise.pairs)
