"""Protein k-mer similarity and clustering on the GPU, in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
``Isabella136/uniprot_kmer_based_clustering`` (a Rust CLI that builds a
258M-edge protein similarity multigraph on CPU; see ``SURVEY.md``).

Instead of materializing one edge per (k-mer, protein-pair) occurrence
(reference ``src/graph/mod.rs:39-193``), this framework packs each protein's
repeated-k-mer set into a bitset row of a ``[N, W]`` uint32 matrix and
computes pairwise shared-k-mer counts as int8 matmuls (or a tiled
AND+popcount sweep) on the device — mathematically identical to the reference's
``Graph::new → remove_uninteresting_edges → combine_edges`` chain, because
``|kmers(A) ∩ kmers(B)|`` is the only quantity consumed downstream.

Layout:
  io/         host FASTA ingest → protein tables (reference src/main.rs:62-74)
  kmers/      base-21 k-mer encoding, doc-freq index, rank hashing, bitsets
              (reference src/protein.rs:9-54, src/main.rs:77-199)
  ops/        sweep engines: int8 matmul, AND+popcount, out-of-core stream
  similarity/ single-device pairwise sweep + stats + pair extraction
              (reference src/graph/)
  parallel/   mesh construction, sharded ring sweep over devices
  models/     clustering models: union-find components + hierarchical tree
              (reference src/tree.rs)
  align/      diamond orchestration and on-device Smith-Waterman
              (src/graph/mod.rs:195-319)
  utils/      BLOSUM62 data, timers, checkpointing
"""

__version__ = "0.1.0"

from uniprot_kmer_based_clustering_tpu.config import PipelineConfig  # noqa: F401


def cluster_fasta(fasta_path: str, **config_kwargs):
    """One-call library entry point: FASTA → similarity pairs + clusters.

    ``config_kwargs`` are :class:`PipelineConfig` fields (k, threshold,
    weighting, cluster, sampling, …). Returns the full
    :class:`~uniprot_kmer_based_clustering_tpu.pipeline.PipelineResult`
    (parity counters, pair list, cluster labels, stage timings).

    >>> result = cluster_fasta("proteins.fasta", k=5, threshold=10)
    >>> result.pairwise.pairs        # (i, j, shared_kmers), sorted
    >>> result.cluster_labels        # per-protein cluster label
    """
    from uniprot_kmer_based_clustering_tpu.pipeline import run_pipeline

    return run_pipeline(fasta_path, PipelineConfig(**config_kwargs))
