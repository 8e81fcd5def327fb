from uniprot_kmer_based_clustering_tpu.ops.popcount import (  # noqa: F401
    ROW_STAT_NAMES,
    pairwise_counts_xla,
    sweep_xla,
    upper_triangle_tiles,
)
