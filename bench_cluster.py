"""Clustering-at-scale benchmark: the clustering models past the bundled
10,619 proteins.

Three stages, each timed on one GPU and gated (a run that finds no GPU
fails):

1. **Connected components at 100k** (the production cluster mode): the
   in-core 100k/k=5 design point's sweep + extraction produces the
   ~18.6M-pair graph, then BOTH component paths run on it — the host
   union-find (``models/components.connected_components``) and the
   mesh/device min-label propagation (``connected_components_sharded``
   on a 1-device mesh here). Gate: label equality between the two
   (bit-identical by design), plus the pair list's sampled CPU oracle.

2. **Agglomerative at 30k** (the batched mutual-argmax model): the 30k
   synthetic corpus through ``agglomerative_cluster`` — the strip-
   chunked round argmax engages (the one-shot matmul's int8 unpack is
   ~29 GB at this geometry; tests pin strip ≡ one-shot). Gates: the
   bundled dataset re-run FIRST (when the checkout has it) with the same
   code against the golden constants (123 clusters / 10,496 dendrogram
   rows / 62 rounds), then structural invariants at 30k (losers
   unique, winner<loser, labels ≡ union-find of the merge list,
   min-member canonical labels).

3. **Tree at 30k** (the reference src/tree.rs semantics, models/tree):
   sequential insertion with the pooled native AVX-512 similarity
   cache. Gates: bundled-dataset label equality against the committed
   structure is covered by tests; here the 30k run is gated
   structurally (valid min-member labels) and timed — the honest
   record of what the reference's own sequential semantics cost at 3×
   its dataset.

Env knobs: UKC_CLUSTER_COMPONENTS_N (default 100000, 0 skips),
UKC_CLUSTER_N (default 30000), UKC_CLUSTER_AGG=0 / UKC_CLUSTER_TREE=0
to skip stages, UKC_CLUSTER_AGG_N to size the agglomerative stage
separately.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from bench_scale import oracle_gate, synth_proteins


def _synth_index(n: int, kk: int = 5):
    from uniprot_kmer_based_clustering_tpu.kmers import (
        build_index,
        encode_kmers,
    )

    seq_buf, offsets, classes = synth_proteins(n)
    codes, koff = encode_kmers(seq_buf, offsets, kk)
    return build_index(codes, koff, kk), classes


def _components_stage(n: int) -> dict:
    """100k sweep → pair graph → both component paths, timed + gated."""
    import jax

    from uniprot_kmer_based_clustering_tpu.kmers import pack_bitsets_device
    from uniprot_kmer_based_clustering_tpu.models.components import (
        connected_components,
        connected_components_sharded,
    )
    from uniprot_kmer_based_clustering_tpu.ops.bitmul import sweep_mxu
    from uniprot_kmer_based_clustering_tpu.parallel import make_mesh
    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        extract_pairs,
    )

    t0 = time.perf_counter()
    idx, classes = _synth_index(n)
    t_index = time.perf_counter() - t0
    t0 = time.perf_counter()
    bitset = pack_bitsets_device(
        idx.incidence_protein, idx.incidence_rank, n, idx.n_repeated,
        row_multiple=7 * 512,
    )
    cls = np.full(bitset.n_pad, -1, np.int32)
    cls[:n] = classes
    rs, th, tl = sweep_mxu(bitset.words, cls, n, 10)
    pairs = extract_pairs(bitset.words, cls, th, tl, n=n, threshold=10)
    t_pairs = time.perf_counter() - t0
    n_checked = oracle_gate(idx, classes, pairs, n, 10)

    # free the 9 GB matrix before the label propagation claims memory
    del bitset
    import gc

    gc.collect()

    t0 = time.perf_counter()
    labels_host = connected_components(n, pairs)
    t_host = time.perf_counter() - t0

    mesh = make_mesh(1)
    # compile + warm, then best-of-2 (CLAUDE.md timing discipline)
    connected_components_sharded(mesh, pairs, n)
    t_dev = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        labels_dev = connected_components_sharded(mesh, pairs, n)
        t_dev = min(t_dev, time.perf_counter() - t0)
    assert np.array_equal(labels_dev, labels_host), (
        "sharded component labels != host union-find"
    )
    uniq, counts = np.unique(labels_host, return_counts=True)
    return {
        "components_n": n,
        "components_pairs": int(len(pairs)),
        "components_host_unionfind_seconds": round(t_host, 1),
        "components_device_pmin_seconds": round(t_dev, 2),
        "components_clusters": int(uniq.shape[0]),
        "components_largest": int(counts.max()),
        "components_singletons": int((counts == 1).sum()),
        "components_index_seconds": round(t_index, 1),
        "components_sweep_extract_seconds": round(t_pairs, 1),
        "components_oracle_checked": n_checked,
        "components_parity": (
            "device pmin labels == host union-find (exact); pair list "
            "CPU-oracle-gated"
        ),
    }


def _agg_golden_gate() -> dict:
    """The bundled dataset through agglomerative_cluster — the golden
    constants every engines-gate run pins (123 / 10,496 / 62)."""
    from uniprot_kmer_based_clustering_tpu.config import PipelineConfig
    from uniprot_kmer_based_clustering_tpu.models.agglomerative import (
        agglomerative_cluster,
    )
    from uniprot_kmer_based_clustering_tpu.pipeline import run_pipeline

    import bench

    res = run_pipeline(
        bench.BUNDLED, PipelineConfig(cluster="none"), stop_after="pack",
    )
    t0 = time.perf_counter()
    agg = agglomerative_cluster(res.bitset, res.table.n)
    dt = time.perf_counter() - t0
    n_cl = int(np.unique(agg.labels).shape[0])
    assert (n_cl, agg.merges.shape[0], agg.rounds) == (123, 10496, 62), (
        n_cl, agg.merges.shape[0], agg.rounds,
    )
    return {"agg_bundled_seconds": round(dt, 1),
            "agg_bundled_golden": "123 clusters / 10496 merges / 62 rounds"}


def _structural_gate(agg, n: int) -> None:
    """Invariants any correct merge sequence satisfies: losers leave
    exactly once, winners precede their losers, and the flat labels are
    exactly the union-find closure of the merge list with min-member
    canonical representatives."""
    m = agg.merges
    assert (m[:, 0] < m[:, 1]).all()
    losers = m[:, 1]
    assert np.unique(losers).shape[0] == losers.shape[0]
    parent = np.arange(n, dtype=np.int64)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for w, l, _c in m:
        parent[find(int(l))] = find(int(w))
    roots = {}
    for i in range(n):
        r = find(i)
        roots.setdefault(r, i)
    expect = np.array([roots[find(i)] for i in range(n)], np.int32)
    assert np.array_equal(agg.labels, expect)


def _agglomerative_stage(n: int) -> dict:
    from uniprot_kmer_based_clustering_tpu.kmers import pack_bitsets_device
    from uniprot_kmer_based_clustering_tpu.models.agglomerative import (
        _argmax_plan,
        agglomerative_cluster,
    )
    from uniprot_kmer_based_clustering_tpu.utils.accel import (
        device_memory_budget,
    )

    import bench

    golden = {}
    if (
        os.environ.get("UKC_CLUSTER_GOLDEN", "1") != "0"
        and os.path.exists(bench.BUNDLED)
    ):
        # the golden constants belong to the bundled dataset
        golden = _agg_golden_gate()
    idx, classes = _synth_index(n)
    bitset = pack_bitsets_device(
        idx.incidence_protein, idx.incidence_rank, n, idx.n_repeated,
        row_multiple=3584,
    )
    words = np.asarray(bitset.words)
    plan = _argmax_plan(
        words.shape[0], words.shape[1], device_memory_budget()
    )
    t0 = time.perf_counter()
    agg = agglomerative_cluster(bitset, n)
    dt = time.perf_counter() - t0
    _structural_gate(agg, n)
    uniq, counts = np.unique(agg.labels, return_counts=True)
    return {
        **golden,
        "agg_n": n,
        "agg_repeated_kmers": idx.n_repeated,
        "agg_seconds": round(dt, 1),
        "agg_rounds": agg.rounds,
        "agg_merges": int(agg.merges.shape[0]),
        "agg_clusters": int(uniq.shape[0]),
        "agg_largest": int(counts.max()),
        "agg_mode": (
            "one-shot matmul" if plan is None else
            f"strip argmax (strip={plan[0]}, word_chunk={plan[1]})"
        ),
        "agg_gates": (
            ("bundled golden exact (123/10496/62) + " if golden else "")
            + "structural (losers unique, labels == union-find "
            "closure of merges)"
        ),
    }


def _tree_stage(n: int) -> dict:
    from uniprot_kmer_based_clustering_tpu.kmers import pack_bitsets
    from uniprot_kmer_based_clustering_tpu.models.tree import build_tree

    idx, classes = _synth_index(n)
    # tree rows are host numpy (uint64 views) — pack on host
    bitset = pack_bitsets(
        idx.incidence_protein, idx.incidence_rank, n, idx.n_repeated,
        row_multiple=8,
    )
    t0 = time.perf_counter()
    tree = build_tree(bitset, n)
    dt = time.perf_counter() - t0
    labels = tree.labels(n)
    assert (labels >= 0).all()
    for lbl in np.unique(labels):
        assert np.nonzero(labels == lbl)[0].min() == lbl  # min-member
    uniq, counts = np.unique(labels, return_counts=True)
    return {
        "tree_n": n,
        "tree_seconds": round(dt, 1),
        "tree_clusters": int(uniq.shape[0]),
        "tree_largest": int(counts.max()),
        "tree_depth": tree.depth(),
        "tree_root_children": len(tree.root.children),
        "tree_gates": "min-member canonical labels; full coverage",
    }


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from uniprot_kmer_based_clustering_tpu.utils.accel import (
        card_line,
        enable_persistent_cache,
        require_accelerator,
    )

    require_accelerator()
    enable_persistent_cache()
    import jax

    rec = {
        "metric": "cluster_scale",
        "unit": "proteins/s",
        "device": str(jax.devices()[0]),
        "card": card_line(),
    }
    n_comp = int(os.environ.get("UKC_CLUSTER_COMPONENTS_N", "100000"))
    n_agg = int(
        os.environ.get(
            "UKC_CLUSTER_AGG_N", os.environ.get("UKC_CLUSTER_N", "30000")
        )
    )
    n_tree = int(os.environ.get("UKC_CLUSTER_N", "30000"))
    if n_comp:
        rec.update(_components_stage(n_comp))
    if os.environ.get("UKC_CLUSTER_AGG", "1") != "0":
        rec.update(_agglomerative_stage(n_agg))
    if os.environ.get("UKC_CLUSTER_TREE", "1") != "0":
        rec.update(_tree_stage(n_tree))
    # headline: proteins clustered per second by the production mode
    # (components at the biggest N) through the device path
    if "components_device_pmin_seconds" in rec:
        rec["value"] = round(
            rec["components_n"] / rec["components_device_pmin_seconds"], 1
        )
    else:
        rec["value"] = 0.0
    print(json.dumps(rec))
    from uniprot_kmer_based_clustering_tpu.utils.artifact import (
        write_bench_artifact,
    )

    write_bench_artifact("cluster", rec)


if __name__ == "__main__":
    main()
