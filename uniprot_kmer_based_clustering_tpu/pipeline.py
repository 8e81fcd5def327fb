"""End-to-end pipeline: FASTA → k-mer index → bitsets → sweep → clusters.

Mirrors the reference ``main()`` stage order (src/main.rs:50-239):
ingest → doc-freq → unique/repeat split + hashing → graph/sweep →
AMR filter → merge → alignment gate — with the graph stages fused into a
single device sweep (see ops/) and real config, timing, checkpointing.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from uniprot_kmer_based_clustering_tpu.config import PipelineConfig
from uniprot_kmer_based_clustering_tpu.io.fasta import ProteinTable, read_fasta
from uniprot_kmer_based_clustering_tpu.kmers.bitset import (
    BitsetMatrix,
    pack_bitsets,
)
from uniprot_kmer_based_clustering_tpu.kmers.encode import encode_kmers
from uniprot_kmer_based_clustering_tpu.kmers.index import KmerIndex, build_index
from uniprot_kmer_based_clustering_tpu.models.components import (
    connected_components,
)
from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
    PairwiseResult,
    pairwise_similarity,
    run_engine,
)
from uniprot_kmer_based_clustering_tpu.utils.checkpoint import CheckpointStore
from uniprot_kmer_based_clustering_tpu.utils.timing import StageTimers


@dataclasses.dataclass
class PipelineResult:
    table: ProteinTable
    index: KmerIndex
    bitset: BitsetMatrix
    pairwise: Optional[PairwiseResult]  # None when stop_after="pack"
    cluster_labels: Optional[np.ndarray]
    timings: Dict[str, float]
    # agglomerative mode: ordered (winner, loser, shared_count) merge
    # list — the dendrogram (the hierarchy the reference's tree encodes)
    dendrogram: Optional[np.ndarray] = None
    # the sweep engine the run resolved to ("mxu", "xla", "native",
    # "stream", "mesh-mxu", "mesh-stream"; "" when no sweep ran)
    engine: str = ""

    def parity_report(self) -> Dict[str, int]:
        """The counters the reference prints to stderr, plus the pair gate —
        the golden numbers of BASELINE.md. With stop_after="pack" (no
        sweep ran) only the index-stage counters are present."""
        report = {
            "proteins": self.table.n,
            "distinct_kmers": self.index.n_distinct,
            "unique_kmers": self.index.n_unique,
            "repeated_kmers": self.index.n_repeated,
            "incidences": self.index.nnz,
            "multigraph_edges": self.index.multigraph_edge_count(),
        }
        if self.pairwise is not None:
            report.update(self.pairwise.parity_counters())
        return report

    def cluster_summary(self) -> Dict[str, int]:
        if self.cluster_labels is None:
            return {}
        uniq, counts = np.unique(self.cluster_labels, return_counts=True)
        return {
            "clusters": int(uniq.shape[0]),
            "largest_cluster": int(counts.max()),
            "singletons": int((counts == 1).sum()),
        }


def _row_multiple(config: PipelineConfig, n: int) -> int:
    # N_pad must satisfy both the mxu strip and the tile granularity.
    # With auto strip selection, pad to the optimal ~3584-row strip
    # (= 7×512) so auto_strip never degrades to narrow strips on an
    # N_pad with no good divisors (ops.bitmul.auto_strip) — but only once
    # the dataset exceeds one strip; small inputs stay tile-padded
    # (auto_strip uses one square call below 3584 rows anyway).
    import math

    strip = 3584 if config.strip is None else config.strip
    if config.strip is None and n <= 3584:
        return config.tile
    return (strip * config.tile) // math.gcd(strip, config.tile)


def run_pipeline(
    fasta_path: str,
    config: Optional[PipelineConfig] = None,
    checkpoint_dir: Optional[str] = None,
    mesh=None,
    echo_timings: bool = False,
    stop_after: Optional[str] = None,
) -> PipelineResult:
    """Run the full pipeline on the current default device (or a mesh).

    With `checkpoint_dir`, each stage's arrays persist and a rerun resumes
    from the last completed stage (config-keyed, so changing k or sampling
    invalidates downstream artifacts automatically).

    `stop_after="pack"` returns once the index + bitset exist, skipping
    the O(N²) sweep and clustering — the serving path (cli query) needs
    only the standing corpus artifacts; `pairwise`/`cluster_labels` are
    None in the result.
    """
    if stop_after not in (None, "pack"):
        raise ValueError(f"unknown stop_after {stop_after!r}")
    config = config or PipelineConfig()
    store = CheckpointStore(checkpoint_dir)
    timers = StageTimers(echo=echo_timings)

    with timers.stage("ingest"):
        table = read_fasta(fasta_path)

    if config.index_engine == "device":
        with timers.stage("index"):
            index, bitset = _device_index(table, config)
    else:
        index = None
        key_index = config.cache_key("index", _fasta_fingerprint(fasta_path))
        cached = store.load(key_index)
        if cached is not None:
            index = KmerIndex(
                k=config.k, sampling=config.sampling, **cached
            )
        if index is None:
            with timers.stage("encode"):
                codes, koff = encode_kmers(
                    table.seq_buf,
                    table.offsets,
                    config.k,
                    sampling=config.sampling,
                    seed=config.seed,
                )
            with timers.stage("index"):
                index = build_index(codes, koff, config.k)
                # stamp the encode stream's sampling mode (the cache key
                # carries it too — a cached load re-stamps identically)
                index.sampling = config.sampling
            extra = (
                {"unique_owner": index.unique_owner}
                if index.unique_owner is not None
                else {}
            )
            store.save(
                key_index,
                codes=index.codes,
                doc_freq=index.doc_freq,
                repeated_codes=index.repeated_codes,
                incidence_protein=index.incidence_protein,
                incidence_rank=index.incidence_rank,
                hash_doc_freq=index.hash_doc_freq,
                **extra,
            )

        with timers.stage("pack"):
            # PACKLESS runs (stream engine, CSR block source): the
            # dense matrix is never materialized anywhere — blocks
            # rebuild on device from the incidence lists. Only the
            # geometry is carried; any dense-path touch of .words
            # raises loudly. Tree/agglomerative clustering needs the
            # dense rows, so those configs keep the real pack.
            if (
                config.engine == "stream"
                and config.stream_source == "csr"
                and config.cluster in ("none", "components")
            ):
                from uniprot_kmer_based_clustering_tpu.kmers import (
                    VirtualBitsetMatrix,
                )

                bitset = VirtualBitsetMatrix.make(
                    table.n, index.n_repeated,
                    row_multiple=_row_multiple(config, table.n),
                )
            else:
                bitset = pack_bitsets(
                    index.incidence_protein,
                    index.incidence_rank,
                    table.n,
                    index.n_repeated,
                    row_multiple=_row_multiple(config, table.n),
                )

    if stop_after == "pack":
        return PipelineResult(
            table=table,
            index=index,
            bitset=bitset,
            pairwise=None,
            cluster_labels=None,
            timings=timers.as_dict(),
        )

    # weights feed only the sweep — computed after the stop_after="pack"
    # early return so the serving warm-start path never pays for them
    weights = None
    if config.weighting == "blosum62":
        from uniprot_kmer_based_clustering_tpu.utils.blosum import (
            rank_weights_int8,
        )

        weights = rank_weights_int8(
            index.repeated_codes, config.k, bitset.w_pad * 32
        )

    if mesh is not None:
        engine = "mesh-stream" if config.engine == "stream" else "mesh-mxu"
    else:
        engine = run_engine(config, weights is not None, index)
    key_pairs = config.cache_key("pairs", _fasta_fingerprint(fasta_path))
    cached_pairs = store.load(key_pairs)
    if cached_pairs is not None:
        # resume: the O(N²) sweep is the expensive stage — rebuild the
        # result from the saved artifact (device-topology-independent,
        # so a single-chip checkpoint resumes on any mesh and back)
        s = cached_pairs["stats"]
        pairwise = PairwiseResult(
            *(int(v) for v in s), pairs=cached_pairs["pairs"],
            cross_amr_only=config.cross_amr_only,
        )
    else:
        with timers.stage("sweep"):
            if mesh is not None:
                pairwise = _sharded_similarity(
                    bitset, table, config, mesh, weights=weights,
                    index=index,
                )
            else:
                pairwise = pairwise_similarity(
                    bitset, table.amr_class_ids, config,
                    weights=weights, index=index,
                    # stream runs checkpoint their sweep PROGRESS at
                    # stationary-group boundaries under a sub-key of
                    # the pairs artifact (a preempted out-of-core pass
                    # resumes mid-sweep; the finished artifact above
                    # still owns stage-level resume)
                    checkpoint_store=store,
                    checkpoint_key=(
                        key_pairs + "-stream-progress"
                        if config.engine == "stream" else None
                    ),
                )
        store.save(
            key_pairs,
            pairs=pairwise.pairs,
            stats=np.array(
                [
                    pairwise.cross_weight,
                    pairwise.cross_pairs,
                    pairwise.cross_over,
                    pairwise.cross_max,
                    pairwise.same_weight,
                    pairwise.same_pairs,
                    pairwise.same_over,
                    pairwise.same_max,
                ],
                dtype=np.int64,
            ),
        )

    labels = None
    dendrogram = None
    if config.cluster == "components":
        with timers.stage("cluster"):
            if mesh is not None:
                # collective partial-forest merge (pmin label propagation
                # over mesh-sharded edges); bit-identical to the host
                # union-find for any device count
                from uniprot_kmer_based_clustering_tpu.models.components import (
                    connected_components_sharded,
                )

                labels = connected_components_sharded(
                    mesh, pairwise.pairs, table.n
                )
            else:
                labels = connected_components(table.n, pairwise.pairs)
    elif config.cluster == "agglomerative":
        with timers.stage("cluster"):
            from uniprot_kmer_based_clustering_tpu.models.agglomerative import (
                agglomerative_cluster,
            )

            # host-looped rounds (the one-jit lax.while_loop variant,
            # agglomerative_cluster_device, compiles one large program;
            # neither has been timed on the GPU)
            agg = agglomerative_cluster(
                bitset, table.n, min_shared=config.min_shared
            )
            labels = agg.labels
            dendrogram = agg.merges
    elif config.cluster == "tree":
        with timers.stage("cluster"):
            from uniprot_kmer_based_clustering_tpu.models.tree import (
                cluster_tree_labels,
            )

            labels = cluster_tree_labels(bitset, table.n)

    return PipelineResult(
        table=table,
        index=index,
        bitset=bitset,
        pairwise=pairwise,
        cluster_labels=labels,
        timings=timers.as_dict(),
        dendrogram=dendrogram,
        engine=engine,
    )


def _fasta_fingerprint(fasta_path: str) -> str:
    """Checkpoint-key component identifying the input FILE CONTENTS, not
    just its path — an in-place edit of the FASTA must invalidate the
    index/pairs artifacts instead of silently resuming stale results.
    size+mtime_ns is the rsync-style heuristic (content hashing a
    multi-GB corpus on every resume would defeat the point)."""
    import os

    st = os.stat(fasta_path)
    return f"{fasta_path}:{st.st_size}:{st.st_mtime_ns}"


def _device_index(table: ProteinTable, config: PipelineConfig):
    """Index + bitset built entirely on device (kmers/index_device.py).

    k=5 uses the dense 21⁵ bincount; k=7 the global-sort build (the 21⁷
    universe has no dense form). Bit-identical to the host path;
    random10 sampling stays host-side (the reference's sampler is
    positional, src/protein.rs:83-94).
    """
    if config.sampling != "all":
        raise ValueError("index_engine='device' supports sampling='all'")
    import numpy as _np

    from uniprot_kmer_based_clustering_tpu.kmers.encode import (
        residues_to_indices,
    )
    from uniprot_kmer_based_clustering_tpu.kmers.index_device import (
        build_bitset_device,
        build_bitset_device_sorted,
    )

    lengths = table.lengths.astype(_np.int32)
    # empty FASTA (n=0): lengths.max() raises on a zero-size array — the
    # host path supports this input, so the device engine must too
    lmax = int(lengths.max()) if table.n else 1
    # one offsets-based scatter builds the padded [N, Lmax] residue
    # matrix — a per-protein Python loop is O(N) interpreter overhead
    # that dominates staging at 100k+ proteins
    mat = _np.zeros((table.n, lmax), _np.int32)
    res = residues_to_indices(table.seq_buf)
    starts = _np.asarray(table.offsets[:-1], _np.int64)
    rows = _np.repeat(_np.arange(table.n, dtype=_np.int64), lengths)
    cols = _np.arange(res.shape[0], dtype=_np.int64) - _np.repeat(
        starts, lengths
    )
    mat[rows, cols] = res
    if config.k == 5:
        words, freq, n_repeated = build_bitset_device(
            mat, lengths, table.n,
            row_multiple=_row_multiple(config, table.n),
        )
        index = KmerIndex.from_dense_freq(_np.asarray(freq), config.k)
    else:
        words, codes, counts, n_repeated = build_bitset_device_sorted(
            mat, lengths, table.n, config.k,
            row_multiple=_row_multiple(config, table.n),
        )
        index = KmerIndex.from_sparse_freq(codes, counts, config.k)
    assert index.n_repeated == n_repeated
    bitset = BitsetMatrix(
        words=_np.asarray(words), n=table.n, n_bits=n_repeated
    )
    return index, bitset


def _sharded_similarity(
    bitset, table, config, mesh, weights=None, index=None
) -> PairwiseResult:
    """Mesh-parallel sweep + mesh-parallel extraction."""
    import functools

    from uniprot_kmer_based_clustering_tpu.parallel.mesh import pad_for_mesh
    from uniprot_kmer_based_clustering_tpu.parallel.sharded import (
        sharded_pairwise_similarity,
        sharded_pairwise_similarity_2d,
        sharded_pairwise_similarity_kaxis,
    )

    if config.engine == "stream":
        # engine='stream' on a mesh means OUT-OF-CORE: corpora beyond
        # per-device (and beyond aggregate) device memory. Only the CSR source
        # composes — the dense matrix never exists anywhere.
        if config.stream_source != "csr":
            raise ValueError(
                "engine='stream' on a mesh requires stream_source='csr' "
                "(per-device host-words streaming would re-upload the "
                "dense matrix D times; the CSR staging replicates in "
                "one ~0.02%-volume upload)"
            )
        if index is None or not getattr(index, "has_incidences", False):
            raise ValueError(
                "stream_source='csr' needs the host-built index "
                "incidence lists"
            )
        if len(mesh.axis_names) == 1 and mesh.axis_names != ("k",):
            # flat row mesh: the sharded stream composition — each
            # device runs the stationary-group/moving-block schedule
            # over its own block-pair partition from the REPLICATED
            # sparse staging (parallel/stream_mesh.py)
            from uniprot_kmer_based_clustering_tpu.ops.stream import (
                CSRBlockSource,
            )
            from uniprot_kmer_based_clustering_tpu.parallel.stream_mesh import (
                sweep_extract_stream_mesh,
            )

            threshold = (
                config.effective_weighted_threshold(weights)
                if weights is not None
                else config.threshold
            )
            src = CSRBlockSource(
                index.incidence_protein, index.incidence_rank,
                bitset.n_pad, bitset.w_pad,
            )
            row_stats, _th, _tl, pairs = sweep_extract_stream_mesh(
                mesh, np.asarray(table.amr_class_ids, np.int32),
                bitset.n, threshold, block_source=src, bs=config.strip,
                block=config.tile, weights=weights,
                cross_amr_only=config.cross_amr_only,
                cap=config.extract_k or None,
            )
            return PairwiseResult.from_row_stats(
                row_stats, pairs, cross_amr_only=config.cross_amr_only
            )
        # 2-D ring / k-axis layouts: no out-of-core schedule exists for
        # them — fall through to the packless in-core mesh staging (the
        # dense shards still materialize on device from the CSR lists;
        # per-device shards must fit device memory)

    if len(mesh.axis_names) == 2:
        # hierarchical (hosts × chips) ring: one cross-host hop per
        # outer step, inner rotations within the host
        h_ax, c_ax = mesh.axis_names
        sweep = functools.partial(
            sharded_pairwise_similarity_2d, host_axis=h_ax, chip_axis=c_ax
        )
    elif mesh.axis_names == ("k",):
        # contraction-axis sharding: bitset columns (k-mer universe)
        # divided over devices, counts merged by psum — the memory-scaling
        # axis for the 7-mer universe
        sweep = sharded_pairwise_similarity_kaxis
    else:
        sweep = sharded_pairwise_similarity

    d = mesh.devices.size
    block_tile = 128
    n_pad = pad_for_mesh(bitset.n_pad, d, block_tile)
    classes = np.full(n_pad, -1, dtype=np.int32)
    classes[: bitset.n] = np.asarray(table.amr_class_ids, np.int32)

    if config.stream_source == "csr":
        # packless mesh staging: shards materialize ON DEVICE from the
        # incidence lists (no dense host matrix, no dense upload) —
        # dense row shards on the flat/2-D row layouts, column-range
        # shards on the k-axis layout
        if index is None or not getattr(index, "has_incidences", False):
            raise ValueError(
                "stream_source='csr' needs the host-built index "
                "incidence lists"
            )
        from uniprot_kmer_based_clustering_tpu.parallel.sharded import (
            stage_mesh_inputs_csr,
        )

        words, classes = stage_mesh_inputs_csr(
            mesh, index.incidence_protein, index.incidence_rank,
            n_pad, bitset.w_pad, classes, axis=tuple(mesh.axis_names),
        )
    else:
        words = bitset.words
        if n_pad != bitset.n_pad:
            words = np.zeros((n_pad, bitset.w_pad), dtype=np.uint32)
            words[: bitset.n_pad] = bitset.words

        # stage the packed matrix onto the mesh ONCE: the sweep and the
        # extraction pass use the same sharding (9 GB at 100k proteins)
        from uniprot_kmer_based_clustering_tpu.parallel.sharded import (
            stage_mesh_inputs,
        )

        words, classes = stage_mesh_inputs(mesh, words, classes)

    threshold = (
        config.effective_weighted_threshold(weights)
        if weights is not None
        else config.threshold
    )
    if config.extract == "fused":
        # fused sweep: ONE pass computes the stats and compacts the
        # survivors, halving the sweep+extract matmul/collective cost on
        # every layout (flat ring, 2-D ring, k-axis); the wrapper falls
        # back to the two-pass machinery (exactly sized from the pass's
        # own tile hits) when its capacity guesses miss.
        from uniprot_kmer_based_clustering_tpu.parallel.sharded import (
            sharded_pairwise_fused,
        )

        row_stats, tile_hits, tiles, pairs = sharded_pairwise_fused(
            mesh, words, classes, bitset.n, threshold,
            block_tile=block_tile, weights=weights,
            cross_amr_only=config.cross_amr_only,
            k=config.extract_k or None,
        )
        return PairwiseResult.from_row_stats(
        row_stats, pairs, cross_amr_only=config.cross_amr_only
    )
    row_stats, tile_hits, tiles = sweep(
        mesh, words, classes, bitset.n, threshold, block_tile,
        weights=weights,
    )
    # mesh-parallel extraction on every layout (flat ring, 2-D ring, or
    # the k-axis replicated compaction): no device ever holds the full
    # bitset — the single-chip extractor replicates it, which cannot
    # work once the sharded matrix outgrows one device. The sweep's
    # tile_hits give the exact survivor total, so the cap is safe.
    from uniprot_kmer_based_clustering_tpu.parallel.sharded import (
        sharded_extract_pairs,
    )

    per_tile = tile_hits[:, 0].astype(np.int64)
    if not config.cross_amr_only:
        per_tile = per_tile + tile_hits[:, 1]
    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        topk_tile_cap,
    )

    pairs = sharded_extract_pairs(
        mesh, words, classes, bitset.n, threshold,
        block_tile=block_tile, weights=weights,
        cross_amr_only=config.cross_amr_only,
        cap=max(1 << 18, int(per_tile.sum())),
        expected_total=int(per_tile.sum()),
        tile_cap=topk_tile_cap(per_tile),
    )
    return PairwiseResult.from_row_stats(
        row_stats, pairs, cross_amr_only=config.cross_amr_only
    )
