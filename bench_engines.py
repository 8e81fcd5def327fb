"""All-engine gate on one GPU, in ONE recorded pass.

The repo invariant (CLAUDE.md) says every sweep engine — int8 matmul,
XLA AND+popcount, streaming, native C++ — and every extraction strategy
(two-pass, fused, one-pass) must agree EXACTLY: pair-list equality, not
just counters. This bench checks it on the card and records per-engine
timings. A run that finds no GPU fails.

Prints ONE JSON line:
  {"metric": "engine_parity", "value": <#engines golden-exact>,
   "unit": "engines", "vs_baseline": <value/total>,
   "engines": {name: {"cold_s": .., "warm_s": .., "parity": ..}}, ...}

and mirrors it to BENCH_engines_r{UKC_BENCH_ROUND}.json when the env var
is set (committed artifact — driver-verifiable evidence).

Reference semantics being gated: the pair set of the reference's
src/graph/mod.rs remove_uninteresting_edges → combine_edges → align gate
(465 pairs, max 567 on the bundled dataset). Corpus: ``UKC_BENCH_FASTA``,
else the bundled ``data/uniprot_arg.fasta`` when the checkout has it
(golden counters), else the 10,619-protein synthetic corpus of bench.py
(gated by cross-engine equality and the native sweep's counters).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

_ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = {
    "edges_after_amr_filter": 5_300_233,
    "pairs_after_merge": 4_350_628,
    "pairs_over_threshold": 465,
    "max_shared_kmers": 567,
}
# 7-mer config (BASELINE config #2; src/tree.rs:96-102 k∈{5,7}):
# constants derived from the scipy oracle (tests/test_pipeline.py
# test_golden_full_dataset_7mer) — Σ shared 7-mers over cross-AMR pairs,
# distinct cross pairs, pairs over the >10 gate, max shared.
GOLDEN_K7 = {
    "edges_after_amr_filter": 99_250,
    "pairs_after_merge": 22_732,
    "pairs_over_threshold": 463,
    "max_shared_kmers": 565,
}
# BLOSUM62-weighted config (BASELINE config #3; src/blosum.rs): weights
# are strictly positive so the pair support equals the unweighted run;
# the gate is threshold × mean rank weight
# (tests/test_blosum.py test_golden_weighted_full_dataset).
GOLDEN_WEIGHTED = {
    "edges_after_amr_filter": 124_363_524,
    "pairs_after_merge": 4_350_628,
    "pairs_over_threshold": 465,
    "max_shared_kmers": 14_781,
}

# (name, config overrides). Order matters: the first entry is the
# reference result the others must match bit-for-bit.
ENGINES = [
    ("mxu_two_pass", dict(engine="mxu", extract="two_pass")),
    ("mxu_fused", dict(engine="mxu", extract="fused")),
    ("xla", dict(engine="xla")),
    ("stream_two_pass", dict(engine="stream", extract="two_pass")),
    ("stream_fused", dict(engine="stream", extract="fused")),
    ("stream_onepass", dict(engine="stream", extract="onepass")),
    ("stream_onepass_csr", dict(
        engine="stream", extract="onepass", stream_source="csr",
    )),
    ("native_cpp", dict(engine="native")),
]


def _write_artifact(line: dict):
    from uniprot_kmer_based_clustering_tpu.utils.artifact import (
        write_bench_artifact,
    )

    write_bench_artifact(
        "engines", line, os.path.dirname(os.path.abspath(__file__))
    )


def main():
    sys.path.insert(0, _ROOT)
    import bench

    from uniprot_kmer_based_clustering_tpu.utils.accel import (
        card_line,
        enable_persistent_cache,
        require_accelerator,
    )

    require_accelerator()
    enable_persistent_cache()
    with tempfile.TemporaryDirectory(prefix="ukc_engines_") as tmp:
        _run(card_line(), bench.corpus_path(tmp))


def _run(card, fasta):
    import jax

    from uniprot_kmer_based_clustering_tpu.config import PipelineConfig
    from uniprot_kmer_based_clustering_tpu.io import native, read_fasta
    from uniprot_kmer_based_clustering_tpu.kmers import (
        build_index,
        encode_kmers,
        pack_bitsets,
    )
    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        pairwise_similarity,
    )

    table = read_fasta(fasta)
    codes, koff = encode_kmers(table.seq_buf, table.offsets, 5)
    idx = build_index(codes, koff, 5)
    bitset = pack_bitsets(
        idx.incidence_protein,
        idx.incidence_rank,
        table.n,
        idx.n_repeated,
        row_multiple=512,
    )
    classes = np.asarray(table.amr_class_ids, np.int32)

    # the absolute golden gate applies to the bundled dataset; any other
    # FASTA (subset smoke runs) gates on cross-engine equality only
    golden = (
        GOLDEN
        if os.path.realpath(fasta).endswith("uniprot_arg.fasta")
        else None
    )
    ref_pairs = None
    ref_counters = None
    engines = {}
    golden_count = 0
    skipped = 0  # gates not executed this run: excluded from the score
    # (a skip is neither a pass nor a failure — counting it either way
    # misstates the evidence)
    for name, over in ENGINES:
        if name == "native_cpp" and not native.available():
            engines[name] = {"parity": "skipped (native lib not built)"}
            skipped += 1
            continue
        config = PipelineConfig(**over)
        rec = {}
        try:
            t0 = time.perf_counter()
            res = pairwise_similarity(bitset, classes, config, index=idx)
            rec["cold_s"] = round(time.perf_counter() - t0, 3)
            # warm repeats, best-of-2. Streaming engines pay the full
            # host->device matrix transfer each pass (by design).
            warm = float("inf")
            for _ in range(2):
                t0 = time.perf_counter()
                res2 = pairwise_similarity(
                    bitset, classes, config, index=idx
                )
                warm = min(warm, time.perf_counter() - t0)
            rec["warm_s"] = round(warm, 3)
        except Exception as e:  # noqa: BLE001 — a broken engine must not
            # hide the other engines' evidence
            rec["parity"] = f"ERROR: {type(e).__name__}: {e}"
            engines[name] = rec
            continue
        if name.startswith("stream"):
            # phase breakdown of the LAST warm pass (where streaming
            # time goes)
            from uniprot_kmer_based_clustering_tpu.ops import (
                stream as _stream,
            )

            tr = {
                k: (round(v, 2) if isinstance(v, float) else v)
                for k, v in (
                    _stream.last_onepass_trace
                    if name == "stream_onepass"
                    else _stream.last_trace
                ).items()
            }
            rec["sweep_trace"] = tr
            moved_mb = tr["uploads"] * tr["bs"] * bitset.w_pad * 4 / 2**20
            if name == "stream_two_pass":
                rec["extract_trace"] = {
                    k: (round(v, 2) if isinstance(v, float) else v)
                    for k, v in _stream.last_extract_trace.items()
                }
            rec["moved_mb"] = round(moved_mb, 1)
        got = res.parity_counters()
        if ref_pairs is None:
            ref_pairs = res.pairs
            ref_counters = got
        ok = got == (golden if golden is not None else ref_counters)
        ok = ok and np.array_equal(res.pairs, res2.pairs)
        pairs_eq = np.array_equal(res.pairs, ref_pairs)
        rec["parity"] = (
            "golden-exact" if (ok and pairs_eq)
            else f"MISMATCH: counters={got} pairs_eq={pairs_eq}"
        )
        if ok and pairs_eq:
            golden_count += 1
        engines[name] = rec

    # the sharded out-of-core composition on a 1-device mesh (D>1 runs
    # in chip_smoke.py --four-cards): same gate, pair list must equal the
    # reference engine's
    try:
        from uniprot_kmer_based_clustering_tpu.ops.stream import (
            CSRBlockSource,
        )
        from uniprot_kmer_based_clustering_tpu.parallel import make_mesh
        from uniprot_kmer_based_clustering_tpu.parallel.stream_mesh import (
            sweep_extract_stream_mesh,
        )
        from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
            PairwiseResult,
        )

        mesh1 = make_mesh(1)

        def _run_mesh():
            src = CSRBlockSource(
                idx.incidence_protein, idx.incidence_rank,
                bitset.n_pad, bitset.w_pad,
            )
            rs, _th, _tl, pr = sweep_extract_stream_mesh(
                mesh1, classes, table.n, 10, block_source=src,
            )
            return PairwiseResult.from_row_stats(
                rs, pr, cross_amr_only=True
            )

        rec = {}
        t0 = time.perf_counter()
        res = _run_mesh()
        rec["cold_s"] = round(time.perf_counter() - t0, 3)
        warm = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            res2 = _run_mesh()
            warm = min(warm, time.perf_counter() - t0)
        rec["warm_s"] = round(warm, 3)
        got = res.parity_counters()
        ok = got == (golden if golden is not None else ref_counters)
        ok = ok and np.array_equal(res.pairs, res2.pairs)
        pairs_eq = (
            ref_pairs is not None
            and np.array_equal(res.pairs, ref_pairs)
        )
        rec["parity"] = (
            "golden-exact" if (ok and pairs_eq)
            else f"MISMATCH: counters={got} pairs_eq={pairs_eq}"
        )
        if ok and pairs_eq:
            golden_count += 1
        engines["stream_mesh_d1"] = rec
    except Exception as e:  # noqa: BLE001
        engines["stream_mesh_d1"] = {
            "parity": f"ERROR: {type(e).__name__}: {e}"
        }

    # BASELINE configs #2 (7-mer path, src/tree.rs:96-102) and #3
    # (BLOSUM62-weighted, src/blosum.rs) gated on the same hardware
    # pass. Bundled dataset only (the gates are dataset constants).
    extra_gates = (
        "mxu_7mer", "mxu_weighted", "stream_grouped_extract",
        "agglomerative",
    )
    if golden is None:
        for name in extra_gates:
            engines[name] = {"parity": "skipped (hardware+dataset gate)"}
            skipped += 1
    else:
        try:
            t0 = time.perf_counter()
            codes7, koff7 = encode_kmers(table.seq_buf, table.offsets, 7)
            idx7 = build_index(codes7, koff7, 7)
            bitset7 = pack_bitsets(
                idx7.incidence_protein,
                idx7.incidence_rank,
                table.n,
                idx7.n_repeated,
                row_multiple=512,
            )
            res7 = pairwise_similarity(
                bitset7, classes, PipelineConfig(k=7, engine="mxu"),
                index=idx7,
            )
            rec = {"cold_s": round(time.perf_counter() - t0, 3)}
            got7 = res7.parity_counters()
            ok7 = (
                got7 == GOLDEN_K7
                and res7.pairs.shape[0] == GOLDEN_K7["pairs_over_threshold"]
            )
            rec["parity"] = (
                "golden-exact" if ok7 else f"MISMATCH: {got7}"
            )
            golden_count += int(ok7)
        except Exception as e:  # noqa: BLE001
            rec = {"parity": f"ERROR: {type(e).__name__}: {e}"}
        engines["mxu_7mer"] = rec

        try:
            from uniprot_kmer_based_clustering_tpu.utils.blosum import (
                rank_weights_int8,
            )

            t0 = time.perf_counter()
            wts = rank_weights_int8(
                idx.repeated_codes, 5, bitset.w_pad * 32
            )
            resw = pairwise_similarity(
                bitset,
                classes,
                PipelineConfig(weighting="blosum62"),
                weights=wts,
                index=idx,
            )
            rec = {"cold_s": round(time.perf_counter() - t0, 3)}
            gotw = resw.parity_counters()
            okw = (
                gotw == GOLDEN_WEIGHTED
                and resw.pairs.shape[0]
                == GOLDEN_WEIGHTED["pairs_over_threshold"]
            )
            rec["parity"] = (
                "golden-exact" if okw else f"MISMATCH: {gotw}"
            )
            golden_count += int(okw)
        except Exception as e:  # noqa: BLE001
            rec = {"parity": f"ERROR: {type(e).__name__}: {e}"}
        engines["mxu_weighted"] = rec

        # grouped out-of-core extraction (the dense-homology pass-2 of
        # extract=auto): the bundled corpus is sparse-hit, so the auto
        # dispatch never routes here on its own — gate it directly,
        # forced multi-group (small bs + 1 GiB budget = real
        # re-streaming schedule) against the reference pair list.
        try:
            from uniprot_kmer_based_clustering_tpu.ops import (
                stream as _stream,
            )
            from uniprot_kmer_based_clustering_tpu.ops.stream import (
                extract_pairs_stream_grouped,
                sweep_mxu_stream,
            )

            cls_pad = np.full(bitset.n_pad, -1, np.int32)
            cls_pad[: table.n] = classes
            _, th_g, tl_g = sweep_mxu_stream(
                bitset.words, cls_pad, n=table.n, threshold=10,
                bs=1024, block=512,
            )
            t0 = time.perf_counter()
            pairs_g = extract_pairs_stream_grouped(
                bitset.words, cls_pad, th_g, tl_g, n=table.n,
                threshold=10, bs=1024, hbm_budget_bytes=1 << 30,
            )
            rec = {"cold_s": round(time.perf_counter() - t0, 3)}
            rec["trace"] = {
                k: (round(v, 2) if isinstance(v, float) else v)
                for k, v in _stream.last_grouped_trace.items()
            }
            okg = np.array_equal(pairs_g, ref_pairs)
            rec["parity"] = (
                "golden-exact" if okg else "MISMATCH vs reference pairs"
            )
            golden_count += int(okg)
        except Exception as e:  # noqa: BLE001
            rec = {"parity": f"ERROR: {type(e).__name__}: {e}"}
        engines["stream_grouped_extract"] = rec

        # agglomerative clustering golden (the reference's tree.rs
        # balance() capability as batched matmul mutual-argmax merges,
        # src/tree.rs:179-240): 123 clusters on the bundled dataset,
        # dendrogram = N − clusters merges (each merge retires exactly
        # one cluster). This is the pipeline's cluster="agglomerative"
        # path.
        try:
            from uniprot_kmer_based_clustering_tpu.models.agglomerative import (
                agglomerative_cluster,
            )

            t0 = time.perf_counter()
            agg = agglomerative_cluster(bitset, table.n)
            rec = {"cold_s": round(time.perf_counter() - t0, 3)}
            n_clusters = int(len(np.unique(agg.labels)))
            n_merges = int(agg.merges.shape[0])
            rec["clusters"] = n_clusters
            rec["dendrogram_rows"] = n_merges
            rec["rounds"] = int(agg.rounds)
            oka = (
                n_clusters == 123
                and n_merges == table.n - n_clusters
            )
            rec["parity"] = (
                "golden-exact" if oka
                else f"MISMATCH: clusters={n_clusters} merges={n_merges}"
            )
            golden_count += int(oka)
        except Exception as e:  # noqa: BLE001
            rec = {"parity": f"ERROR: {type(e).__name__}: {e}"}
        engines["agglomerative"] = rec

    # + the stream-mesh composition row + the k=7, weighted, grouped
    # and agglomerative gates; skipped gates drop out of the denominator
    total = len([n for n, _ in ENGINES]) + 1 + len(extra_gates) - skipped
    line = {
        "metric": "engine_parity",
        "value": float(golden_count),
        "unit": "engines",
        "vs_baseline": round(golden_count / total, 3),
        "engines_total": total,
        "engines_skipped": skipped,
        "pairs_over_threshold": (
            int(ref_pairs.shape[0]) if ref_pairs is not None else 0
        ),
        "engines": engines,
        "device": str(jax.devices()[0]),
        "card": card,
    }
    print(json.dumps(line))
    _write_artifact(line)


if __name__ == "__main__":
    main()
