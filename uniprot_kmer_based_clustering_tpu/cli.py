"""Command-line interface.

The reference CLI is ``cargo run --release -- <fasta> <threads>``
(src/main.rs:54-60) and prints a Debug dump of the whole graph to stdout.
Here:

  uniprot-kmer-cluster run <fasta> [--k {5,7}] [--threshold N]
      [--sampling {all,random10}] [--weighting {none,blosum62}]
      [--cluster {components,tree,agglomerative,none}] [--min-shared N]
      [--engine {auto,mxu,xla,native,stream}]
      [--index-engine {host,device}]
      [--devices N] [--mesh-shape HxC] [--shard-axis {rows,kmers}]
      [--distributed] [--align {none,diamond,sw,auto}] [--all-pairs]
      [--checkpoint-dir DIR] [--out DIR] [--dump-kmers]
      [--dump-proteins] [--dump-debug] [--profile DIR] [--cpu]
      [--verbose]

writes structured artifacts to --out: pairs.tsv, clusters.tsv,
dendrogram.tsv (agglomerative), stats.json (parity counters +
timings), blastp_output.tsv (--align), pair_kmers.tsv / proteins.tsv
(the reference's Debug-dump content).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _build_config(args):
    from uniprot_kmer_based_clustering_tpu.config import PipelineConfig

    return PipelineConfig(
        k=args.k,
        threshold=args.threshold,
        weighted_threshold=args.weighted_threshold,
        sampling=args.sampling,
        seed=args.seed,
        cross_amr_only=not args.all_pairs,
        weighting=args.weighting,
        cluster=args.cluster,
        min_shared=args.min_shared,
        engine=args.engine,
        index_engine=args.index_engine,
        stream_source=getattr(args, "stream_source", "host"),
        extract=getattr(args, "extract", "auto"),
        extract_k=getattr(args, "extract_k", 0),
        run_diamond=args.diamond,
    )


def _init_jax(args) -> None:
    """Shared run/query jax setup: pin the CPU when --cpu asks for it
    (before any device use), otherwise require an accelerator — the CPU
    is used only when asked for, with --cpu or JAX_PLATFORMS=cpu — and
    turn on the persistent compilation cache."""
    import jax

    from uniprot_kmer_based_clustering_tpu.utils.accel import (
        cpu_pinned,
        enable_persistent_cache,
        require_accelerator,
    )

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if getattr(args, "distributed", False):
        # before anything touches a backend
        from uniprot_kmer_based_clustering_tpu.parallel import (
            init_distributed,
        )

        init_distributed()
    require_accelerator(allow_cpu=cpu_pinned())
    enable_persistent_cache()


def cmd_run(args) -> int:
    import jax

    _init_jax(args)

    from uniprot_kmer_based_clustering_tpu.pipeline import run_pipeline

    config = _build_config(args)
    mesh = None
    if args.mesh_shape:
        if args.shard_axis == "kmers":
            raise SystemExit(
                "--mesh-shape (2-D ring) and --shard-axis kmers are "
                "mutually exclusive sharding layouts"
            )
        from uniprot_kmer_based_clustering_tpu.parallel import make_mesh_2d

        hc, cc = (int(x) for x in args.mesh_shape.lower().split("x"))
        mesh = make_mesh_2d(hc, cc)
    elif (
        (args.devices and args.devices > 1)
        or args.distributed
        or args.shard_axis == "kmers"  # spans all devices if no count
    ):
        from uniprot_kmer_based_clustering_tpu.parallel import make_mesh

        # --distributed with no explicit count spans every device of
        # every process; devices=0 means unspecified; an explicit
        # --devices 1 with --distributed/--shard-axis builds a 1-device mesh
        mesh = make_mesh(
            args.devices if args.devices >= 1 else None,
            axis="k" if args.shard_axis == "kmers" else "p",
        )

    import contextlib

    profile_ctx = (
        jax.profiler.trace(args.profile)
        if args.profile
        else contextlib.nullcontext()
    )
    with profile_ctx:
        result = run_pipeline(
            args.fasta,
            config,
            checkpoint_dir=args.checkpoint_dir,
            mesh=mesh,
            echo_timings=args.verbose,
        )

    if jax.process_count() > 1 and jax.process_index() != 0:
        # Multi-host: every process computes (replicated results), only
        # process 0 writes — N hosts on a shared filesystem would
        # race-write the same files otherwise.
        return

    os.makedirs(args.out, exist_ok=True)
    table = result.table
    pairs = result.pairwise.pairs

    with open(os.path.join(args.out, "pairs.tsv"), "w") as f:
        score_col = "weighted_score" if config.weighting != "none" else "shared_kmers"
        f.write(f"protein_i\tprotein_j\tid_i\tid_j\tclass_i\tclass_j\t{score_col}\n")
        for i, j, c in pairs:
            f.write(
                f"{i}\t{j}\t{table.ids[i]}\t{table.ids[j]}\t"
                f"{table.amr_classes[i]}\t{table.amr_classes[j]}\t{c}\n"
            )

    if result.cluster_labels is not None:
        with open(os.path.join(args.out, "clusters.tsv"), "w") as f:
            f.write("protein\tid\tamr_class\tcluster\n")
            for i in range(table.n):
                f.write(
                    f"{i}\t{table.ids[i]}\t{table.amr_classes[i]}\t"
                    f"{result.cluster_labels[i]}\n"
                )

    if result.dendrogram is not None and len(result.dendrogram):
        with open(os.path.join(args.out, "dendrogram.tsv"), "w") as f:
            f.write("winner\tloser\tshared_kmers\n")
            for w, l, c in result.dendrogram:
                f.write(f"{w}\t{l}\t{c}\n")

    stats = {
        "config": {
            k: v for k, v in vars(args).items()
            if k not in ("func", "out", "verbose")
        },
        "parity": result.parity_report(),
        "clusters": result.cluster_summary(),
        "timings_s": {k: round(v, 4) for k, v in result.timings.items()},
        "device": str(jax.devices()[0]),
        "engine": result.engine,
        "n_devices": int(mesh.devices.size) if mesh is not None else 1,
    }
    with open(os.path.join(args.out, "stats.json"), "w") as f:
        json.dump(stats, f, indent=2)

    if args.dump_kmers and len(pairs):
        from uniprot_kmer_based_clustering_tpu.similarity.kmers_of_pairs import (
            shared_kmer_strings,
        )

        with open(os.path.join(args.out, "pair_kmers.tsv"), "w") as f:
            f.write("protein_i\tprotein_j\tshared_kmers\n")
            for row, kmers in zip(
                pairs,
                shared_kmer_strings(result.index, pairs, result.bitset),
            ):
                f.write(f"{row[0]}\t{row[1]}\t{','.join(kmers)}\n")

    if args.dump_proteins:
        # the reference's protein Debug dump (decoded k-mer strings,
        # src/protein.rs:65-74) + vertex degree (src/graph/vertex.rs:159-166)
        from uniprot_kmer_based_clustering_tpu.similarity.kmers_of_pairs import (
            protein_kmer_strings,
        )

        degree = [0] * table.n
        for i, j, _ in pairs:
            degree[int(i)] += 1
            degree[int(j)] += 1
        with open(os.path.join(args.out, "proteins.tsv"), "w") as f:
            f.write(
                "protein\tid\tamr_class\tlength\tdegree\trepeated_kmers\n"
            )
            for i, kmers in enumerate(
                protein_kmer_strings(result.index, result.bitset)
            ):
                f.write(
                    f"{i}\t{table.ids[i]}\t{table.amr_classes[i]}\t"
                    f"{table.lengths[i]}\t{degree[i]}\t{','.join(kmers)}\n"
                )

    if args.dump_debug:
        # the reference's stdout Debug dump (src/main.rs:235), in the
        # literal Rust {:#?} text format; the reference-equivalent full
        # dump is a --threshold 0 run (io/debug_dump.py)
        from uniprot_kmer_based_clustering_tpu.io.debug_dump import (
            rust_debug_dump_to_path,
        )

        rust_debug_dump_to_path(
            os.path.join(args.out, "graph_debug.txt"),
            result.index, pairs, table.n, bitset=result.bitset,
        )

    align_mode = args.align
    if config.run_diamond and align_mode == "none":
        align_mode = "diamond"  # --diamond back-compat
    if align_mode != "none" and len(pairs):
        from uniprot_kmer_based_clustering_tpu.align import (
            align_pairs,
            align_pairs_sw,
            diamond_available,
        )

        tsv = os.path.join(args.out, "blastp_output.tsv")
        if align_mode == "auto":
            align_mode = "diamond" if diamond_available() else "sw"
        if align_mode == "diamond" and not diamond_available():
            print(
                "diamond not found on PATH — falling back to the "
                "on-device Smith-Waterman aligner (--align sw)",
                file=sys.stderr,
            )
            align_mode = "sw"
        if align_mode == "diamond":
            out = align_pairs(table, pairs, tsv)
        else:
            out = align_pairs_sw(table, pairs, tsv)
        print(f"wrote {out} ({align_mode})", file=sys.stderr)

    print(json.dumps(stats["parity"]))
    return 0


def cmd_query(args) -> int:
    """Serve shared-k-mer searches against a corpus index.

    The corpus pipeline runs up to the bitset (resuming from
    --checkpoint-dir when given — warm startup), then each query
    sequence gets one [Q, K]x[K, N] matmul against the standing index;
    matches print as TSV (query, corpus id, AMR class, shared k-mers).
    """
    _init_jax(args)

    from uniprot_kmer_based_clustering_tpu.config import PipelineConfig
    from uniprot_kmer_based_clustering_tpu.pipeline import run_pipeline
    from uniprot_kmer_based_clustering_tpu.similarity import (
        query_shared_kmers,
    )

    seqs = list(args.seq or [])
    names = [f"query{i}" for i in range(len(seqs))]
    if args.query_fasta:
        from uniprot_kmer_based_clustering_tpu.io.fasta import (
            _read_file_bytes,
            parse_fasta_bytes,
        )

        # _read_file_bytes: gzip handled identically to the corpus path
        qids, qbuf, qoff = parse_fasta_bytes(
            _read_file_bytes(args.query_fasta)
        )
        for qi, qid in enumerate(qids):
            names.append(qid)
            # latin-1 round-trips arbitrary residue bytes (anything
            # outside the alphabet hits the '*' catch-all downstream)
            seqs.append(
                qbuf[qoff[qi] : qoff[qi + 1]].tobytes().decode("latin-1")
            )
    if not seqs:
        raise SystemExit("no queries: pass --seq and/or --query-fasta")

    config = PipelineConfig(
        k=args.k, threshold=args.threshold, cluster="none",
        weighting=args.weighting,
    )
    res = run_pipeline(
        args.fasta, config, checkpoint_dir=args.checkpoint_dir,
        stop_after="pack",
    )
    weights = None
    threshold = args.threshold
    if args.weighting == "blosum62":
        from uniprot_kmer_based_clustering_tpu.utils.blosum import (
            rank_weights_int8,
        )

        weights = rank_weights_int8(
            res.index.repeated_codes, config.k, res.bitset.w_pad * 32
        )
        # same gate scaling as the weighted batch sweep (raw 10 applied
        # to BLOSUM scores would pass any pair sharing one k-mer)
        threshold = config.effective_weighted_threshold(weights)
    matches = query_shared_kmers(
        res.index, res.bitset, seqs,
        threshold=threshold, weights=weights, top=args.top,
    )
    print("query\tprotein\tid\tamr_class\tshared_kmers")
    for name, m in zip(names, matches):
        for j, c in m:
            print(
                f"{name}\t{j}\t{res.table.ids[j]}\t"
                f"{res.table.amr_classes[j]}\t{c}"
            )
    return 0


def cmd_bench(args) -> int:
    if args.fasta is not None:
        # an explicitly passed path wins over an exported UKC_BENCH_FASTA;
        # with no positional arg the env var (then bench.py's default) rules
        os.environ["UKC_BENCH_FASTA"] = args.fasta
    try:
        import bench  # repo-root bench script (running from a checkout)
    except ModuleNotFoundError:
        # installed console entry point run from an arbitrary cwd: load
        # the script by path from the repo root two levels up, if present
        import importlib.util

        cand = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "bench.py",
        )
        if not os.path.exists(cand):
            print(
                "ukc bench needs the repo checkout's bench.py "
                "(run from the repository root)",
                file=sys.stderr,
            )
            return 2
        spec = importlib.util.spec_from_file_location("bench", cand)
        bench = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(bench)

    bench.main()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="uniprot-kmer-cluster",
        description="protein k-mer similarity and clustering on the GPU",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="run the full pipeline")
    r.add_argument("fasta")
    r.add_argument("--k", type=int, default=5, choices=(5, 7))
    r.add_argument("--threshold", type=int, default=10,
                   help="align pairs sharing > threshold k-mers "
                        "(reference hardcodes 10, src/graph/mod.rs:242)")
    r.add_argument("--weighted-threshold", type=int, default=None)
    r.add_argument("--sampling", default="all", choices=("all", "random10"))
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--weighting", default="none", choices=("none", "blosum62"))
    r.add_argument("--min-shared", type=int, default=1,
                   help="agglomerative merge gate: min shared k-mers "
                        "between cluster signatures (tree.rs balance() "
                        "uses any-shared = 1)")
    r.add_argument("--cluster", default="components",
                   choices=("components", "tree", "agglomerative", "none"),
                   help="agglomerative = batched matmul mutual-argmax "
                        "signature merges (the device-side tree)")
    r.add_argument("--engine", default="auto",
                   choices=("auto", "mxu", "xla", "native", "stream"),
                   help="mxu = int8 matmul sweep, xla = packed "
                        "AND+popcount sweep, native = C++ host sweep, "
                        "stream = out-of-core matmul sweep: the packed "
                        "matrix stays in host RAM, row blocks stream "
                        "through the device (corpora beyond one "
                        "device's memory)")
    r.add_argument("--extract", default="auto",
                   choices=("auto", "two_pass", "fused", "onepass"),
                   help="pair recovery strategy (mxu engine): two_pass "
                        "recomputes hit tiles; fused compacts survivors "
                        "inside the sweep itself (dense-homology corpora; "
                        "on a mesh it also halves the sweep+extract "
                        "passes on every layout); onepass (stream engine) compacts "
                        "survivors into device pair buffers during "
                        "the streamed sweep itself. Bit-identical "
                        "outputs")
    r.add_argument("--extract-k", type=int, default=0,
                   help="extraction capacity: with --extract fused, the "
                        "per-sub-tile candidate capacity (typ. 512-4096); "
                        "with --extract onepass, the TOTAL device "
                        "pair-buffer rows (128-row granularity, typ. "
                        "millions) — not interchangeable "
                        "(0 = auto from the memory budget in both modes)")
    r.add_argument("--stream-source", default="host",
                   choices=("host", "csr"),
                   help="stream-engine block source: host-resident "
                        "packed rows, or csr (blocks materialize on "
                        "device from the incidence lists — for hosts "
                        "where upload bandwidth is the bottleneck; "
                        "pairs with --extract onepass)")
    r.add_argument("--index-engine", default="host",
                   choices=("host", "device"),
                   help="build the doc-freq index + bitset on the host "
                        "or the device")
    r.add_argument("--all-pairs", action="store_true",
                   help="keep same-AMR-class pairs too")
    r.add_argument("--devices", type=int, default=0,
                   help="shard the sweep over N devices")
    r.add_argument("--shard-axis", default="rows",
                   choices=("rows", "kmers"),
                   help="rows: ring-rotate protein blocks (compute "
                        "scaling); kmers: shard the bitset k-mer axis, "
                        "psum partial counts (memory scaling for --k 7)")
    r.add_argument("--mesh-shape", default=None, metavar="HxC",
                   help="hierarchical (hosts x devices) mesh for the 2-D "
                        "ring sweep, e.g. 2x4 (one cross-host hop per outer "
                        "step)")
    r.add_argument("--checkpoint-dir", default=None)
    r.add_argument("--out", default="ukc_out")
    r.add_argument("--diamond", action="store_true",
                   help="run diamond blastp on surviving pairs "
                        "(alias for --align diamond)")
    r.add_argument("--align", default="none",
                   choices=("none", "diamond", "sw", "auto"),
                   help="alignment backend for surviving pairs: diamond "
                        "subprocesses (the reference's), sw = on-device "
                        "batched Smith-Waterman (no external binary), "
                        "auto = diamond if installed else sw")
    r.add_argument("--dump-kmers", action="store_true",
                   help="write each pair's shared k-mers (decoded)")
    r.add_argument("--dump-proteins", action="store_true",
                   help="write per-protein decoded repeated k-mers + pair "
                        "degree (the reference's protein Debug dump)")
    r.add_argument("--dump-debug", action="store_true",
                   help="write graph_debug.txt: the reference's stdout "
                        "graph dump in the literal Rust {:#?} format "
                        "(use --threshold 0 for the reference-equivalent "
                        "full dump)")
    r.add_argument("--cpu", action="store_true",
                   help="run on the CPU (without it, a run that finds no "
                        "GPU stops with an error)")
    r.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a jax.profiler trace of the run into DIR "
                        "(view with tensorboard/xprof)")
    r.add_argument("--distributed", action="store_true",
                   help="initialize jax.distributed (one process per "
                        "host of a multi-host cluster)")
    r.add_argument("-v", "--verbose", action="store_true")
    r.set_defaults(func=cmd_run)

    q = sub.add_parser(
        "query",
        help="search new sequences against a corpus index (serving)",
    )
    q.add_argument("fasta", help="corpus FASTA (the standing index)")
    q.add_argument("--seq", action="append", metavar="AASEQ",
                   help="query amino-acid sequence (repeatable)")
    q.add_argument("--query-fasta", default=None,
                   help="FASTA of query sequences")
    q.add_argument("--k", type=int, default=5, choices=(5, 7))
    q.add_argument("--threshold", type=int, default=10)
    q.add_argument("--weighting", default="none",
                   choices=("none", "blosum62"))
    q.add_argument("--top", type=int, default=None,
                   help="keep only the best N matches per query")
    q.add_argument("--checkpoint-dir", default=None,
                   help="reuse/persist the corpus index (warm startup)")
    q.add_argument("--cpu", action="store_true",
                   help="run on the CPU (see run --cpu)")
    q.set_defaults(func=cmd_query)

    b = sub.add_parser("bench", help="run the headline benchmark")
    b.add_argument("fasta", nargs="?", default=None,
                   help="dataset (default: $UKC_BENCH_FASTA or the "
                        "bundled uniprot_arg.fasta)")
    b.set_defaults(func=cmd_bench)

    args = p.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
