"""Pre-warm the persistent compilation cache for the production shapes.

Running this once after a deploy (or a cache wipe) compiles the shapes
the CLI's default paths use into the persistent compilation cache
(``JAX_COMPILATION_CACHE_DIR``, else ``<checkout>/.jax_cache``; see
utils/accel.enable_persistent_cache) — every later process on the same
cache rehydrates them instead of compiling.

    python scripts/prewarm.py [fasta]    # default: bench.py's corpus

Shapes are keyed on (N_pad, W_pad), so pre-warm with a corpus of the
same padded geometry as production traffic.

Besides the per-config wall times, prints machine-parseable lines:

    prewarm <label>: <secs> s, <pairs> pairs
    prewarm_stage <label>|<stage>|<secs>
    prewarm_shape <label>|<jit name>|<secs>|<hit|compile>

The shape lines come from jax_log_compiles ("Finished XLA compilation
of jit(X) in T sec" — on a persistent-cache hit T is the rehydration
cost, on a miss the compile) classified by the
jax._src.compiler DEBUG hit events.
"""

import logging
import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

FASTA = sys.argv[1] if len(sys.argv) > 1 else None


class _CompileLog(logging.Handler):
    """Collect per-shape compile/rehydrate events from jax's loggers."""

    def __init__(self):
        super().__init__(level=logging.DEBUG)
        # ONE ordered stream of both event kinds: a program's cache-hit
        # line is logged inside compile_or_get_cached, immediately
        # before its "Finished XLA compilation" line, so a Finished
        # event is a rehydration iff a hit for the same (normalized)
        # name arrived since that name's previous Finished. Counting
        # hits per name without ordering mislabels configs where the
        # same jit name both hits (an old shape) and compiles (a new
        # one).
        self.events = []  # ("finished", name, secs) | ("hit", name)

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("Finished XLA compilation of "):
            # "Finished XLA compilation of jit(name) in 1.23 sec"
            try:
                name = msg.split(" of ", 1)[1].rsplit(" in ", 1)[0]
                secs = float(msg.rsplit(" in ", 1)[1].split(" ")[0])
            except (IndexError, ValueError):
                return
            self.events.append(("finished", name, secs))
        elif msg.startswith("Persistent compilation cache hit for "):
            self.events.append(("hit", self._norm(msg.split("'")[1])))

    @staticmethod
    def _norm(name):
        # dispatch logs "jit(sweep)", compiler logs module name "jit_sweep"
        return (
            name.replace("jit(", "").replace(")", "")
            .replace("jit_", "", 1).strip()
        )

    def drain(self):
        out = []
        pending_hits = set()
        for ev in self.events:
            if ev[0] == "hit":
                pending_hits.add(ev[1])
                continue
            _, name, secs = ev
            key = self._norm(name)
            kind = "hit" if key in pending_hits else "compile"
            pending_hits.discard(key)
            out.append((name, secs, kind))
        self.events = []
        return out


def main():
    from uniprot_kmer_based_clustering_tpu.utils.accel import (
        enable_persistent_cache,
        require_accelerator,
    )

    require_accelerator()
    enable_persistent_cache()

    import jax

    jax.config.update("jax_log_compiles", True)
    collector = _CompileLog()
    for lname in ("jax._src.dispatch", "jax._src.compiler"):
        lg = logging.getLogger(lname)
        lg.setLevel(logging.DEBUG)
        lg.addHandler(collector)

    import tempfile

    import bench

    with tempfile.TemporaryDirectory(prefix="ukc_prewarm_") as tmp:
        _warm(FASTA or bench.corpus_path(tmp), collector)


def _warm(fasta, collector):
    from uniprot_kmer_based_clustering_tpu.config import PipelineConfig
    from uniprot_kmer_based_clustering_tpu.pipeline import run_pipeline

    for label, cfg in (
        ("two_pass", PipelineConfig(cluster="none")),
        ("fused", PipelineConfig(cluster="none", extract="fused")),
        ("full_dump", PipelineConfig(cluster="none", threshold=0)),
    ):
        t0 = time.time()
        res = run_pipeline(fasta, cfg)
        print(
            f"prewarm {label}: {time.time() - t0:.1f} s, "
            f"{res.pairwise.pairs.shape[0]} pairs",
            flush=True,
        )
        for stage, secs in res.timings.items():
            print(f"prewarm_stage {label}|{stage}|{secs:.2f}", flush=True)
        for name, secs, kind in collector.drain():
            if secs >= 0.15:  # skip trivial host-op noise
                print(
                    f"prewarm_shape {label}|{name}|{secs:.2f}|{kind}",
                    flush=True,
                )


if __name__ == "__main__":
    main()
