"""Measure the choices the device build makes from timings on the card.

Times, warm and synchronized:

  * the sweep engine: ``engine="mxu"`` (int8 matmul) against
    ``engine="xla"`` (packed AND+popcount) on the 10,619-protein
    synthetic corpus;
  * the statistics epilogue: the strip sweep with its XLA epilogue
    against the counts-only floor (the same strips through
    ``_counts_window`` alone);
  * pair extraction with ``use_topk`` / ``coalesce`` on and off, on the
    10,619 corpus (sparse hits per tile) and on the 100k in-core corpus
    (every tile hits);

and writes the compiled HLO of one sweep strip, so the kind of GEMM XLA
picked for the int8 contraction can be read. Results go to
``chiprun_out/measure_choices.json`` (one JSON line is also printed).

    python scripts/measure_choices.py [--skip-100k]

Needs an accelerator: exits nonzero when JAX finds none.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

#: 10,619 proteins, 9,619 templates: 1,000 proteins share a template
#: with one other protein (the sparse-pair regime of the reference's
#: bundled dataset); chip_smoke.py uses the same corpus.
SMALL_N, SMALL_TEMPLATES = 10_619, 9_619


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def _times(fn, reps: int):
    import jax

    jax.block_until_ready(fn())  # compile + first run
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        out.append(time.perf_counter() - t0)
    return out


def _corpus(n: int, k: int = 5, **synth_kw):
    import bench_scale
    from uniprot_kmer_based_clustering_tpu.kmers import (
        build_index,
        encode_kmers,
        pack_bitsets,
    )

    seq_buf, offsets, classes = bench_scale.synth_proteins(n, **synth_kw)
    codes, koff = encode_kmers(seq_buf, offsets, k)
    idx = build_index(codes, koff, k)
    bs = pack_bitsets(
        idx.incidence_protein, idx.incidence_rank, n, idx.n_repeated,
        row_multiple=3584 if n > 3584 else 512,
    )
    cls = np.full(bs.n_pad, -1, np.int32)
    cls[:n] = classes
    return idx, bs, cls


def _extraction(words, cls, th, tiles, n, reps):
    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        extract_pairs,
    )

    res, ref = {}, None
    for topk, coalesce in ((False, False), (True, False), (True, True)):
        fn = functools.partial(
            extract_pairs, words, cls, th, tiles, n=n, threshold=10,
            use_topk=topk, coalesce=coalesce,
        )
        ts = _times(fn, reps)
        pairs = fn()
        if ref is None:
            ref = pairs
        assert np.array_equal(pairs, ref), "extraction paths disagree"
        res[f"topk={int(topk)},coalesce={int(coalesce)}"] = ts
    return res, int(len(ref))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--skip-100k", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        print("measure_choices: no accelerator found", file=sys.stderr)
        return 1
    from uniprot_kmer_based_clustering_tpu.ops import bitmul
    from uniprot_kmer_based_clustering_tpu.ops.bitmul import (
        _counts_window,
        sweep_mxu,
        sweep_mxu_async,
    )
    from uniprot_kmer_based_clustering_tpu.ops.popcount import sweep_xla

    out_dir = os.path.join(_ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    rec = {
        "card": _card(),
        "jax": jax.__version__,
        "device_kind": dev.device_kind,
        "bytes_limit": (dev.memory_stats() or {}).get("bytes_limit"),
    }
    print("card:", rec["card"], flush=True)

    t0 = time.perf_counter()
    idx, bs, cls = _corpus(SMALL_N, n_templates=SMALL_TEMPLATES)
    rec["small"] = {
        "n": SMALL_N, "n_pad": bs.n_pad, "w_pad": bs.w_pad,
        "setup_s": time.perf_counter() - t0,
    }
    words = jnp.asarray(bs.words)
    cls_j = jnp.asarray(cls)
    n = SMALL_N

    # --- engine: int8 matmul vs packed AND+popcount -------------------
    rec["small"]["mxu_s"] = _times(
        lambda: sweep_mxu(words, cls_j, n, 10, block=512)[:2], args.reps
    )
    rec["small"]["xla_s"] = _times(
        lambda: sweep_xla(words, cls_j, n, 10, tile=512)[:2], args.reps
    )
    rs_m, th_m, tiles = sweep_mxu(words, cls_j, n, 10, block=512)
    rs_x, th_x, _ = sweep_xla(words, cls_j, n, 10, tile=512)
    assert np.array_equal(rs_m, rs_x) and np.array_equal(
        th_m[:, :2], th_x[:, :2]
    ), "mxu and xla engines disagree"
    print("engine:", rec["small"]["mxu_s"], rec["small"]["xla_s"],
          flush=True)

    # --- epilogue over the counts-only floor ---------------------------
    sched, strip, ns = bitmul.resolve_schedule(bs.n_pad, 512)
    wts = jnp.ones(bs.w_pad * 32, jnp.int8)

    @functools.partial(jax.jit, static_argnames=("i0", "s", "jr"))
    def counts_only(words, wts, *, i0, s, jr):
        return _counts_window(words, wts, i0, i0, s=s, jr=jr)

    def floor():
        return [
            counts_only(words, wts, i0=si * strip, s=strip,
                        jr=bs.n_pad - si * strip)
            for si in range(ns)
        ]

    def full():
        return sweep_mxu_async(
            words, cls_j, n, 10, block=512, word_chunk=0
        )[0]

    rec["small"]["schedule"] = [sched, strip, ns]
    rec["small"]["epilogue_full_s"] = _times(full, args.reps)
    rec["small"]["epilogue_floor_s"] = _times(floor, args.reps)
    print("epilogue:", rec["small"]["epilogue_full_s"],
          rec["small"]["epilogue_floor_s"], flush=True)

    # --- HLO of one strip -----------------------------------------------
    lowered = bitmul._strip_stats.lower(
        words, cls_j[:strip], cls_j, wts,
        i0=0, strip=strip, n=n, threshold=10, block=512, w_thresh=1,
        word_chunk=0,
    )
    hlo = lowered.compile().as_text()
    with open(os.path.join(out_dir, "sweep_strip_hlo.txt"), "w") as f:
        f.write(hlo)
    rec["small"]["hlo_gemm_lines"] = sorted({
        ln.strip()[:240] for ln in hlo.splitlines()
        if re.search(r"custom-call|cublas|triton_gemm|dot\(", ln)
    })[:12]

    # --- extraction flags, sparse hits ---------------------------------
    rec["small"]["extract_s"], rec["small"]["pairs"] = _extraction(
        words, cls, th_m, tiles, n, args.reps
    )
    print("extract small:", rec["small"]["extract_s"], flush=True)
    del words

    # --- extraction flags, 100k in-core (every tile hits) --------------
    if not args.skip_100k:
        t0 = time.perf_counter()
        idx, bs, cls = _corpus(100_000)
        big = {
            "n": 100_000, "n_pad": bs.n_pad, "w_pad": bs.w_pad,
            "bitset_gib": bs.words.nbytes / 2**30,
            "setup_s": time.perf_counter() - t0,
        }
        words = jnp.asarray(bs.words)
        cls_j = jnp.asarray(cls)
        big["mxu_s"] = _times(
            lambda: sweep_mxu(words, cls_j, 100_000, 10, block=512)[:2], 1
        )
        _, th, tiles = sweep_mxu(words, cls_j, 100_000, 10, block=512)
        big["extract_s"], big["pairs"] = _extraction(
            words, cls, th, tiles, 100_000, 1
        )
        big["peak_bytes_in_use"] = (dev.memory_stats() or {}).get(
            "peak_bytes_in_use"
        )
        rec["big"] = big
        print("extract 100k:", big["extract_s"], flush=True)

    with open(os.path.join(out_dir, "measure_choices.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
