"""Sharded O(N²) pair sweep: ring rotation of protein blocks over the mesh.

Schedule (the balanced triangle ring, SURVEY.md §5):
  * the bitset matrix is row-sharded; each device keeps its block
    stationary and a moving copy rotates around the ring via ``ppermute``;
  * step 0 computes the within-block upper triangle — as tile-aligned
    row STRIPS against their column suffix ((ns+1)/(2·ns) of the block
    square's MACs, the single-chip strip schedule's trick), not a full
    square with half masked;
  * steps 1..⌈(D−1)/2⌉ compute the (stationary × moving) block pair — each
    unordered block pair appears on exactly one device per step;
  * for even D, the final step sees each unordered block pair on TWO
    devices — the pair region is SPLIT between them (each computes two
    half-block matmuls over its half of the region; only slice offsets
    differ per device, which SPMD allows), so every device does equal
    useful work instead of half the ring idling (see _ring_substeps).

Every pair (i<j) is therefore counted exactly once, independent of D —
the sharded sweep's aggregate statistics, hit tiles, and extracted pair
sets are bit-identical to the single-chip sweep for every device count
(tested in ``tests/test_sharded.py`` on an 8-device CPU mesh and in
``tests/test_multiprocess.py`` on a real 2-process jax.distributed
cluster). Note one engine-convention difference: per-row stats credit a
pair to its *stationary-block* row, while the single-chip engines credit
the smaller index — only aggregates and pair sets are cross-engine
invariants (nothing downstream consumes per-row attribution).

Per-device block math is the int8 matmul engine (``ops.bitmul``).
Collectives run over the device interconnect (NVLink between the cards
of one host); only the final psum of the small hit matrix and scalar
stats crosses hosts.

Replaces, at cluster scale, the reference's dynamic work-claiming over
258M edge slots (``src/graph/mod.rs:77-118`` packed-u64 atomic cursor):
the tile space is statically partitioned, so there is no claiming, no
atomics, and the result is deterministic for any device count.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from uniprot_kmer_based_clustering_tpu.ops.bitmul import (
    merge_row_stats_at,
    stack_row_stats,
    unpack_words_to_int8,
)

try:  # jax >= 0.6 exports shard_map at the top level
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map


def _block_counts(words_a, words_b, weights=None):
    """int32 [A, B] shared-k-mer counts between two packed blocks (int8
    matmul).

    Per-k-mer-column `weights` scale the stationary operand — since the
    weighting is diagonal in the contraction axis, weighting one side
    yields the exact weighted score (A·diag(w)·Bᵀ)."""
    a = unpack_words_to_int8(words_a, weights)
    b = unpack_words_to_int8(words_b)
    return jax.lax.dot_general(
        a, b, (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32
    )


def _pair_stats(counts, gi, gj, ca, cb, n, threshold, active, triangle):
    """Masked per-stationary-row stats + over-threshold mask for one block
    pair. `active` scales the whole contribution (even-D dedup step);
    `triangle` applies the gi<gj mask (diagonal step only)."""
    valid = (gj < n) & (gi < n) & active
    if triangle:
        valid &= gi < gj
    cross = valid & (ca[:, None] != cb[None, :])
    same = valid & ~cross
    return stack_row_stats(counts, cross, same, threshold)


def _step_stats_tiled(
    counts, gi_row, gj_col, ca, cb, n, threshold, active, triangle,
    block_tile: int,
):
    """Hierarchical XLA statistics for one sub-block: reshape the
    [S, J] counts to [S, J/tile, tile] lanes-last and reduce the lane
    axis in ONE variadic ``lax.reduce`` over the 8 masked operands, so
    the mask chain fuses into a single traversal of the counts block
    and the only materialized intermediates are the [S, J/tile] int32
    per-(row, tile-column) partials. Per-row stats and per-tile hit
    counts both finish from those partials (tiny second-stage
    reductions) — the flat chain's full-block ``over_c``/``over_s``
    masks and ``czero``/``szero`` copies never exist.

    Bit-identical to ``_pair_stats`` + ``_fused_subtiles``: int32
    addition is associative mod 2³² (two's complement), so regrouping
    the sum per tile column cannot change any lane; max lanes regroup
    trivially. ``gi_row [S]`` / ``gj_col [J]`` are the sub-block's
    global index VECTORS (the flat chain's iota matrices sliced at
    [:, 0] / [0, :] — XLA folds the slice back to a 1-D iota).

    The counts sit behind an optimization barrier: it materializes the
    counts block once (it exists anyway as the matmul output) and keeps
    XLA from fusing the variadic reduce into the matmul's consumer.

    Returns (row_stats int32 [S, 8], bh int32 [S/tile, J/tile, 2]).
    """
    counts = jax.lax.optimization_barrier(counts)
    s, j = counts.shape
    qi, qj = s // block_tile, j // block_tile
    c3 = counts.reshape(s, qj, block_tile)
    g3 = gj_col.reshape(qj, block_tile)
    cb3 = cb.reshape(qj, block_tile)
    valid = (g3 < n)[None] & (gi_row < n)[:, None, None] & active
    if triangle:
        valid = valid & (gi_row[:, None, None] < g3[None])
    cross = valid & (ca[:, None, None] != cb3[None])
    same = valid & ~cross
    czero = jnp.where(cross, c3, 0)
    szero = jnp.where(same, c3, 0)
    ops = (
        czero,
        (cross & (c3 >= 1)).astype(jnp.int32),
        (cross & (c3 > threshold)).astype(jnp.int32),
        czero,
        szero,
        (same & (c3 >= 1)).astype(jnp.int32),
        (same & (c3 > threshold)).astype(jnp.int32),
        szero,
    )

    def _comb(a, b):
        return (
            a[0] + b[0], a[1] + b[1], a[2] + b[2],
            jnp.maximum(a[3], b[3]),
            a[4] + b[4], a[5] + b[5], a[6] + b[6],
            jnp.maximum(a[7], b[7]),
        )

    red = jax.lax.reduce(ops, (jnp.int32(0),) * 8, _comb, (2,))
    row_stats = jnp.stack(
        [
            red[0].sum(axis=1),
            red[1].sum(axis=1),
            red[2].sum(axis=1),
            red[3].max(axis=1),
            red[4].sum(axis=1),
            red[5].sum(axis=1),
            red[6].sum(axis=1),
            red[7].max(axis=1),
        ],
        axis=1,
    )
    bh = jnp.stack(
        [
            red[2].reshape(qi, block_tile, qj).sum(axis=1),
            red[6].reshape(qi, block_tile, qj).sum(axis=1),
        ],
        axis=-1,
    )
    return row_stats, bh


def _step_stats_xla(
    counts, gi, gj, ca, cb, n, threshold, active, triangle,
    block_tile: int, stats_engine: str,
):
    """One sub-block's (row_stats, bh) via the XLA epilogue —
    "xla_tiled_barrier" (the "auto" default) is the single-pass
    hierarchical reduce; "xla" keeps the flat mask/reduce chain."""
    if stats_engine == "xla":
        stats, over_c, over_s = _pair_stats(
            counts, gi, gj, ca, cb, n, threshold, active, triangle
        )
        bh, _ = _fused_subtiles(over_c, over_s, block_tile, 0, True)
        return stats, bh
    return _step_stats_tiled(
        counts, gi[:, 0], gj[0, :], ca, cb, n, threshold, active,
        triangle, block_tile,
    )


def _resolve_stats_engine(stats_engine: str) -> str:
    # "auto" is the tiled reduce behind an optimization barrier
    # (_step_stats_tiled); "xla" (the flat mask/reduce chain) stays
    # selectable. The two are bit-identical (tests/test_sharded.py);
    # neither has been timed on the GPU.
    if stats_engine == "auto":
        return "xla_tiled_barrier"
    if stats_engine not in ("xla", "xla_tiled_barrier"):
        raise ValueError(f"unknown stats_engine {stats_engine!r}")
    return stats_engine


def _fused_subtiles(over_c, over_s, block_tile: int, k: int,
                    cross_amr_only: bool):
    """Per-sub-tile hit counts + the fused extraction mask for one
    [R, C] survivor-mask window (R, C multiples of ``block_tile``).

    THE single implementation shared by every fused mesh layout (flat
    ring / 2-D ring / k-axis) and the plain ring's XLA stats branch —
    the drop criterion and the hit layout must never drift between
    them. Returns (bh int32 [qi, qj, 2], mask): with ``k`` > 0, mask
    zeroes every sub-tile whose survivor count exceeds the top_k width
    ``k`` (those pairs are recovered exactly by the fallback pass,
    never silently truncated)."""
    qi = over_c.shape[0] // block_tile
    qj = over_c.shape[1] // block_tile
    sub_c = (
        over_c.astype(jnp.int32)
        .reshape(qi, block_tile, qj, block_tile).sum(axis=(1, 3))
    )
    sub_s = (
        over_s.astype(jnp.int32)
        .reshape(qi, block_tile, qj, block_tile).sum(axis=(1, 3))
    )
    bh = jnp.stack([sub_c, sub_s], axis=-1)
    mask = over_c if cross_amr_only else (over_c | over_s)
    if k > 0:
        sub_hits = sub_c if cross_amr_only else sub_c + sub_s
        mask &= jnp.broadcast_to(
            (sub_hits <= k)[:, None, :, None],
            (qi, block_tile, qj, block_tile),
        ).reshape(over_c.shape)
    return bh, mask


def _merge_row_stats(row_stats, stats):
    """Accumulate one full-block step's stats (the ROW_STAT_NAMES merge
    at offset 0 — ops.bitmul.merge_row_stats_at is the single rule)."""
    return merge_row_stats_at(row_stats, stats, 0)


def stage_mesh_inputs(
    mesh: Mesh,
    words,
    classes,
    axis: str = "p",
    host_axis: str = "h",
    chip_axis: str = "c",
):
    """Stage (words, classes) onto ``mesh`` with the layout every sharded
    wrapper uses — ONCE, so a sweep followed by extraction (or repeated
    calls) does not re-upload the packed matrix.

    ``jax.device_put`` with an identical ``NamedSharding`` on an
    already-committed array is a no-op, so the wrappers' internal
    ``_stage_inputs`` calls pass staged arrays straight through. The
    upload is the dominant cost of a warm mesh pass on this host
    (~4.4 s for the bundled 307 MB at ~70 MB/s; ~2 minutes for a 100k
    corpus's 9 GB), and the pipeline's sweep→extract sequence was
    paying it twice.

    Layout dispatch matches :func:`sharded_pairwise_fused`: two mesh
    axes → hierarchical (hosts × chips) row sharding; a single ``"k"``
    axis → contraction-axis column sharding; otherwise the flat ring's
    row sharding.
    """
    two_d = len(mesh.axis_names) == 2
    kaxis = not two_d and mesh.axis_names[0] == "k"
    if two_d:
        row_spec = P((host_axis, chip_axis), None)
        cls_spec = P((host_axis, chip_axis))
    elif kaxis:
        row_spec, cls_spec = P(None, "k"), P(None)
    else:
        row_spec, cls_spec = P(axis, None), P(axis)
    words_s = jax.device_put(
        jnp.asarray(words), NamedSharding(mesh, row_spec)
    )
    classes_s = jax.device_put(
        jnp.asarray(classes, jnp.int32), NamedSharding(mesh, cls_spec)
    )
    return words_s, classes_s


def stage_mesh_inputs_csr(
    mesh: Mesh,
    incidence_protein,
    incidence_rank,
    n_pad: int,
    w_pad: int,
    classes,
    axis: str = "p",
):
    """Stage the ROW-SHARDED packed bitset onto a flat mesh by
    materializing each device's shard ON DEVICE from the sparse
    incidence lists — the pod-scale analogue of the stream engine's
    CSR block source.

    ``stage_mesh_inputs`` uploads the dense host matrix (minutes at the
    100k/9 GB scale through a slow link, and impossible when the host
    never built it); this stages only the incidences (~0.02% of the
    dense volume at scale) plus the per-shard split, then one
    ``shard_map`` scatter builds the dense shards in place. Each
    shard's flat scatter space is ``shard_rows · w_pad`` — per-device,
    so the int32 flat-index ceiling that limits the whole-matrix device
    build (kmers/index_device.py) never binds. Bits are identical to
    ``pack_bitsets`` rows by construction (pinned in
    tests/test_sharded.py).

    Returns ``(words_sharded [n_pad, w_pad] P(axis, None),
    classes_sharded P(axis))``. ``axis`` may be a tuple of mesh axis
    names for hierarchical row sharding (the 2-D ring's
    ``P((h, c), None)`` layout — row shards are contiguous in raveled
    device order, so the per-shard split is identical).

    ``axis="k"`` stages the CONTRACTION-sharded layout instead
    (``P(None, "k")`` — bitset columns divided over devices, classes
    replicated, the k-axis sweep's HBM-scaling layout for the 7-mer
    universe): the incidences are split by COLUMN range host-side
    (word = rank >> 5; device = word // (w_pad/D)) and each device
    scatter-builds its ``[n_pad, w_pad/D]`` column shard — the flat
    scatter space is per-device here too, so the int32 ceiling never
    binds on either axis of the layout matrix.
    """
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    if axes == ("k",):
        return _stage_mesh_csr_kaxis(
            mesh, incidence_protein, incidence_rank, n_pad, w_pad,
            classes,
        )
    row_spec = P(axes if len(axes) > 1 else axes[0], None)
    cls_spec = P(axes if len(axes) > 1 else axes[0])
    d = int(mesh.devices.size)
    assert n_pad % d == 0, (n_pad, d)
    shard = n_pad // d
    p = np.asarray(incidence_protein, np.int32)
    r = np.asarray(incidence_rank, np.int32)
    if p.shape[0] and np.any(np.diff(p) < 0):
        order = np.argsort(p, kind="stable")
        p, r = p[order], r[order]
    offs = np.searchsorted(p, np.arange(d + 1) * shard)
    m = int(np.diff(offs).max()) if d else 0
    m = max(8, -(-m // 8) * 8)
    rows = np.zeros((d, m), np.int32)
    ranks = np.zeros((d, m), np.int32)
    valid = np.zeros((d, m), bool)
    for b in range(d):
        lo, hi = offs[b], offs[b + 1]
        rows[b, : hi - lo] = p[lo:hi] - b * shard
        ranks[b, : hi - lo] = r[lo:hi]
        valid[b, : hi - lo] = True
    rows_s = jax.device_put(rows, NamedSharding(mesh, row_spec))
    ranks_s = jax.device_put(ranks, NamedSharding(mesh, row_spec))
    valid_s = jax.device_put(valid, NamedSharding(mesh, row_spec))

    def build(rows_l, ranks_l, valid_l):
        # [1, m] local slices; padding lanes go to out-of-bounds slots
        # (dropped). Two ranks of one row in the same 32-bit word share
        # a flat index, so the scatter-add must not claim unique indices.
        lane = jnp.arange(rows_l.shape[1], dtype=jnp.int32)
        flat = jnp.where(
            valid_l[0], rows_l[0] * w_pad + (ranks_l[0] >> 5),
            shard * w_pad + lane,
        )
        bit = jnp.where(
            valid_l[0],
            jnp.uint32(1) << (ranks_l[0] & 31).astype(jnp.uint32),
            jnp.uint32(0),
        )
        words = jnp.zeros(shard * w_pad, jnp.uint32).at[flat].add(
            bit, mode="drop"
        )
        return words.reshape(shard, w_pad)

    words_s = jax.jit(
        shard_map(
            build,
            mesh=mesh,
            in_specs=(row_spec, row_spec, row_spec),
            out_specs=row_spec,
        )
    )(rows_s, ranks_s, valid_s)
    cls = np.asarray(classes, np.int32)
    if cls.shape[0] < n_pad:
        cls = np.concatenate(
            [cls, np.full(n_pad - cls.shape[0], -1, np.int32)]
        )
    classes_s = jax.device_put(cls, NamedSharding(mesh, cls_spec))
    return words_s, classes_s


def _stage_mesh_csr_kaxis(mesh, incidence_protein, incidence_rank,
                          n_pad: int, w_pad: int, classes):
    """Column-range CSR staging for the k-axis layout (see
    :func:`stage_mesh_inputs_csr`). Returns
    ``(words [n_pad, w_pad] P(None, "k"), classes [n_pad] P(None))``."""
    d = int(mesh.devices.size)
    assert w_pad % d == 0, (
        f"W={w_pad} packed words must divide over {d} devices"
    )
    ws = w_pad // d
    p = np.asarray(incidence_protein, np.int32)
    r = np.asarray(incidence_rank, np.int32)
    dev = (r >> 5) // ws
    order = np.argsort(dev, kind="stable")
    p, r, dev = p[order], r[order], dev[order]
    offs = np.searchsorted(dev, np.arange(d + 1))
    m = int(np.diff(offs).max()) if d else 0
    m = max(8, -(-m // 8) * 8)
    rows = np.zeros((d, m), np.int32)
    lrank = np.zeros((d, m), np.int32)  # bit index local to the shard
    valid = np.zeros((d, m), bool)
    for b in range(d):
        lo, hi = offs[b], offs[b + 1]
        rows[b, : hi - lo] = p[lo:hi]
        lrank[b, : hi - lo] = r[lo:hi] - b * ws * 32
        valid[b, : hi - lo] = True
    spec = P("k", None)
    rows_s = jax.device_put(rows, NamedSharding(mesh, spec))
    lrank_s = jax.device_put(lrank, NamedSharding(mesh, spec))
    valid_s = jax.device_put(valid, NamedSharding(mesh, spec))

    def build(rows_l, lrank_l, valid_l):
        lane = jnp.arange(rows_l.shape[1], dtype=jnp.int32)
        flat = jnp.where(
            valid_l[0], rows_l[0] * ws + (lrank_l[0] >> 5),
            n_pad * ws + lane,
        )
        bit = jnp.where(
            valid_l[0],
            jnp.uint32(1) << (lrank_l[0] & 31).astype(jnp.uint32),
            jnp.uint32(0),
        )
        words = jnp.zeros(n_pad * ws, jnp.uint32).at[flat].add(
            bit, mode="drop"
        )
        return words.reshape(n_pad, ws)

    words_s = jax.jit(
        shard_map(
            build,
            mesh=mesh,
            in_specs=(spec, spec, spec),
            out_specs=P(None, "k"),
        )
    )(rows_s, lrank_s, valid_s)
    cls = np.asarray(classes, np.int32)
    if cls.shape[0] < n_pad:
        cls = np.concatenate(
            [cls, np.full(n_pad - cls.shape[0], -1, np.int32)]
        )
    classes_s = jax.device_put(
        cls[:n_pad], NamedSharding(mesh, P(None))
    )
    return words_s, classes_s


def _stage_inputs(mesh, words, classes, weights, row_spec, cls_spec):
    """device_put the sweep inputs with the mesh's shardings; default the
    weights to ones (unweighted) — shared by all three sharded wrappers."""
    words_s = jax.device_put(
        jnp.asarray(words), NamedSharding(mesh, row_spec)
    )
    classes_s = jax.device_put(
        jnp.asarray(classes, jnp.int32), NamedSharding(mesh, cls_spec)
    )
    weighted = weights is not None
    if weights is None:
        weights = np.ones(words.shape[1] * 32, np.int8)
    weights_s = jax.device_put(
        jnp.asarray(weights, jnp.int8), NamedSharding(mesh, P(None))
    )
    return words_s, classes_s, weights_s, weighted


def _stage_inputs_kaxis(mesh, words, classes, weights, axis, block_tile):
    """device_put the sweep inputs in the contraction-sharded layout:
    bitset column-sharded over `axis`, classes replicated, weights
    sharded over the k axis (column slices, unlike the rings) — shared
    by every k-axis wrapper."""
    d_count = int(mesh.devices.size)
    n_pad, w_words = words.shape
    assert n_pad % block_tile == 0, (n_pad, block_tile)
    assert w_words % d_count == 0, (
        f"W={w_words} packed words must divide over {d_count} devices"
    )
    words_s = jax.device_put(
        jnp.asarray(words), NamedSharding(mesh, P(None, axis))
    )
    classes_s = jax.device_put(
        jnp.asarray(classes, jnp.int32), NamedSharding(mesh, P(None))
    )
    weighted = weights is not None
    if weights is None:
        weights = np.ones(w_words * 32, np.int8)
    weights_s = jax.device_put(
        jnp.asarray(weights, jnp.int8), NamedSharding(mesh, P(axis))
    )
    return words_s, classes_s, weights_s, weighted


@jax.jit
def _sort_pair_buffers(bi, bj, bc, total):
    """Device-side pair finalize for the compacted [cap] buffers: mask
    the unoccupied tail to the shared sentinels, then delegate to the
    single-chip finalize (similarity.pairwise._sort_pairs) — ONE
    implementation of the sentinel convention and the
    sort-by-(i,j)+stack epilogue keeps the sharded and single-chip
    extractors' bit-identity invariant in one place."""
    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        _IMAX,
        _sort_pairs,
    )

    m = jnp.arange(bi.shape[0], dtype=jnp.int32) >= total[0]
    return _sort_pairs(
        jnp.where(m, _IMAX, bi),
        jnp.where(m, _IMAX, bj),
        jnp.where(m, -1, bc),
    )


def _pairs_from_buffers(arr, m, cap, expected_total=None):
    """Shared compacted-buffer epilogue: overflow/shortfall checks + a
    zero-copy view of the device-sorted pair prefix."""
    if m > cap:
        raise ValueError(
            f"sharded extraction overflow: {m} pairs > cap={cap}; "
            f"re-run with a larger cap"
        )
    if expected_total is not None and m != expected_total:
        raise ValueError(
            f"sharded extraction found {m} pairs, sweep stats promised "
            f"{expected_total} (tile_cap too small?)"
        )
    return arr[:m]


@functools.lru_cache(maxsize=None)
def _replicate_jit(mesh):
    # memoized: a fresh jit identity per call would retrace+recompile
    # the reshard program every sweep
    return jax.jit(
        lambda x: x, out_shardings=NamedSharding(mesh, P(None, None))
    )


def _replicate_row_stats(mesh, row_stats):
    """Multi-host: row_stats may be row-sharded across processes —
    replicate via one all-gather (rides DCN once, SURVEY.md §5) before
    fetching, since device_get cannot read non-addressable shards."""
    if jax.process_count() > 1:
        row_stats = _replicate_jit(mesh)(row_stats)
    return row_stats


def _convert_sweep_host(row_stats, hits, n_pad, block_tile):
    """Host-side conversion of fetched sweep outputs to the single-chip
    engine format."""
    row_stats = row_stats.astype(np.int64)

    from uniprot_kmer_based_clustering_tpu.ops.popcount import (
        upper_triangle_tiles,
    )

    ti, tj = upper_triangle_tiles(n_pad, block_tile)
    # Ring steps may attribute an unordered block pair to either
    # orientation; fold both into the upper-triangle enumeration (the
    # k-axis sweep fills only the upper triangle, so the fold adds 0).
    tile_hits = hits[ti, tj] + np.where(
        (ti != tj)[:, None], hits[tj, ti], 0
    )
    return row_stats, tile_hits, (ti, tj, block_tile)


def _finalize_sweep(mesh, row_stats, hits, n_pad, block_tile):
    """Fetch + convert a sharded sweep's outputs to the single-chip
    engine format (one device_get)."""
    row_stats = _replicate_row_stats(mesh, row_stats)
    row_stats, hits = jax.device_get((row_stats, hits))
    return _convert_sweep_host(row_stats, hits, n_pad, block_tile)


# memoized: each maker returns a fresh jitted closure, and jax's jit
# cache is keyed on function identity — without memoization EVERY
# wrapper call would retrace + recompile. Mesh objects hash stably.
@functools.lru_cache(maxsize=64)
def make_ring_sweep(
    mesh: Mesh,
    n: int,
    threshold: int,
    block_tile: int,
    axis: str = "p",
    weighted: bool = False,
    stats_engine: str = "auto",
):
    """Build the jitted ring-sweep step for a given mesh.

    Returns a function (words_sharded [N_pad, W] uint32, classes_sharded
    [N_pad] int32) → (row_stats [N_pad, 8] row-sharded,
    block_hits [nb, nb, 2] replicated) where nb = N_pad // block_tile.

    `stats_engine`: "auto" (= "xla_tiled_barrier") or "xla", the flat
    mask/reduce chain (see _resolve_stats_engine).
    """
    d_count = mesh.shape[axis]
    stats_engine = _resolve_stats_engine(stats_engine)

    def step(words_local, classes_local, weights):
        dev = jax.lax.axis_index(axis)
        block = words_local.shape[0]
        nb_local = block // block_tile
        nb = nb_local * d_count
        row_base = dev * block

        row_stats = jnp.zeros((block, 8), jnp.int32)
        hits = jnp.zeros((nb, nb, 2), jnp.int32)

        moving_w = words_local
        moving_c = classes_local
        n_steps = d_count // 2 + 1

        for s in range(n_steps):
            if s > 0:
                perm = [((i + 1) % d_count, i) for i in range(d_count)]
                moving_w = jax.lax.ppermute(moving_w, axis, perm)
                moving_c = jax.lax.ppermute(moving_c, axis, perm)
            moving_base = ((dev + s) % d_count) * block

            # XLA path: the no-wasted-MACs sub-block schedule (triangular
            # diagonal strips; even-D final-step split across the pair)
            for (wa, wb, ca, cb, gi, gj, i_off, ti0, tj0, triangle,
                 active) in _ring_substeps(
                s, d_count, dev, words_local, moving_w,
                classes_local, moving_c, row_base, moving_base,
                block_tile,
            ):
                counts = _block_counts(
                    wa, wb, weights if weighted else None
                )
                stats, bh = _step_stats_xla(
                    counts, gi, gj, ca, cb, n, threshold, active,
                    triangle, block_tile, stats_engine,
                )
                row_stats = _merge_row_stats_at(row_stats, stats, i_off)
                hits = _accumulate_hits_at(hits, bh, ti0, tj0)

        hits = jax.lax.psum(hits, axis)
        return row_stats, hits

    sharded = shard_map(
        step,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(None)),
        out_specs=(P(axis, None), P(None, None, None)),
    )
    return jax.jit(sharded)


def sharded_pairwise_similarity(
    mesh: Mesh,
    words: np.ndarray,
    classes: np.ndarray,
    n: int,
    threshold: int,
    block_tile: int = 128,
    axis: str = "p",
    weights: np.ndarray | None = None,
    stats_engine: str = "auto",
):
    """Run the ring sweep on a mesh; returns (row_stats np[N_pad, 8] int64,
    tile_hits np[nT, 2], tiles) in the single-chip engine format."""
    d_count = mesh.shape[axis]
    n_pad, w_words = words.shape
    assert n_pad % (d_count * block_tile) == 0, (
        f"N_pad={n_pad} must be divisible by devices×block_tile="
        f"{d_count * block_tile}"
    )
    words_s, classes_s, weights_s, weighted = _stage_inputs(
        mesh, words, classes, weights, P(axis, None), P(axis)
    )
    fn = make_ring_sweep(
        mesh, n, threshold, block_tile, axis, weighted, stats_engine
    )
    row_stats, hits = fn(words_s, classes_s, weights_s)
    return _finalize_sweep(mesh, row_stats, hits, n_pad, block_tile)


def _diag_strip_bounds(nbl: int, max_strips: int = 8):
    """Static tile-aligned strip row bounds for the triangular diagonal
    step: ~``max_strips`` equal strips over ``nbl`` tiles (the last may
    be short). Returns [(tile_lo, tile_hi), ...]."""
    per = -(-nbl // max_strips)
    return [(r, min(nbl, r + per)) for r in range(0, nbl, per)]


def _merge_row_stats_at(row_stats, stats, i_off):
    """Merge a sub-block's [rows, 8] stats into the device-local
    accumulator at (possibly traced) row offset ``i_off``
    (ops.bitmul.merge_row_stats_at — the single merge rule)."""
    return merge_row_stats_at(row_stats, stats, i_off)


def _accumulate_hits_at(hits, bh, ti0, tj0):
    """Add a sub-block's [nbi, nbj, 2] tile hits into the global hits
    matrix at (possibly traced) tile offsets."""
    nbi, nbj = bh.shape[0], bh.shape[1]
    prev = jax.lax.dynamic_slice(hits, (ti0, tj0, 0), (nbi, nbj, 2))
    return jax.lax.dynamic_update_slice(hits, prev + bh, (ti0, tj0, 0))


def _ring_substeps(
    s: int,
    d_count: int,
    dev,
    words_local,
    moving_w,
    classes_local,
    moving_c,
    row_base,
    moving_base,
    block_tile: int,
    max_strips: int = 8,
):
    """Sub-block computations for flat-ring rotation step ``s`` — THE
    single implementation of exact pair coverage for the XLA path,
    shared by the plain, extract, and fused ring makers so a schedule
    fix cannot drift. Yields tuples

        (wa, wb, ca, cb, gi, gj, i_off, ti0, tj0, triangle, active)

    where ``wa @ wbᵀ`` is the sub-block's counts matmul, ``gi``/``gj``
    its global pair indices, ``i_off`` the device-local row offset of
    its row stats, and ``(ti0, tj0)`` its global ``block_tile`` offsets
    in the hits matrix (offsets may be traced — they depend on the
    device index at the even-D final step).

    Unlike a masked full-square schedule, no MACs are wasted:

      * step 0 (the diagonal) runs tile-aligned row strips against
        their column suffix — (ns+1)/(2·ns) of the block square's MACs
        instead of computing the full square and masking half (the
        single-chip strip schedule's trick, ``ops.bitmul.auto_strip``);
      * the even-D final step — where each unordered block pair {d, e}
        appears on BOTH devices — splits the pair region between them
        instead of idling half the ring: device d (first half) covers
        rows d[0:h) of the region via two [h, h] matmuls, device e
        covers rows d[h:2h) in the transposed orientation (its own
        stationary rows credit the stats, the hits fold in
        ``_convert_sweep_host`` handles either orientation). All
        devices run the same program shapes — only the slice OFFSETS
        are device-dependent (traced), which SPMD allows.

    Coverage is exact and disjoint for every D (pinned against the
    single-chip oracle for D ∈ {1..8} in tests/test_sharded.py).
    """
    if s == 0:
        yield from _substeps_diag(
            words_local, classes_local, row_base, block_tile, max_strips
        )
    elif 2 * s == d_count:
        yield from _substeps_split(
            dev < (d_count // 2), words_local, moving_w,
            classes_local, moving_c, row_base, moving_base, block_tile,
        )
    else:
        yield _substep_full(
            words_local, moving_w, classes_local, moving_c,
            row_base, moving_base, block_tile,
        )


def _ring_substeps_2d(
    sh: int,
    sc: int,
    hc: int,
    cc: int,
    h,
    c,
    words_local,
    inner_w,
    classes_local,
    inner_c,
    row_base,
    moving_base,
    block_tile: int,
    max_strips: int = 8,
):
    """:func:`_ring_substeps` for the hierarchical 2-D (hosts × chips)
    schedule — the same three sub-step shapes dispatched on the 2-D
    dedup cases:

      * (sh=0, sc=0): the within-block diagonal → triangular strips;
      * (sh=0, 2·sc=cc): even-C intra-host final step — the block pair
        {(h,c), (h,c+C/2)} appears on both chips → split on c < C/2;
      * (2·sh=hc): even-H final outer step — every inner step's block
        pair appears on both hosts of a host pair (the partner sees the
        transposed orientation at its inner step −sc mod C) → split on
        h < H/2, for ALL C inner steps;
      * otherwise: one full block pair.
    """
    if sh == 0 and sc == 0:
        yield from _substeps_diag(
            words_local, classes_local, row_base, block_tile, max_strips
        )
    elif sh == 0 and 2 * sc == cc:
        yield from _substeps_split(
            c < (cc // 2), words_local, inner_w,
            classes_local, inner_c, row_base, moving_base, block_tile,
        )
    elif 2 * sh == hc:
        yield from _substeps_split(
            h < (hc // 2), words_local, inner_w,
            classes_local, inner_c, row_base, moving_base, block_tile,
        )
    else:
        yield _substep_full(
            words_local, inner_w, classes_local, inner_c,
            row_base, moving_base, block_tile,
        )


def _iota_pair(rows, cols, gi0, gj0):
    gi = gi0 + jax.lax.broadcasted_iota(jnp.int32, (rows, cols), 0)
    gj = gj0 + jax.lax.broadcasted_iota(jnp.int32, (rows, cols), 1)
    return gi, gj


def _substeps_diag(words_local, classes_local, row_base, block_tile,
                   max_strips=8):
    """Triangular diagonal: tile-aligned row strips vs their column
    suffix ((ns+1)/2ns of the block square's MACs)."""
    block = words_local.shape[0]
    nbl = block // block_tile
    for t0, t1 in _diag_strip_bounds(nbl, max_strips):
        r0, r1 = t0 * block_tile, t1 * block_tile
        gi, gj = _iota_pair(r1 - r0, block - r0, row_base + r0,
                            row_base + r0)
        yield (
            words_local[r0:r1], words_local[r0:],
            classes_local[r0:r1], classes_local[r0:],
            gi, gj, r0,
            row_base // block_tile + t0,
            row_base // block_tile + t0,
            True, True,
        )


def _substep_full(words_local, moving_w, classes_local, moving_c,
                  row_base, moving_base, block_tile, active=True):
    """One full (stationary × moving) block pair."""
    block = words_local.shape[0]
    gi, gj = _iota_pair(block, block, row_base, moving_base)
    return (
        words_local, moving_w, classes_local, moving_c, gi, gj, 0,
        row_base // block_tile, moving_base // block_tile, False, active,
    )


def _substeps_split(first, words_local, moving_w, classes_local,
                    moving_c, row_base, moving_base, block_tile):
    """Final-step split: the unordered block pair {d, e} appears on two
    devices; ``first`` is True on the device whose stationary block is
    d. The first device covers rows d[0:h) of the pair region, the
    partner covers rows d[h:2h) in the transposed orientation (its own
    stationary rows credit the stats) — two [h, h] matmuls each, only
    the slice OFFSETS device-dependent (SPMD-compatible):

        m1: stat[0:h) × mov[b1:b1+h),  b1 = first ? 0 : h
        m2: stat[a2:a2+h) × mov[h:2h), a2 = first ? 0 : h

    Falls back to the masked half-gate (full block square, partner
    idle) when the block cannot split on a tile boundary.
    """
    block = words_local.shape[0]
    w_words = words_local.shape[1]
    h = block // 2
    if h % block_tile != 0:
        yield _substep_full(
            words_local, moving_w, classes_local, moving_c,
            row_base, moving_base, block_tile, active=first,
        )
        return
    hb = h // block_tile
    b1 = jnp.where(first, 0, h)
    b1t = jnp.where(first, 0, hb)
    a2 = jnp.where(first, 0, h)
    a2t = jnp.where(first, 0, hb)
    wb1 = jax.lax.dynamic_slice(moving_w, (b1, 0), (h, w_words))
    cb1 = jax.lax.dynamic_slice(moving_c, (b1,), (h,))
    gi1, gj1 = _iota_pair(h, h, row_base, moving_base + b1)
    yield (
        words_local[:h], wb1, classes_local[:h], cb1, gi1, gj1, 0,
        row_base // block_tile, moving_base // block_tile + b1t,
        False, True,
    )
    wa2 = jax.lax.dynamic_slice(words_local, (a2, 0), (h, w_words))
    ca2 = jax.lax.dynamic_slice(classes_local, (a2,), (h,))
    gi2, gj2 = _iota_pair(h, h, row_base + a2, moving_base + h)
    yield (
        wa2, moving_w[h:], ca2, moving_c[h:], gi2, gj2, a2,
        row_base // block_tile + a2t,
        moving_base // block_tile + hb,
        False, True,
    )


def _compact_step(mask, counts, gi, gj, block_tile, k, carry, cap):
    """Compact one ring step's survivors into the carried (cursor, bi,
    bj, bc) buffers, canonicalized to (min, max).

    With ``k > 0`` the candidates are first selected per block_tile
    sub-tile with batched ``top_k`` (`k` must be ≥ the densest
    sub-tile's hit count, known exactly from the sweep's tile_hits). A sub-tile
    whose survivor count exceeds ``k`` is dropped ENTIRELY — never
    silently top_k-truncated — so an undersized k shows up as a cursor
    shortfall the wrappers can detect against the exact tile hits
    (callers passing the fused pre-masked survivors already satisfy
    sub_hits ≤ k, making the guard free there). ``k == 0`` scatters the
    full mask (CPU tests; platforms with fast scatter).
    """
    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        compact_positions,
        subtile_rows,
    )

    cursor, bi, bj, bc = carry
    if k > 0:
        bt = block_tile
        rows_mask = subtile_rows(mask.astype(jnp.int32), bt)
        vals, sel = jax.lax.top_k(rows_mask, k)
        cnt = jnp.take_along_axis(subtile_rows(counts, bt), sel, 1).ravel()
        gi_c = jnp.take_along_axis(subtile_rows(gi, bt), sel, 1).ravel()
        gj_c = jnp.take_along_axis(subtile_rows(gj, bt), sel, 1).ravel()
        ok = rows_mask.sum(axis=1, keepdims=True) <= k
        hit = ((vals > 0) & ok).ravel()
    else:
        hit = mask.ravel()
        gi_c = gi.ravel()
        gj_c = gj.ravel()
        cnt = counts.ravel()
    pos, kept = compact_positions(hit, cap, cursor)
    opts = dict(mode="drop", unique_indices=True)
    bi = bi.at[pos].set(jnp.minimum(gi_c, gj_c), **opts)
    bj = bj.at[pos].set(jnp.maximum(gi_c, gj_c), **opts)
    bc = bc.at[pos].set(cnt, **opts)
    return cursor + kept, bi, bj, bc


# memoized: each maker returns a fresh jitted closure, and jax's jit
# cache is keyed on function identity — without memoization EVERY
# wrapper call would retrace + recompile. Mesh objects hash stably.
@functools.lru_cache(maxsize=64)
def make_ring_extract(
    mesh: Mesh,
    n: int,
    threshold: int,
    cap: int,
    axis: str = "p",
    weighted: bool = False,
    cross_amr_only: bool = True,
    block_tile: int = 128,
    k: int = 0,
):
    """Jitted ring-extraction step: exact surviving pairs, mesh-parallel.

    Same ppermute schedule and dedup gates as :func:`make_ring_sweep`,
    but instead of statistics each device compacts its block pairs'
    survivors (canonicalized to i < j) into a `cap` local buffer — so
    extraction never needs the full bitset matrix on one device (the
    single-chip :func:`similarity.pairwise.extract_pairs` replicates it,
    which cannot work once the row-sharded matrix outgrows one HBM).
    A final collective (:func:`_gather_compacted`) concatenates the
    occupied prefixes into one replicated buffer, so `cap` bounds the
    GLOBAL survivor total and the host fetch is ~12 B/pair. Returns
    replicated (gi [cap], gj [cap], cnt [cap], total [1]); a total past
    `cap` means overflow (surplus pairs dropped) — the wrapper raises.
    """
    d_count = mesh.shape[axis]

    def step(words_local, classes_local, weights):
        dev = jax.lax.axis_index(axis)
        block = words_local.shape[0]
        row_base = dev * block

        bi = jnp.zeros(cap, jnp.int32)
        bj = jnp.zeros(cap, jnp.int32)
        bc = jnp.zeros(cap, jnp.int32)
        cursor = jnp.int32(0)

        moving_w = words_local
        moving_c = classes_local
        n_steps = d_count // 2 + 1
        for s in range(n_steps):
            if s > 0:
                perm = [((i + 1) % d_count, i) for i in range(d_count)]
                moving_w = jax.lax.ppermute(moving_w, axis, perm)
                moving_c = jax.lax.ppermute(moving_c, axis, perm)
            moving_base = ((dev + s) % d_count) * block
            for (wa, wb, ca, cb, gi, gj, _i_off, _ti0, _tj0, triangle,
                 active) in _ring_substeps(
                s, d_count, dev, words_local, moving_w,
                classes_local, moving_c, row_base, moving_base,
                block_tile,
            ):
                counts = _block_counts(
                    wa, wb, weights if weighted else None
                )
                valid = (gi < n) & (gj < n) & active
                if triangle:
                    valid &= gi < gj
                mask = valid & (counts > threshold)
                if cross_amr_only:
                    mask &= ca[:, None] != cb[None, :]
                # off-diagonal sub-blocks see each unordered pair in ONE
                # arbitrary orientation — _compact_step canonicalizes to
                # (min, max)
                cursor, bi, bj, bc = _compact_step(
                    mask, counts, gi, gj, block_tile, k,
                    (cursor, bi, bj, bc), cap,
                )
        return _gather_compacted(bi, bj, bc, cursor, dev, d_count, cap, axis)

    sharded = shard_map(
        step,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(None)),
        out_specs=tuple(P(None) for _ in range(4)),
    )
    return jax.jit(sharded)


def _gather_compacted(bi, bj, bc, cursor, dev, d_count, cap, axis):
    """Concatenate every device's occupied buffer prefix into ONE
    replicated [cap] buffer (offsets from the cursor all-gather; each
    device scatters its prefix into a disjoint region, merged by psum) —
    so the host fetches ~12 bytes per surviving pair instead of
    D × cap × 12. With this collective the
    `cap` bound is on the GLOBAL survivor total, not per device.
    Returns (bi, bj, bc [cap] replicated, total [1])."""
    all_c = jax.lax.all_gather(cursor, axis)  # [D], device-major order
    offset = jnp.sum(
        jnp.where(jnp.arange(d_count, dtype=jnp.int32) < dev, all_c, 0)
    )
    slot = jnp.arange(cap, dtype=jnp.int32)
    pos = jnp.where(slot < cursor, offset + slot, cap + slot)
    opts = dict(mode="drop", unique_indices=True)
    obi = jnp.zeros(cap, jnp.int32).at[pos].set(bi, **opts)
    obj = jnp.zeros(cap, jnp.int32).at[pos].set(bj, **opts)
    obc = jnp.zeros(cap, jnp.int32).at[pos].set(bc, **opts)
    return (
        jax.lax.psum(obi, axis),
        jax.lax.psum(obj, axis),
        jax.lax.psum(obc, axis),
        # == sum(all_c); psum so shard_map can INFER the replication
        jax.lax.psum(cursor, axis)[None],
    )


def sharded_extract_pairs(
    mesh: Mesh,
    words: np.ndarray,
    classes: np.ndarray,
    n: int,
    threshold: int,
    block_tile: int = 128,
    axis: str = "p",
    weights: np.ndarray | None = None,
    cross_amr_only: bool = True,
    cap: int = 1 << 20,
    tile_cap: int | None = None,
    expected_total: int | None = None,
):
    """Mesh-parallel exact pair extraction (the ring schedule, one pass).

    `expected_total`: the exact global survivor count (the sweep's
    tile_hits sum). When given, a result of any other size raises —
    in particular the shortfall produced by an undersized `tile_cap`
    (over-capacity sub-tiles are dropped whole, never truncated).

    Bit-identical (after the canonical (i, j) sort) to the single-chip
    :func:`similarity.pairwise.extract_pairs` for every device count,
    without ever replicating the bitset matrix — each device recomputes
    only its own ring block pairs. `cap` bounds the GLOBAL surviving
    pair count (the sweep's tile_hits give it exactly); overflow raises
    so the caller can re-run with a bigger cap. A 2-axis (hosts ×
    chips) mesh runs the hierarchical 2-D schedule (one DCN hop per
    outer step); `axis` is ignored there.

    `tile_cap`: the maximum survivor count of any single block_tile²
    tile (exactly known from the sweep's tile_hits). When given, each
    step compacts via per-sub-tile batched ``top_k`` instead of a
    full-mask scatter. None keeps the scatter path
    (:func:`similarity.pairwise.topk_tile_cap` makes the choice).
    """
    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        bucket_pow2,
    )

    k = 0
    if tile_cap is not None:
        k = bucket_pow2(tile_cap, 128, block_tile * block_tile)
    two_d = len(mesh.axis_names) == 2
    d_count = int(mesh.devices.size)
    n_pad = words.shape[0]
    if not two_d and mesh.axis_names[0] == "k":
        # contraction-axis layout (same convention as the pipeline): the
        # bitset stays column-sharded, the compaction is replicated
        words_s, classes_s, weights_s, weighted = _stage_inputs_kaxis(
            mesh, words, classes, weights, "k", block_tile
        )
        fn = make_kaxis_extract(
            mesh, n, threshold, cap, block_tile, "k", weighted,
            cross_amr_only, k=k,
        )
        bi, bj, bc, cursor = fn(words_s, classes_s, weights_s)
        arr, m = jax.device_get(
            (_sort_pair_buffers(bi, bj, bc, cursor), cursor)
        )
        return _pairs_from_buffers(arr, int(m[0]), cap, expected_total)
    assert n_pad % (d_count * block_tile) == 0, (
        f"N_pad={n_pad} must be divisible by devices×block_tile="
        f"{d_count * block_tile}"
    )
    if two_d:
        h_ax, c_ax = mesh.axis_names
        row_spec, cls_spec = P((h_ax, c_ax), None), P((h_ax, c_ax))
    else:
        row_spec, cls_spec = P(axis, None), P(axis)
    words_s, classes_s, weights_s, weighted = _stage_inputs(
        mesh, words, classes, weights, row_spec, cls_spec
    )
    if two_d:
        fn = make_ring_extract_2d(
            mesh, n, threshold, cap, h_ax, c_ax, weighted, cross_amr_only,
            block_tile=block_tile, k=k,
        )
    else:
        fn = make_ring_extract(
            mesh, n, threshold, cap, axis, weighted, cross_amr_only,
            block_tile=block_tile, k=k,
        )
    # outputs are replicated (the in-program cursor all-gather + disjoint
    # scatter + psum concatenates every device's occupied prefix), so the
    # fetch is ~12 bytes per surviving pair — multi-process included
    bi, bj, bc, total = fn(words_s, classes_s, weights_s)
    arr, m = jax.device_get(
        (_sort_pair_buffers(bi, bj, bc, total), total)
    )
    return _pairs_from_buffers(arr, int(m[0]), cap, expected_total)


# memoized: each maker returns a fresh jitted closure, and jax's jit
# cache is keyed on function identity — without memoization EVERY
# wrapper call would retrace + recompile. Mesh objects hash stably.
@functools.lru_cache(maxsize=64)
def make_ring_fused(
    mesh: Mesh,
    n: int,
    threshold: int,
    cap: int,
    axis: str = "p",
    weighted: bool = False,
    cross_amr_only: bool = True,
    block_tile: int = 128,
    k: int = 0,
):
    """Jitted FUSED ring step: statistics AND compacted survivors in one
    pass over the block-pair space.

    The separate :func:`make_ring_extract` re-runs every ring step's
    matmul a second time after the stats sweep — a full O(N²/D) recompute
    whenever the pipeline wants pairs. This step reuses each block pair's
    counts for both outputs (the over-threshold masks are the extraction
    masks, ``stack_row_stats``), halving the distributed sweep+extract
    matmul and ppermute cost — the mesh analogue of the single-chip
    fused scan sweep (``ops.bitmul._scan_sweep`` fused_k).

    Exactness never depends on the capacity guesses: with ``k > 0`` any
    block_tile² sub-tile whose survivor count exceeds ``k`` is dropped
    from the compaction ENTIRELY (never silently truncated by top_k);
    the pass's own exact tile hits let the wrapper detect those tiles —
    and `cap` overflow — and fall back to the two-pass machinery.

    Returns (row_stats [N_pad, 8] row-sharded, block_hits [nb, nb, 2]
    replicated, gi/gj/cnt [cap] + kept [1] replicated). ``kept`` counts
    only the compacted survivors; the wrapper compares it against the
    tile-hit total to decide completeness.
    """
    d_count = mesh.shape[axis]

    def step(words_local, classes_local, weights):
        dev = jax.lax.axis_index(axis)
        block = words_local.shape[0]
        nb_local = block // block_tile
        nb = nb_local * d_count
        row_base = dev * block

        row_stats = jnp.zeros((block, 8), jnp.int32)
        hits = jnp.zeros((nb, nb, 2), jnp.int32)
        bi = jnp.zeros(cap, jnp.int32)
        bj = jnp.zeros(cap, jnp.int32)
        bc = jnp.zeros(cap, jnp.int32)
        cursor = jnp.int32(0)

        moving_w = words_local
        moving_c = classes_local
        n_steps = d_count // 2 + 1
        for s in range(n_steps):
            if s > 0:
                perm = [((i + 1) % d_count, i) for i in range(d_count)]
                moving_w = jax.lax.ppermute(moving_w, axis, perm)
                moving_c = jax.lax.ppermute(moving_c, axis, perm)
            moving_base = ((dev + s) % d_count) * block
            for (wa, wb, ca, cb, gi, gj, i_off, ti0, tj0, triangle,
                 active) in _ring_substeps(
                s, d_count, dev, words_local, moving_w,
                classes_local, moving_c, row_base, moving_base,
                block_tile,
            ):
                counts = _block_counts(
                    wa, wb, weights if weighted else None
                )
                stats, over_c, over_s = _pair_stats(
                    counts, gi, gj, ca, cb, n, threshold, active,
                    triangle,
                )
                row_stats = _merge_row_stats_at(row_stats, stats, i_off)
                bh, mask = _fused_subtiles(
                    over_c, over_s, block_tile, k, cross_amr_only
                )
                hits = _accumulate_hits_at(hits, bh, ti0, tj0)
                cursor, bi, bj, bc = _compact_step(
                    mask, counts, gi, gj, block_tile, k,
                    (cursor, bi, bj, bc), cap,
                )

        hits = jax.lax.psum(hits, axis)
        gathered = _gather_compacted(
            bi, bj, bc, cursor, dev, d_count, cap, axis
        )
        return (row_stats, hits) + gathered

    sharded = shard_map(
        step,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(None)),
        out_specs=(P(axis, None), P(None, None, None))
        + tuple(P(None) for _ in range(4)),
    )
    return jax.jit(sharded)


def sharded_pairwise_fused(
    mesh: Mesh,
    words: np.ndarray,
    classes: np.ndarray,
    n: int,
    threshold: int,
    block_tile: int = 128,
    axis: str = "p",
    weights: np.ndarray | None = None,
    cross_amr_only: bool = True,
    cap: int = 1 << 20,
    k: int | None = None,
):
    """One fused pass → (row_stats, tile_hits, tiles, pairs) — on any of
    the three sharding layouts (flat ring, hierarchical 2-D ring when the
    mesh has two axes, or contraction-axis when its only axis is "k").

    Statistics format matches :func:`sharded_pairwise_similarity`; the
    pair list is bit-identical to :func:`sharded_extract_pairs` (and so
    to the single-chip extractor) for every device count. When the
    capacity guesses don't hold — a sub-tile over ``k`` survivors, or
    more than ``cap`` total — the stats stay valid and extraction
    re-runs through :func:`sharded_extract_pairs` sized exactly from the
    now-known tile hits (cost = the status-quo two-pass; the fused win
    applies whenever the guesses hold). ``k`` (per-sub-tile top_k
    selection) defaults to :data:`FUSED_TOPK_DEFAULT`; 0 selects the
    scatter compaction (no per-sub-tile bound — only ``cap`` can
    overflow).
    """
    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        FUSED_TOPK_DEFAULT,
        topk_tile_cap,
    )

    two_d = len(mesh.axis_names) == 2
    kaxis = not two_d and mesh.axis_names[0] == "k"
    d_count = int(mesh.devices.size)
    n_pad = words.shape[0]
    if k is None:
        k = FUSED_TOPK_DEFAULT
    k = min(k, block_tile * block_tile)
    if kaxis:
        words_s, classes_s, weights_s, weighted = _stage_inputs_kaxis(
            mesh, words, classes, weights, "k", block_tile
        )
        fn = make_kaxis_fused(
            mesh, n, threshold, cap, block_tile, "k", weighted,
            cross_amr_only, k=k,
        )
    else:
        assert n_pad % (d_count * block_tile) == 0, (
            f"N_pad={n_pad} must be divisible by devices×block_tile="
            f"{d_count * block_tile}"
        )
        if two_d:
            h_ax, c_ax = mesh.axis_names
            row_spec, cls_spec = P((h_ax, c_ax), None), P((h_ax, c_ax))
        else:
            row_spec, cls_spec = P(axis, None), P(axis)
        words_s, classes_s, weights_s, weighted = _stage_inputs(
            mesh, words, classes, weights, row_spec, cls_spec
        )
        if two_d:
            fn = make_ring_fused_2d(
                mesh, n, threshold, cap, h_ax, c_ax, weighted,
                cross_amr_only, block_tile=block_tile, k=k,
            )
        else:
            fn = make_ring_fused(
                mesh, n, threshold, cap, axis, weighted, cross_amr_only,
                block_tile=block_tile, k=k,
            )
    row_stats, hits, bi, bj, bc, kept = fn(words_s, classes_s, weights_s)
    # sort/stack the candidate buffers on device (~0.13 s) so the happy
    # path needs no host epilogue, then ONE batched fetch for every
    # output of the already-dispatched pass
    arr = _sort_pair_buffers(bi, bj, bc, kept)
    row_stats = _replicate_row_stats(mesh, row_stats)
    row_stats, hits, arr, kept = jax.device_get(
        (row_stats, hits, arr, kept)
    )
    row_stats, tile_hits, tiles = _convert_sweep_host(
        row_stats, hits, n_pad, block_tile
    )

    per_tile = tile_hits[:, 0].astype(np.int64)
    if not cross_amr_only:
        per_tile = per_tile + tile_hits[:, 1]
    total = int(per_tile.sum())
    m = int(kept[0])
    if m == total and m <= cap:
        return row_stats, tile_hits, tiles, arr[:m]
    # capacity guess missed (dropped sub-tiles or cap overflow): redo
    # extraction exactly, sized from the now-known tile hits
    pairs = sharded_extract_pairs(
        mesh, words, classes, n, threshold,
        block_tile=block_tile, axis=axis, weights=weights,
        cross_amr_only=cross_amr_only,
        cap=max(1 << 18, total),
        tile_cap=topk_tile_cap(per_tile),
        expected_total=total,
    )
    return row_stats, tile_hits, tiles, pairs


# memoized: each maker returns a fresh jitted closure, and jax's jit
# cache is keyed on function identity — without memoization EVERY
# wrapper call would retrace + recompile. Mesh objects hash stably.
@functools.lru_cache(maxsize=64)
def make_ring_extract_2d(
    mesh: Mesh,
    n: int,
    threshold: int,
    cap: int,
    host_axis: str = "h",
    chip_axis: str = "c",
    weighted: bool = False,
    cross_amr_only: bool = True,
    block_tile: int = 128,
    k: int = 0,
):
    """:func:`make_ring_extract` on the hierarchical 2-D schedule — the
    same outer(host)/inner(chip) rotations and dedup gates as
    :func:`make_ring_sweep_2d`, compacting survivors instead of stats."""
    hc = mesh.shape[host_axis]
    cc = mesh.shape[chip_axis]

    def step(words_local, classes_local, weights):
        h = jax.lax.axis_index(host_axis)
        c = jax.lax.axis_index(chip_axis)
        block = words_local.shape[0]
        row_base = (h * cc + c) * block

        bi = jnp.zeros(cap, jnp.int32)
        bj = jnp.zeros(cap, jnp.int32)
        bc = jnp.zeros(cap, jnp.int32)
        cursor = jnp.int32(0)

        moving_w = words_local
        moving_c = classes_local
        outer_steps = hc // 2 + 1
        for sh in range(outer_steps):
            if sh > 0:
                perm_h = [((i + 1) % hc, i) for i in range(hc)]
                moving_w = jax.lax.ppermute(moving_w, host_axis, perm_h)
                moving_c = jax.lax.ppermute(moving_c, host_axis, perm_h)
            inner_w = moving_w
            inner_c = moving_c
            inner_steps = cc if sh > 0 else (cc // 2 + 1)
            for sc in range(inner_steps):
                if sc > 0:
                    perm_c = [((i + 1) % cc, i) for i in range(cc)]
                    inner_w = jax.lax.ppermute(inner_w, chip_axis, perm_c)
                    inner_c = jax.lax.ppermute(inner_c, chip_axis, perm_c)

                moving_h = (h + sh) % hc
                moving_chip = (c + sc) % cc
                moving_base = (moving_h * cc + moving_chip) * block
                for (wa, wb, ca, cb, gi, gj, _i_off, _ti0, _tj0,
                     triangle, active) in _ring_substeps_2d(
                    sh, sc, hc, cc, h, c, words_local, inner_w,
                    classes_local, inner_c, row_base, moving_base,
                    block_tile,
                ):
                    counts = _block_counts(
                        wa, wb, weights if weighted else None
                    )
                    valid = (gi < n) & (gj < n) & active
                    if triangle:
                        valid &= gi < gj
                    mask = valid & (counts > threshold)
                    if cross_amr_only:
                        mask &= ca[:, None] != cb[None, :]
                    cursor, bi, bj, bc = _compact_step(
                        mask, counts, gi, gj, block_tile, k,
                        (cursor, bi, bj, bc), cap,
                    )
        return _gather_compacted(
            bi, bj, bc, cursor, h * cc + c, hc * cc, cap,
            (host_axis, chip_axis),
        )

    sharded = shard_map(
        step,
        mesh=mesh,
        in_specs=(
            P((host_axis, chip_axis), None),
            P((host_axis, chip_axis)),
            P(None),
        ),
        out_specs=tuple(P(None) for _ in range(4)),
    )
    return jax.jit(sharded)


# memoized: each maker returns a fresh jitted closure, and jax's jit
# cache is keyed on function identity — without memoization EVERY
# wrapper call would retrace + recompile. Mesh objects hash stably.
@functools.lru_cache(maxsize=64)
def make_ring_sweep_2d(
    mesh: Mesh,
    n: int,
    threshold: int,
    block_tile: int,
    host_axis: str = "h",
    chip_axis: str = "c",
    weighted: bool = False,
    stats_engine: str = "auto",
):
    """Two-level hierarchical ring for (hosts × chips) meshes.

    The flat 1-D ring crosses DCN on every rotation step (the two
    host-boundary links), so the step time is bottlenecked by DCN
    bandwidth. Here the moving copy rotates over the host axis ONCE per
    outer step (the only DCN transfer) and then circulates within each
    host over the chip axis — C inner ICI steps amortize one DCN hop,
    the ring-attention-at-scale layout the task's scaling model
    prescribes (collectives ride ICI, not DCN).

    Pair coverage (every unordered block pair exactly once, any H × C):
      * outer step 0: the intra-host triangular chip ring (inner steps
        C//2+1, even-C final step halved — the 1-D schedule per host);
      * outer steps 1..H//2: the stationary host pairs against the host
        sh hops up-ring; ALL C×C chip-block pairs are needed, covered by
        C full inner rotations; for even H the final outer step would
        visit each host pair twice, so only hosts h < H//2 contribute.

    Same outputs/attribution as :func:`make_ring_sweep`.
    """
    hc = mesh.shape[host_axis]
    cc = mesh.shape[chip_axis]
    stats_engine = _resolve_stats_engine(stats_engine)

    def step(words_local, classes_local, weights):
        h = jax.lax.axis_index(host_axis)
        c = jax.lax.axis_index(chip_axis)
        block = words_local.shape[0]
        nb_local = block // block_tile
        nb = nb_local * hc * cc
        row_base = (h * cc + c) * block

        row_stats = jnp.zeros((block, 8), jnp.int32)
        hits = jnp.zeros((nb, nb, 2), jnp.int32)

        moving_w = words_local
        moving_c = classes_local
        outer_steps = hc // 2 + 1

        for sh in range(outer_steps):
            if sh > 0:
                perm_h = [((i + 1) % hc, i) for i in range(hc)]
                moving_w = jax.lax.ppermute(moving_w, host_axis, perm_h)
                moving_c = jax.lax.ppermute(moving_c, host_axis, perm_h)
            inner_w = moving_w
            inner_c = moving_c
            inner_steps = cc if sh > 0 else (cc // 2 + 1)
            for sc in range(inner_steps):
                if sc > 0:
                    perm_c = [((i + 1) % cc, i) for i in range(cc)]
                    inner_w = jax.lax.ppermute(inner_w, chip_axis, perm_c)
                    inner_c = jax.lax.ppermute(inner_c, chip_axis, perm_c)

                moving_h = (h + sh) % hc
                moving_chip = (c + sc) % cc
                moving_base = (moving_h * cc + moving_chip) * block

                for (wa, wb, ca, cb, gi, gj, i_off, ti0, tj0, triangle,
                     active) in _ring_substeps_2d(
                    sh, sc, hc, cc, h, c, words_local, inner_w,
                    classes_local, inner_c, row_base, moving_base,
                    block_tile,
                ):
                    counts = _block_counts(
                        wa, wb, weights if weighted else None
                    )
                    stats, bh = _step_stats_xla(
                        counts, gi, gj, ca, cb, n, threshold, active,
                        triangle, block_tile, stats_engine,
                    )
                    row_stats = _merge_row_stats_at(
                        row_stats, stats, i_off
                    )
                    hits = _accumulate_hits_at(hits, bh, ti0, tj0)

        hits = jax.lax.psum(
            jax.lax.psum(hits, chip_axis), host_axis
        )
        return row_stats, hits

    sharded = shard_map(
        step,
        mesh=mesh,
        in_specs=(
            P((host_axis, chip_axis), None),
            P((host_axis, chip_axis)),
            P(None),
        ),
        out_specs=(
            P((host_axis, chip_axis), None),
            P(None, None, None),
        ),
    )
    return jax.jit(sharded)


# memoized (see make_ring_fused)
@functools.lru_cache(maxsize=64)
def make_ring_fused_2d(
    mesh: Mesh,
    n: int,
    threshold: int,
    cap: int,
    host_axis: str = "h",
    chip_axis: str = "c",
    weighted: bool = False,
    cross_amr_only: bool = True,
    block_tile: int = 128,
    k: int = 0,
):
    """:func:`make_ring_fused` on the hierarchical 2-D schedule: one
    outer(host)/inner(chip) rotation pass computes the statistics AND
    compacts the survivors — halving the sweep+extract matmul, ICI and
    (critically) DCN cost of running :func:`make_ring_sweep_2d` then
    :func:`make_ring_extract_2d`. Same capacity-guess contract as the
    flat fused ring (overflowing sub-tiles dropped in-pass; the wrapper
    detects misses from the exact tile hits)."""
    hc = mesh.shape[host_axis]
    cc = mesh.shape[chip_axis]

    def step(words_local, classes_local, weights):
        h = jax.lax.axis_index(host_axis)
        c = jax.lax.axis_index(chip_axis)
        block = words_local.shape[0]
        nb_local = block // block_tile
        nb = nb_local * hc * cc
        row_base = (h * cc + c) * block

        row_stats = jnp.zeros((block, 8), jnp.int32)
        hits = jnp.zeros((nb, nb, 2), jnp.int32)
        bi = jnp.zeros(cap, jnp.int32)
        bj = jnp.zeros(cap, jnp.int32)
        bc = jnp.zeros(cap, jnp.int32)
        cursor = jnp.int32(0)

        moving_w = words_local
        moving_c = classes_local
        outer_steps = hc // 2 + 1
        for sh in range(outer_steps):
            if sh > 0:
                perm_h = [((i + 1) % hc, i) for i in range(hc)]
                moving_w = jax.lax.ppermute(moving_w, host_axis, perm_h)
                moving_c = jax.lax.ppermute(moving_c, host_axis, perm_h)
            inner_w = moving_w
            inner_c = moving_c
            inner_steps = cc if sh > 0 else (cc // 2 + 1)
            for sc in range(inner_steps):
                if sc > 0:
                    perm_c = [((i + 1) % cc, i) for i in range(cc)]
                    inner_w = jax.lax.ppermute(inner_w, chip_axis, perm_c)
                    inner_c = jax.lax.ppermute(inner_c, chip_axis, perm_c)

                moving_h = (h + sh) % hc
                moving_chip = (c + sc) % cc
                moving_base = (moving_h * cc + moving_chip) * block
                for (wa, wb, ca, cb, gi, gj, i_off, ti0, tj0, triangle,
                     active) in _ring_substeps_2d(
                    sh, sc, hc, cc, h, c, words_local, inner_w,
                    classes_local, inner_c, row_base, moving_base,
                    block_tile,
                ):
                    counts = _block_counts(
                        wa, wb, weights if weighted else None
                    )
                    stats, over_c, over_s = _pair_stats(
                        counts, gi, gj, ca, cb, n, threshold, active,
                        triangle,
                    )
                    row_stats = _merge_row_stats_at(
                        row_stats, stats, i_off
                    )
                    bh, mask = _fused_subtiles(
                        over_c, over_s, block_tile, k, cross_amr_only
                    )
                    hits = _accumulate_hits_at(hits, bh, ti0, tj0)
                    cursor, bi, bj, bc = _compact_step(
                        mask, counts, gi, gj, block_tile, k,
                        (cursor, bi, bj, bc), cap,
                    )

        hits = jax.lax.psum(
            jax.lax.psum(hits, chip_axis), host_axis
        )
        gathered = _gather_compacted(
            bi, bj, bc, cursor, h * cc + c, hc * cc, cap,
            (host_axis, chip_axis),
        )
        return (row_stats, hits) + gathered

    sharded = shard_map(
        step,
        mesh=mesh,
        in_specs=(
            P((host_axis, chip_axis), None),
            P((host_axis, chip_axis)),
            P(None),
        ),
        out_specs=(
            P((host_axis, chip_axis), None),
            P(None, None, None),
        )
        + tuple(P(None) for _ in range(4)),
    )
    return jax.jit(sharded)


def sharded_pairwise_similarity_2d(
    mesh: Mesh,
    words: np.ndarray,
    classes: np.ndarray,
    n: int,
    threshold: int,
    block_tile: int = 128,
    host_axis: str = "h",
    chip_axis: str = "c",
    weights: np.ndarray | None = None,
    stats_engine: str = "auto",
):
    """Hierarchical (hosts × chips) ring sweep; single-chip engine format."""
    hc = mesh.shape[host_axis]
    cc = mesh.shape[chip_axis]
    d = hc * cc
    n_pad, w_words = words.shape
    assert n_pad % (d * block_tile) == 0, (
        f"N_pad={n_pad} must be divisible by H×C×block_tile="
        f"{d * block_tile}"
    )
    words_s, classes_s, weights_s, weighted = _stage_inputs(
        mesh, words, classes, weights,
        P((host_axis, chip_axis), None), P((host_axis, chip_axis)),
    )
    fn = make_ring_sweep_2d(
        mesh, n, threshold, block_tile, host_axis, chip_axis, weighted,
        stats_engine,
    )
    row_stats, hits = fn(words_s, classes_s, weights_s)
    return _finalize_sweep(mesh, row_stats, hits, n_pad, block_tile)


# memoized: each maker returns a fresh jitted closure, and jax's jit
# cache is keyed on function identity — without memoization EVERY
# wrapper call would retrace + recompile. Mesh objects hash stably.
@functools.lru_cache(maxsize=64)
def make_kaxis_extract(
    mesh: Mesh,
    n: int,
    threshold: int,
    cap: int,
    block_tile: int,
    axis: str = "k",
    weighted: bool = False,
    cross_amr_only: bool = True,
    k: int = 0,
):
    """Exact pair extraction under contraction-axis sharding.

    Mirrors :func:`make_kaxis_sweep`'s row-block scan: partial counts
    over each device's k-mer column slice, one ``psum`` per block, then
    a replicated compaction into a single `cap` buffer — the bitset
    stays column-sharded (the whole point of this layout is that the K
    extent does not fit one device), and only O(cap) survivor slots are
    replicated. Returns (gi [cap], gj [cap], cnt [cap], cursor [1]),
    replicated.
    """

    def step(words_local, classes, weights_local):
        n_pad = words_local.shape[0]
        nb = n_pad // block_tile
        a_full = unpack_words_to_int8(
            words_local, weights_local if weighted else None
        )
        b_full = unpack_words_to_int8(words_local)
        col = jax.lax.broadcasted_iota(jnp.int32, (block_tile, n_pad), 1)

        def body(carry, blk):
            bi, bj, bc, cursor = carry
            r0 = blk * block_tile
            a = jax.lax.dynamic_slice(
                a_full, (r0, 0), (block_tile, a_full.shape[1])
            )
            ca = jax.lax.dynamic_slice(classes, (r0,), (block_tile,))
            partial = jax.lax.dot_general(
                a, b_full, (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.int32,
            )
            counts = jax.lax.psum(partial, axis)
            gi = r0 + jax.lax.broadcasted_iota(
                jnp.int32, (block_tile, n_pad), 0
            )
            mask = (gi < col) & (col < n) & (counts > threshold)
            if cross_amr_only:
                mask &= ca[:, None] != classes[None, :]
            cursor, bi, bj, bc = _compact_step(
                mask, counts, gi, col, block_tile, k,
                (cursor, bi, bj, bc), cap,
            )
            return (bi, bj, bc, cursor), None

        z = jnp.zeros(cap, jnp.int32)
        (bi, bj, bc, cursor), _ = jax.lax.scan(
            body, (z, z, z, jnp.int32(0)), jnp.arange(nb)
        )
        return bi, bj, bc, cursor[None]

    sharded = shard_map(
        step,
        mesh=mesh,
        in_specs=(P(None, axis), P(None), P(axis)),
        out_specs=tuple(P(None) for _ in range(4)),
    )
    return jax.jit(sharded)


# memoized: each maker returns a fresh jitted closure, and jax's jit
# cache is keyed on function identity — without memoization EVERY
# wrapper call would retrace + recompile. Mesh objects hash stably.
@functools.lru_cache(maxsize=64)
def make_kaxis_sweep(
    mesh: Mesh,
    n: int,
    threshold: int,
    block_tile: int,
    axis: str = "k",
    weighted: bool = False,
    stats_engine: str = "auto",
):
    """Contraction-axis (k-mer-axis) sharded sweep — the Ulysses/TP
    analogue of SURVEY.md §5: each device holds a *column* slice of the
    packed bitset (`[N_pad, W/D]` words, i.e. a shard of the k-mer
    universe) and computes partial shared-k-mer counts over its slice;
    one ``psum`` per row-block merges them into exact counts.

    This is the memory-scaling axis: the ring sweep replicates the full
    K extent per device (row-sharded), which the 7-mer universe at large
    corpus scale can outgrow — K-sharding divides bitset + unpacked
    operand HBM by D at the cost of an [block_tile, N_pad] int32
    all-reduce per row block (N²·4 bytes total, riding ICI).

    Row-block schedule under one ``lax.scan`` (one compiled shape): for
    each block the upper triangle (gi < gj) is computed against all
    columns, so every unordered pair is counted exactly once. Outputs are
    replicated and match the single-chip engine format.
    """
    d_count = mesh.shape[axis]
    stats_engine = _resolve_stats_engine(stats_engine)

    def step(words_local, classes, weights_local):
        n_pad = words_local.shape[0]
        nb = n_pad // block_tile
        a_full = unpack_words_to_int8(
            words_local, weights_local if weighted else None
        )
        b_full = unpack_words_to_int8(words_local)
        col = jax.lax.broadcasted_iota(jnp.int32, (block_tile, n_pad), 1)

        def body(carry, bi):
            row_stats, hits = carry
            r0 = bi * block_tile
            a = jax.lax.dynamic_slice(
                a_full, (r0, 0), (block_tile, a_full.shape[1])
            )
            ca = jax.lax.dynamic_slice(classes, (r0,), (block_tile,))
            partial = jax.lax.dot_general(
                a, b_full, (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.int32,
            )
            counts = jax.lax.psum(partial, axis)
            gi = r0 + jax.lax.broadcasted_iota(
                jnp.int32, (block_tile, n_pad), 0
            )
            stats, bh = _step_stats_xla(
                counts, gi, col, ca, classes,
                n, threshold, jnp.bool_(True), True,
                block_tile, stats_engine,
            )
            prev = jax.lax.dynamic_slice(
                row_stats, (r0, 0), (block_tile, 8)
            )
            row_stats = jax.lax.dynamic_update_slice(
                row_stats, _merge_row_stats(prev, stats), (r0, 0)
            )
            # bh is [1, nb, 2] here (S = one block_tile row strip)
            hits = jax.lax.dynamic_update_slice(hits, bh, (bi, 0, 0))
            return (row_stats, hits), None

        row_stats = jnp.zeros((n_pad, 8), jnp.int32)
        hits = jnp.zeros((nb, nb, 2), jnp.int32)
        (row_stats, hits), _ = jax.lax.scan(
            body, (row_stats, hits), jnp.arange(nb)
        )
        return row_stats, hits

    sharded = shard_map(
        step,
        mesh=mesh,
        in_specs=(P(None, axis), P(None), P(axis)),
        out_specs=(P(None, None), P(None, None, None)),
    )
    return jax.jit(sharded)


# memoized (see make_ring_fused)
@functools.lru_cache(maxsize=64)
def make_kaxis_fused(
    mesh: Mesh,
    n: int,
    threshold: int,
    cap: int,
    block_tile: int,
    axis: str = "k",
    weighted: bool = False,
    cross_amr_only: bool = True,
    k: int = 0,
):
    """:func:`make_ring_fused` under contraction-axis sharding: the
    row-block scan psums each block's partial counts ONCE and derives
    both the statistics and the compacted survivors from them — halving
    the matmul and (critically) the per-block [block_tile, N_pad] int32
    all-reduce cost of running :func:`make_kaxis_sweep` then
    :func:`make_kaxis_extract`. Outputs replicated (the compaction runs
    on the psum'd counts, identical on every device)."""

    def step(words_local, classes, weights_local):
        n_pad = words_local.shape[0]
        nb = n_pad // block_tile
        a_full = unpack_words_to_int8(
            words_local, weights_local if weighted else None
        )
        b_full = unpack_words_to_int8(words_local)
        col = jax.lax.broadcasted_iota(jnp.int32, (block_tile, n_pad), 1)

        def body(carry, blk):
            row_stats, hits, bi, bj, bc, cursor = carry
            r0 = blk * block_tile
            a = jax.lax.dynamic_slice(
                a_full, (r0, 0), (block_tile, a_full.shape[1])
            )
            ca = jax.lax.dynamic_slice(classes, (r0,), (block_tile,))
            partial = jax.lax.dot_general(
                a, b_full, (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.int32,
            )
            counts = jax.lax.psum(partial, axis)
            gi = r0 + jax.lax.broadcasted_iota(
                jnp.int32, (block_tile, n_pad), 0
            )
            stats, over_c, over_s = _pair_stats(
                counts, gi, col, ca, classes,
                n, threshold, jnp.bool_(True), True,
            )
            prev = jax.lax.dynamic_slice(
                row_stats, (r0, 0), (block_tile, 8)
            )
            row_stats = jax.lax.dynamic_update_slice(
                row_stats, _merge_row_stats(prev, stats), (r0, 0)
            )
            # one row strip = a [1, nb] sub-tile grid for the shared helper
            bh, mask = _fused_subtiles(
                over_c, over_s, block_tile, k, cross_amr_only
            )
            hits = jax.lax.dynamic_update_slice(hits, bh, (blk, 0, 0))
            cursor, bi, bj, bc = _compact_step(
                mask, counts, gi, col, block_tile, k,
                (cursor, bi, bj, bc), cap,
            )
            return (row_stats, hits, bi, bj, bc, cursor), None

        z = jnp.zeros(cap, jnp.int32)
        init = (
            jnp.zeros((n_pad, 8), jnp.int32),
            jnp.zeros((nb, nb, 2), jnp.int32),
            z, z, z, jnp.int32(0),
        )
        (row_stats, hits, bi, bj, bc, cursor), _ = jax.lax.scan(
            body, init, jnp.arange(nb)
        )
        return row_stats, hits, bi, bj, bc, cursor[None]

    sharded = shard_map(
        step,
        mesh=mesh,
        in_specs=(P(None, axis), P(None), P(axis)),
        out_specs=(P(None, None), P(None, None, None))
        + tuple(P(None) for _ in range(4)),
    )
    return jax.jit(sharded)


def sharded_pairwise_similarity_kaxis(
    mesh: Mesh,
    words: np.ndarray,
    classes: np.ndarray,
    n: int,
    threshold: int,
    block_tile: int = 128,
    axis: str = "k",
    weights: np.ndarray | None = None,
):
    """K-axis-sharded sweep; single-chip engine output format."""
    n_pad = words.shape[0]
    words_s, classes_s, weights_s, weighted = _stage_inputs_kaxis(
        mesh, words, classes, weights, axis, block_tile
    )
    fn = make_kaxis_sweep(mesh, n, threshold, block_tile, axis, weighted)
    row_stats, hits = fn(words_s, classes_s, weights_s)
    return _finalize_sweep(mesh, row_stats, hits, n_pad, block_tile)


@functools.lru_cache(maxsize=None)
def _make_doc_freq_psum(mesh: Mesh, k: int, axis: str):
    # memoized like every other maker here: a fresh jit identity per
    # call would recompile the distributed program each invocation
    from uniprot_kmer_based_clustering_tpu.kmers.index import (
        doc_freq_dense_device,
    )

    def step(codes_local, valid_local):
        local = doc_freq_dense_device(codes_local, valid_local, k)
        return jax.lax.psum(local, axis)

    return jax.jit(
        shard_map(
            step,
            mesh=mesh,
            in_specs=(P(axis, None), P(axis, None)),
            out_specs=P(None),
        )
    )


def doc_freq_psum(mesh: Mesh, codes, valid, k: int, axis: str = "p"):
    """Distributed dense doc-freq for k=5: per-shard bincount over the 21^k
    universe, merged with one psum (replaces the reference's global mutexed
    sorted list, src/main.rs:101-114)."""
    return _make_doc_freq_psum(mesh, k, axis)(codes, valid)
