"""Tiled pairwise AND+popcount sweep — the framework's hot kernel.

Computes, for every protein pair (i < j), the shared-repeated-k-mer count
``|kmers(i) ∩ kmers(j)| = Σ_w popcount(words[i, w] & words[j, w])`` over the
packed bitset matrix, fused with the AMR-class cross filter and the
alignment threshold. This single sweep subsumes the reference's entire
graph engine:

  * ``Graph::new``'s 258M-edge materialization (src/graph/mod.rs:39-193),
  * ``remove_uninteresting_edges``'s cross-AMR filter
    (src/graph/mod.rs:549-697),
  * ``combine_edges``'s parallel-edge merge (src/graph/mod.rs:322-546), and
  * the ``> 10`` shared-k-mer alignment gate (src/graph/mod.rs:242),

because the merged edge between proteins i and j carries exactly their
shared k-mers, so only the intersection *count* (and, for the 465 surviving
pairs, the k-mer ids recovered later on host) is ever consumed.

Design: the upper triangle of (tile_i, tile_j) pairs is enumerated on the
host so no tile is computed twice; each tile's counts are one fused XLA
AND+popcount+reduce over the packed word axis, and the per-tile statistics
are reduced on device, so only [tile, 8] row statistics come back.

Outputs (both int32):
  row_stats [N_pad, 8] — per stationary protein row, over all j > i:
      0 cross_weight  Σ counts where class differs
      1 cross_pairs   #pairs with counts ≥ 1, class differs
      2 cross_over    #pairs with counts > threshold, class differs
      3 cross_max     max count, class differs
      4..7 the same four for class-equal pairs
  tile_hits [n_tiles, 4] — per (i,j) tile: lanes 0/1 = #cross/#same pairs
      over threshold (drives the host extraction pass), lanes 2/3 = #pairs
      with counts ≥ 1 (cross/same).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

ROW_STAT_NAMES = (
    "cross_weight",
    "cross_pairs",
    "cross_over",
    "cross_max",
    "same_weight",
    "same_pairs",
    "same_over",
    "same_max",
)
_NSTATS = 8


def upper_triangle_tiles(n_pad: int, tile: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side (i_tile, j_tile) enumeration of the upper triangle,
    row-major so that all tiles sharing a stationary i are consecutive."""
    nt = n_pad // tile
    i, j = np.triu_indices(nt)
    return i.astype(np.int32), j.astype(np.int32)


def _masks(i0, j0, n, tile, classes_row, classes_col):
    """Pair-validity and class masks for one (i,j) tile.

    gi/gj are global protein indices; the `gi < gj` mask both removes the
    diagonal and deduplicates the two orientations of diagonal tiles (the
    reference's pair set is unordered: SURVEY.md §3.2).
    """
    gi = i0 + jax.lax.broadcasted_iota(jnp.int32, (tile, tile), 0)
    gj = j0 + jax.lax.broadcasted_iota(jnp.int32, (tile, tile), 1)
    valid = (gi < gj) & (gj < n) & (gi < n)
    cross = classes_row != classes_col  # [tile,1] vs [1,tile] broadcast
    return valid & cross, valid & ~cross


# ---------------------------------------------------------------------------
# XLA engine (the packed AND+popcount sweep)
# ---------------------------------------------------------------------------


@jax.jit
def pairwise_counts_xla(a_words, b_words):
    """[A, W] × [B, W] → int32 [A, B] shared-bit counts (pure XLA)."""

    def one_row(row):
        return jnp.sum(
            jax.lax.population_count(row[None, :] & b_words).astype(jnp.int32),
            axis=1,
        )

    return jax.vmap(one_row)(a_words)


@functools.partial(jax.jit, static_argnames=("n", "threshold", "tile"))
def _tile_stats_xla(a, b, crow, ccol, i0, j0, *, n, threshold, tile):
    from uniprot_kmer_based_clustering_tpu.ops.bitmul import stack_row_stats

    counts = pairwise_counts_xla(a, b)
    cross, same = _masks(i0, j0, n, tile, crow, ccol)
    # the canonical shared 8-lane stack (the popcount engines never take
    # weights, so w_thresh stays at its default 1)
    stats, _, _ = stack_row_stats(counts, cross, same, threshold)
    hits = jnp.stack(
        [
            jnp.sum(stats[:, 2]),
            jnp.sum(stats[:, 6]),
            jnp.sum(stats[:, 1]),
            jnp.sum(stats[:, 5]),
        ]
    )
    return stats, hits


def sweep_xla(words, classes, n: int, threshold: int, tile: int = 512):
    """Tile-by-tile AND+popcount sweep (``engine="xla"``).

    Python-loops the tile grid (one compiled tile program); its outputs
    match the int8-matmul engine's exactly, so it is also the tests'
    oracle for that engine.
    """
    n_pad = words.shape[0]
    if n_pad % tile != 0:
        # a floored tile grid would silently skip the tail rows (or, for
        # n_pad < tile, sweep nothing at all)
        raise ValueError(
            f"n_pad={n_pad} must be a multiple of tile={tile} "
            "(pack with a matching row_multiple)"
        )
    ti, tj = upper_triangle_tiles(n_pad, tile)
    classes = jnp.asarray(classes, jnp.int32)
    row_stats = np.zeros((n_pad, _NSTATS), dtype=np.int64)
    tile_hits = np.zeros((ti.shape[0], 4), dtype=np.int32)
    # dispatch every tile asynchronously and fetch once: a synchronizing
    # per-tile readback would serialize the tiles on the round trip
    device_parts = []
    for t in range(ti.shape[0]):
        i, j = int(ti[t]), int(tj[t])
        a = jax.lax.dynamic_slice_in_dim(words, i * tile, tile, 0)
        b = jax.lax.dynamic_slice_in_dim(words, j * tile, tile, 0)
        crow = jax.lax.dynamic_slice_in_dim(classes, i * tile, tile).reshape(
            tile, 1
        )
        ccol = jax.lax.dynamic_slice_in_dim(classes, j * tile, tile).reshape(
            1, tile
        )
        device_parts.append(
            _tile_stats_xla(
                a, b, crow, ccol, i * tile, j * tile,
                n=n, threshold=threshold, tile=tile,
            )
        )
    for t, (stats, hits) in enumerate(jax.device_get(device_parts)):
        i = int(ti[t])
        stats = stats.astype(np.int64)
        sl = slice(i * tile, (i + 1) * tile)
        for lane in range(_NSTATS):
            if lane % 4 == 3:
                row_stats[sl, lane] = np.maximum(row_stats[sl, lane], stats[:, lane])
            else:
                row_stats[sl, lane] += stats[:, lane]
        tile_hits[t] = hits
    return row_stats, tile_hits, (ti, tj, tile)
