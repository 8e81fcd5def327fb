"""The CSR block materializers rebuild packed rows with a flat bit
scatter-add. Two ranks of one protein that fall in the same 32-bit word
share a flat index, so the scatter must add both bits (no unique-index
promise). Each case builds such rows and checks the materialized words
against the host packer bit for bit."""

import numpy as np
import jax
import pytest

from uniprot_kmer_based_clustering_tpu.kmers.bitset import pack_bitsets
from uniprot_kmer_based_clustering_tpu.ops.stream import CSRBlockSource
from uniprot_kmer_based_clustering_tpu.parallel import make_mesh
from uniprot_kmer_based_clustering_tpu.parallel.sharded import (
    stage_mesh_inputs_csr,
)

N, N_BITS, N_PAD, W_PAD = 30, 5000, 32, 256


def _same_word_incidences():
    """(protein, rank) lists, sorted by protein, where every protein holds
    several ranks inside one 32-bit word (plus a few scattered ones)."""
    rng = np.random.default_rng(23)
    p, r = [], []
    for i in range(N):
        word = int(rng.integers(0, N_BITS // 32))
        same = rng.choice(32, size=4, replace=False) + 32 * word
        other = rng.choice(N_BITS, size=3, replace=False)
        ranks = np.unique(np.concatenate([same, other]))
        p += [i] * len(ranks)
        r += list(ranks)
    return np.asarray(p, np.int32), np.asarray(r, np.int32)


@pytest.mark.parametrize("materializer", ["stream_block", "mesh_rows", "mesh_kaxis"])
def test_csr_materializer_keeps_same_word_bits(materializer):
    p, r = _same_word_incidences()
    ref = pack_bitsets(p, r, N, N_BITS, row_multiple=N_PAD,
                       word_multiple=128)
    assert ref.words.shape == (N_PAD, W_PAD)
    # the fixture really has same-word duplicates of the flat index
    flat = p.astype(np.int64) * W_PAD + (r >> 5)
    assert len(np.unique(flat)) < len(flat)

    if materializer == "stream_block":
        src = CSRBlockSource(p, r, N_PAD, W_PAD)
        src.prepare(16, N_PAD)
        got = np.concatenate([np.asarray(src.put(b)) for b in range(2)])
    else:
        axis = "k" if materializer == "mesh_kaxis" else "p"
        mesh = make_mesh(4, axis=axis)
        classes = np.zeros(N_PAD, np.int32)
        words, _ = stage_mesh_inputs_csr(
            mesh, p, r, N_PAD, W_PAD, classes, axis=axis
        )
        got = np.asarray(jax.device_get(words))
    assert got.dtype == np.uint32
    assert np.array_equal(got, ref.words)
