"""Multi-process worker for tests/test_multiprocess.py.

Runs the ring sweep + distributed doc-freq on a 2-process × 2-local-device
CPU cluster (jax.distributed + gloo collectives). Usage:

    python _mp_worker.py <process_id> <num_processes> <port> <out_npz>

Process 0 writes the results; every process must agree (replicated
outputs), so process 1 writes a second file for cross-process comparison.
"""

import os
import sys

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]
out = sys.argv[4]

# conftest-style: set env, then force the platform via config before any
# device use.
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=2"
)
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")

from uniprot_kmer_based_clustering_tpu.parallel.mesh import (  # noqa: E402
    init_distributed,
    make_mesh,
)

init_distributed(f"localhost:{port}", num_processes=nproc, process_id=pid)

import numpy as np  # noqa: E402

from uniprot_kmer_based_clustering_tpu.parallel.sharded import (  # noqa: E402
    doc_freq_psum,
    sharded_pairwise_similarity,
)

assert jax.process_count() == nproc, jax.process_count()
mesh = make_mesh()  # all 4 global devices
d = len(jax.devices())

# Deterministic synthetic case (identical on every process).
rng = np.random.default_rng(123)
n_pad, w = 512, 32
n = 500
words = rng.integers(0, 2**32, size=(n_pad, w), dtype=np.uint32)
words[n:] = 0
classes = rng.integers(0, 4, size=n_pad).astype(np.int32)
classes[n:] = -1

row_stats, tile_hits, tiles = sharded_pairwise_similarity(
    mesh, words, classes, n, threshold=10, block_tile=128
)
# Per-row attribution is engine-specific (the ring credits the stationary
# row); the engine contract is aggregate equality + exact pair sets.
SUM_LANES = [0, 1, 2, 4, 5, 6]
MAX_LANES = [3, 7]
agg = np.concatenate(
    [row_stats[:, SUM_LANES].sum(axis=0), row_stats[:, MAX_LANES].max(axis=0)]
)

import jax.numpy as jnp  # noqa: E402

from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (  # noqa: E402
    extract_pairs,
)

pairs = extract_pairs(
    jnp.asarray(words), classes, tile_hits, tiles, n=n, threshold=10
)

# ring extraction across the real process boundary must agree exactly
from uniprot_kmer_based_clustering_tpu.parallel.sharded import (  # noqa: E402
    sharded_extract_pairs,
)

pairs_ring = sharded_extract_pairs(
    mesh, words, classes, n, 10, block_tile=128
)
assert np.array_equal(pairs_ring, np.asarray(pairs)), "ring extraction"

from uniprot_kmer_based_clustering_tpu.parallel.mesh import (  # noqa: E402
    make_mesh_2d,
)

pairs_2d = sharded_extract_pairs(
    make_mesh_2d(nproc, d // nproc), words, classes, n, 10, block_tile=128
)
assert np.array_equal(pairs_2d, np.asarray(pairs)), "2-D ring extraction"

pairs_k = sharded_extract_pairs(
    make_mesh(axis="k"), words, classes, n, 10, block_tile=128
)
assert np.array_equal(pairs_k, np.asarray(pairs)), "k-axis extraction"

# fused pass across the real process boundary: stats + survivors in ONE
# collective pass (also the only place the multi-host row_stats
# replicate-before-fetch path runs)
from uniprot_kmer_based_clustering_tpu.parallel.sharded import (  # noqa: E402
    sharded_pairwise_fused,
)

rs_f, th_f, _, pairs_f = sharded_pairwise_fused(
    mesh, words, classes, n, 10, block_tile=128
)
assert np.array_equal(pairs_f, np.asarray(pairs)), "fused ring pairs"
agg_f = np.concatenate(
    [rs_f[:, SUM_LANES].sum(axis=0), rs_f[:, MAX_LANES].max(axis=0)]
)
assert np.array_equal(agg_f, agg), "fused ring stats"
assert np.array_equal(np.asarray(th_f), np.asarray(tile_hits)), "fused hits"

# Hierarchical 2-D ring: host axis = the real process boundary (gloo/DCN
# analogue), chip axis = the 2 local devices. Must be bit-identical to
# the flat ring.
from uniprot_kmer_based_clustering_tpu.parallel.mesh import (  # noqa: E402
    make_mesh_2d,
)
from uniprot_kmer_based_clustering_tpu.parallel.sharded import (  # noqa: E402
    sharded_pairwise_similarity_2d,
    sharded_pairwise_similarity_kaxis,
)

rs2, th2, _ = sharded_pairwise_similarity_2d(
    make_mesh_2d(nproc, d // nproc), words, classes, n,
    threshold=10, block_tile=128,
)
assert np.array_equal(th2, tile_hits), "2-D ring != flat ring"
agg2 = np.concatenate(
    [rs2[:, SUM_LANES].sum(axis=0), rs2[:, MAX_LANES].max(axis=0)]
)
assert np.array_equal(agg2, agg), "2-D ring aggregate mismatch"

# Contraction-axis sharding across both processes: partial counts merged
# by a cross-host psum.
rs_k, th_k, _ = sharded_pairwise_similarity_kaxis(
    make_mesh(axis="k"), words, classes, n, threshold=10, block_tile=128
)
assert np.array_equal(th_k, tile_hits), "k-axis != flat ring"
agg_k = np.concatenate(
    [rs_k[:, SUM_LANES].sum(axis=0), rs_k[:, MAX_LANES].max(axis=0)]
)
assert np.array_equal(agg_k, agg), "k-axis aggregate mismatch"

# Sharded OUT-OF-CORE stream composition across the real process
# boundary: replicated CSR staging, per-process block-pair partitions,
# cooperative stack all_gather over gloo, replicated probe/merge — the
# multi-host path of parallel/stream_mesh.py. max_group=1 forces the
# multi-group schedule.
from uniprot_kmer_based_clustering_tpu.ops.stream import (  # noqa: E402
    CSRBlockSource,
)
from uniprot_kmer_based_clustering_tpu.parallel.stream_mesh import (  # noqa: E402
    sweep_extract_stream_mesh,
)

_rows_b, _wi = np.nonzero(words)
_bits = words[_rows_b, _wi]
_ip, _ir = [], []
for _b in range(32):
    _sel = ((_bits >> _b) & 1).astype(bool)
    _ip.append(_rows_b[_sel])
    _ir.append(_wi[_sel] * 32 + _b)
_ip = np.concatenate(_ip).astype(np.int32)
_ir = np.concatenate(_ir).astype(np.int32)
src_sm = CSRBlockSource(_ip, _ir, n_pad, w)
rs_sm, th_sm, _, pairs_sm = sweep_extract_stream_mesh(
    mesh, classes, n, 10, block_source=src_sm, bs=128, block=128,
    max_group=1, scan_chunk=3,
)
assert np.array_equal(pairs_sm, np.asarray(pairs)), "stream-mesh pairs"
agg_sm = np.concatenate(
    [rs_sm[:, SUM_LANES].sum(axis=0), rs_sm[:, MAX_LANES].max(axis=0)]
)
assert np.array_equal(agg_sm, agg), "stream-mesh aggregate mismatch"

# Distributed doc-freq over a tiny 5-mer code matrix.
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

codes = rng.integers(0, 21**5, size=(d * 2, 16), dtype=np.int64)
valid = np.ones_like(codes, dtype=bool)
codes_s = jax.device_put(jnp.asarray(codes), NamedSharding(mesh, P("p", None)))
valid_s = jax.device_put(jnp.asarray(valid), NamedSharding(mesh, P("p", None)))
freq = np.asarray(doc_freq_psum(mesh, codes_s, valid_s, 5))

# Collective cluster merge over the extracted pairs (BASELINE config #5:
# partial forests merged across hosts — here the pmin label collective).
from uniprot_kmer_based_clustering_tpu.models.components import (  # noqa: E402
    connected_components_sharded,
)

labels = connected_components_sharded(mesh, pairs, n)

np.savez(
    out,
    agg=agg,
    tile_hits=tile_hits,
    pairs=pairs,
    labels=labels,
    freq_nnz=np.array([int((freq > 0).sum()), int(freq.sum())]),
)
print(f"worker {pid} done", flush=True)
