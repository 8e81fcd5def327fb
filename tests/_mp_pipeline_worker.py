"""End-to-end multi-process worker for tests/test_multiprocess.py.

Runs the FULL pipeline (``run_pipeline`` with a mesh spanning a
2-process × 2-local-device gloo cluster) on the shared toy FASTA — the
closest CPU analogue of launching the production CLI on a 2-host
cluster. Usage:

    python _mp_pipeline_worker.py <process_id> <num_processes> <port> \
        <fasta_path> <out_npz>

Every process must observe the identical replicated result (the pipeline
output is the parity boundary, SURVEY.md §4 oracle 2).
"""

import os
import sys

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]
fasta = sys.argv[4]
out = sys.argv[5]

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

from uniprot_kmer_based_clustering_tpu.config import (  # noqa: E402
    PipelineConfig,
)
from uniprot_kmer_based_clustering_tpu.pipeline import (  # noqa: E402
    run_pipeline,
)

assert jax.process_count() == nproc, jax.process_count()

# Same knobs as tests/test_pipeline.py CFG (small tiles for the toy set).
cfg = PipelineConfig(
    tile=16, strip=32, engine="xla", threshold=2
)
res = run_pipeline(fasta, cfg, mesh=make_mesh())
rep = res.parity_report()

np.savez(
    out,
    pairs=res.pairwise.pairs,
    labels=res.cluster_labels,
    report=np.array([rep[k] for k in sorted(rep)], dtype=np.int64),
)
print(f"pipeline worker {pid} done", flush=True)
