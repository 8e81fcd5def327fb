"""Test harness: force an 8-device virtual CPU mesh.

Must run before any jax backend initialization. Tests always run on the
CPU so they are hermetic and can emulate a multi-device mesh; code that
needs the GPU is driven by chip_smoke.py on the card.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def toy_fasta(tmp_path_factory):
    """Deterministic toy dataset (tests/_toy_data.py — shared with the
    multi-process worker)."""
    from tests._toy_data import write_toy_fasta

    path = tmp_path_factory.mktemp("data") / "toy.fasta"
    return write_toy_fasta(str(path))


@pytest.fixture(scope="session")
def arg_fasta():
    """The reference's bundled dataset, when the checkout carries it."""
    p = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "data", "uniprot_arg.fasta",
    )
    if not os.path.exists(p):
        pytest.skip("reference dataset not available")
    return p
