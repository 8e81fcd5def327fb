"""Device setup: the memory budget read from the device, the compile
cache location, and the engine ``auto`` resolves to per platform."""

import types

import jax
import pytest

from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
    DEVICE_ENGINE,
    resolve_engine,
)
from uniprot_kmer_based_clustering_tpu.utils import accel


def _stub_device(platform, stats):
    return types.SimpleNamespace(
        platform=platform, memory_stats=lambda: stats
    )


@pytest.mark.parametrize("case", ["gpu_limit", "gpu_no_stats", "cpu"])
def test_device_memory_budget(case):
    if case == "gpu_limit":
        dev = _stub_device("gpu", {"bytes_limit": 64 << 30})
        assert accel.device_memory_budget(dev) == (64 << 30) - (8 << 30)
    elif case == "gpu_no_stats":
        with pytest.raises(RuntimeError, match="no memory limit"):
            accel.device_memory_budget(_stub_device("gpu", None))
    else:
        assert accel.device_memory_budget() == accel.CPU_BUDGET_BYTES
        assert (
            accel.device_memory_budget(_stub_device("cpu", None))
            == accel.CPU_BUDGET_BYTES
        )


@pytest.mark.parametrize("env_set", [True, False])
def test_persistent_cache_location(env_set, monkeypatch, tmp_path):
    calls = {}
    monkeypatch.setattr(
        jax.config, "update", lambda k, v: calls.__setitem__(k, v)
    )
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    accel.enable_persistent_cache()
    if env_set:
        # JAX reads the variable itself; nothing may override it
        assert "jax_compilation_cache_dir" not in calls
    else:
        assert calls["jax_compilation_cache_dir"] == accel.DEFAULT_CACHE_DIR
        assert accel.DEFAULT_CACHE_DIR.endswith(".jax_cache")
    assert "jax_persistent_cache_min_compile_time_secs" in calls


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_auto_engine_resolution(platform, monkeypatch):
    from uniprot_kmer_based_clustering_tpu.io import native

    monkeypatch.setattr(native, "available", lambda: True)
    got = resolve_engine("auto", platform)
    assert got == ("native" if platform == "cpu" else DEVICE_ENGINE)
    assert DEVICE_ENGINE == "mxu"
    # weighted runs need a matmul engine unless the sparse native sweep
    # carries the weights; explicit engines pass through
    assert resolve_engine("xla", platform, weighted=True) == "mxu"
    assert resolve_engine("stream", platform, weighted=True) == "stream"
    assert resolve_engine(
        "auto", platform, weighted=True, sparse_native=True
    ) == ("native" if platform == "cpu" else "mxu")
    if platform == "cpu":
        monkeypatch.setattr(native, "available", lambda: False)
        assert resolve_engine("auto", platform) == "xla"
