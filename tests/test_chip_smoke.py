"""chip_smoke.py on a machine without a GPU, and its exact pair-list
comparison."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, SCRIPT], capture_output=True, text=True,
        timeout=300, cwd=ROOT, env=env,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU found" in r.stderr


def test_compare_pairs_catches_one_changed_count(tmp_path):
    smoke = _load()
    ref = np.array([[0, 5, 12], [1, 7, 40], [3, 9, 11]], np.int64)
    path = tmp_path / "pairs.tsv"
    with open(path, "w") as f:
        f.write("protein_i\tprotein_j\tid_i\tid_j\tclass_i\tclass_j\t"
                "shared_kmers\n")
        for i, j, c in ref:
            f.write(f"{i}\t{j}\ta\tb\tx\ty\t{c}\n")
    got = smoke.read_pairs_tsv(str(path))
    smoke.compare_pairs(got, ref, "identical")
    got[1, 2] += 1
    with pytest.raises(AssertionError, match=r"pair 1 is \[1, 7, 41\]"):
        smoke.compare_pairs(got, ref, "one count off")
    with pytest.raises(AssertionError, match="2 pairs, reference has 3"):
        smoke.compare_pairs(got[:2], ref, "one pair missing")
