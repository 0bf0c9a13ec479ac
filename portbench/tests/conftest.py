"""Small configurations for the CPU tests: the benchmark's own files with
fewer rows, in a temporary directory that the catalog searches first."""

import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

#: the configurations at sizes a CPU test holds; the widths, key
#: distributions and the mix of questions are the published ones
SMALL = {
    "h2o-groupby-1e8-k100": {"N": 20000, "K": 10},
    "h2o-join-1e8": {"rows": {"x": 20000, "small": 10, "medium": 1000, "big": 20000},
                     "key_n": {"id1": 10, "id2": 1000, "id3": 20000}},
}


def write_small(base: pathlib.Path, sizes=SMALL) -> pathlib.Path:
    (base / "configs").mkdir(parents=True, exist_ok=True)
    for name, changes in sizes.items():
        config = json.loads((harness.HERE / "configs" / f"{name}.json").read_text())
        config.update(changes)
        (base / "configs" / f"{name}.json").write_text(json.dumps(config))
    return base


@pytest.fixture
def small_catalog(tmp_path):
    return harness.Catalog(bases=[write_small(tmp_path), harness.HERE])


@pytest.fixture
def cuda():
    """The CUDA device, or a skip: decided per test, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
