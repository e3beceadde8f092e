"""The harness's tests: on the CPU at a tiny size, except those marked
``cuda``, which decide inside the test whether a card is there.

    python -m pytest benchmark/tests -q
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips where none is present")


import json  # noqa: E402

import pytest  # noqa: E402

TINY = "tiny_centered"
MIXES = ("nk_device", "apply")


@pytest.fixture(scope="session")
def tiny_spec():
    """BENCHMARK.json with the test-only tiny configuration's cells added,
    each reporting what the benchmark's cells of the same mix report. The
    Newton-iteration mix's metrics, whose cell waits on the program
    (PERF.md, Open questions), come from ``refactor_metrics.json`` where
    BENCHMARK.json does not name them."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(
        name=TINY, source="benchmark/tests/configs", reduced=["grid"],
        file=f"benchmark/tests/configs/{TINY}.json", why="CPU tests"))
    for mix in MIXES:
        cell = f"{TINY}.{mix}"
        twins = {w["name"] for w in spec["workloads"] if w["traffic"] == mix}
        spec["workloads"].append(dict(name=cell, config=TINY, traffic=mix,
                                      chips=1, why="CPU tests"))
        for m in spec["end_to_end"] + spec["per_layer"]:
            if twins & set(m.get("workloads", [])):
                m["workloads"].append(cell)
    names = {m["name"] for m in spec["end_to_end"] + spec["per_layer"]}
    for kind, entries in pending_metrics().items():
        spec[kind] += [dict(m, workloads=[f"{TINY}.nk_device"])
                       for m in entries if m["name"] not in names]
    return spec


def pending_metrics() -> dict:
    """The metrics of the Newton-iteration mix kept for its cell."""
    return json.loads((ROOT / "benchmark" / "tests"
                       / "refactor_metrics.json").read_text())


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
