"""Metric readers, one file per metric named as in BENCHMARK.json
(``<name>.py``), each with ``read(run: record.RunData)`` returning the
value, or None when the run holds nothing to read it from (the metric
is then left out of the result line)."""

from __future__ import annotations

import importlib.util
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def reader(name: str):
    path = os.path.join(HERE, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no reader {name}.py in {HERE}")
    spec = importlib.util.spec_from_file_location(f"scanbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
