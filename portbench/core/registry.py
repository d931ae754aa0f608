"""Everything the harness runs, found by name from ``BENCHMARK.json``.

A cell names a configuration and a traffic mix; each lives in files of
its own under ``portbench/``:

- ``configs/<config>.json``: the space, the algorithm's parameters, the
  history size, source, ``reduced`` and ``assumed``; beside it
  ``configs/<config>.py``, the objective's loss in NumPy
  (``loss(point)``);
- ``traffic/<mix>.json``: the driver (``fmin``) and its
  parameters;
- ``metrics/<metric>.py``: ``read(run) -> float | None`` for one metric,
  end to end or per layer;
- ``limits/<cell>.json``: the limit of each number the check compares.

A later cell or metric is a new file and a new entry, never an edit.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]   # portbench/
ROOT = HERE.parent                           # the checkout


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.cells = {w["name"]: w for w in self.spec["workloads"]}
        self.configs = {c["name"]: c for c in self.spec["configs"]}

    def cell(self, name):
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        return self.cells[name]

    def config(self, name):
        """The configuration record and its loss module."""
        entry = self.configs[name]
        path = self.root / entry["file"]
        cfg = json.loads(path.read_text())
        loss = load_module(path.with_suffix(".py"), f"portbench_config_{len(name)}")
        return cfg, loss

    def traffic(self, name):
        return json.loads((HERE / "traffic" / f"{name}.json").read_text())

    def limits(self, cell):
        return json.loads((HERE / "limits" / f"{cell}.json").read_text())

    def metric(self, name):
        return load_module(HERE / "metrics" / f"{name}.py", "portbench_metric")

    def metrics_for(self, cell, trace: bool):
        """The metric entries a run of ``cell`` reports: its end-to-end
        metrics untraced, its per-layer metrics traced."""
        e2e = [m for m in self.spec["end_to_end"]
               if "workloads" not in m or cell in m["workloads"]]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
