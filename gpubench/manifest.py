"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of `workloads`) names a configuration and a traffic mix;
the harness reads, all under this package:

  configs/<config>.json     the configuration (the `file` of its entry)
  traffic/<traffic>.json    the traffic mix: its generator `kind`
                            (gen/<kind>.py) and that generator's parameters
  limits/<workload>.json    the limit of each number `correct` compares
  metrics/<metric>.py       the reader of one per-layer metric: a function
                            read(record) -> float or None

A later cell, configuration, traffic mix or per-layer metric is new files
and a new entry; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent


class Manifest:
    def __init__(self, path: Path, here: Path = HERE):
        self.path = Path(path)
        self.doc = json.loads(self.path.read_text())
        self.root = self.path.parent
        self.here = Path(here)

    def workload(self, name: str) -> Dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in {self.path}")

    def config(self, name: str) -> Dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in {self.path}")

    def traffic(self, name: str) -> Dict:
        return json.loads((self.here / "traffic" / f"{name}.json").read_text())

    def limits(self, workload: str) -> Dict[str, float]:
        p = self.here / "limits" / f"{workload}.json"
        return json.loads(p.read_text())["limits"] if p.exists() else {}

    def end_to_end(self, workload: str) -> List[Dict]:
        return [m for m in self.doc["end_to_end"]
                if "workloads" not in m or workload in m["workloads"]]

    def per_layer(self, workload: str) -> List[Dict]:
        moved = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.doc["per_layer"]
                if workload in m.get("workloads", ())
                or ("workloads" not in m and m["moves"] in moved)]

    def reader(self, metric: str) -> Callable[[Dict], Optional[float]]:
        path = self.here / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "gpubench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
