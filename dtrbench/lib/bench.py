"""Find the benchmark's parts by name, so that a later change adds a file
and edits none:

- a configuration: ``configs/<name>.json``, its plain reference
  ``reference/<family>.py`` (the file's ``family``);
- a cell: ``workloads/<name>.json``, naming a configuration and a traffic
  mix;
- a traffic mix: ``traffic/<name>.json``, the parameters the one
  generator reads (batch, sequence, remat policy, optimizer, learning
  rate, the token stream's Zipf exponent);
- a per-layer metric: ``metrics/<name>.py``, whose ``read(run)`` returns
  a number, or None where the run has nothing to read.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


class Bench:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)

    def _json(self, kind: str, name: str) -> dict:
        path = self.root / kind / f"{name}.json"
        if not path.is_file():
            known = sorted(p.stem for p in (self.root / kind).glob("*.json"))
            raise KeyError(f"no {kind[:-1] if kind != 'traffic' else kind} "
                           f"named {name!r} under {self.root / kind}; "
                           f"known: {known}")
        data = json.loads(path.read_text())
        if data.get("name", name) != name:
            raise ValueError(f"{path} names itself {data['name']!r}")
        return data

    def cell(self, name: str) -> dict:
        return self._json("workloads", name)

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def cells(self) -> list:
        return sorted(p.stem for p in (self.root / "workloads").glob("*.json"))

    def family(self, config: dict):
        """The configuration's plain reference module."""
        fam = config["family"]
        path = self.root / "reference" / f"{fam}.py"
        if not path.is_file():
            raise KeyError(f"no reference {path}")
        if self.root == ROOT:
            return importlib.import_module(f"dtrbench.reference.{fam}")
        return _load(path, f"dtrbench.reference.{fam}")

    def metric_names(self) -> list:
        return sorted(p.stem for p in (self.root / "metrics").glob("*.py")
                      if not p.stem.startswith("_"))

    def metric(self, name: str):
        """The reader of the per-layer metric ``name``."""
        path = self.root / "metrics" / f"{name}.py"
        if not path.is_file():
            raise KeyError(f"no metric reader {path}")
        return _load(path, "dtrbench_metric_" + name.replace(".", "_")
                     .replace("-", "_")).read


def _load(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
