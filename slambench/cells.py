"""What ``BENCHMARK.json`` names, found by name: the cell, its
configuration file, its family, its traffic mix and the readers of its
metrics.

* a configuration is ``configs/<name>.json`` (the file ``BENCHMARK.json``
  gives): the generated graph (``graph``, its ``kind`` and parameters),
  the optimizer as it is run (``optimizer``,
  ``toyslam_torch.config.OptimizerConfig``'s fields), the numbers
  ``correct`` compares with their limits, and ``family``, the name of its
  family (``"se2"`` where absent);
* a family is ``families/<name>.py``: the kind of problem a configuration
  solves, with the program's graph of the generated arrays, the plain
  reference and the comparison that decide ``correct``
  (``families/se2.py`` says what it provides);
* a traffic mix is ``traffic/<name>.json``: the driver that calls the
  program, its warm-up and traced-window lengths, and ``graph`` keys that
  override the configuration's;
* a graph kind is ``graphs/<kind>.py`` with ``generate(seed, **params)``;
* a driver is ``drivers/<name>.py`` with a class ``Driver``
  (``drivers/batch.py`` says what it provides);
* a per-layer metric is ``metrics/<name>.py`` with ``read(readings)``,
  which returns a number or None where it finds nothing to read.

A cell, a configuration, a family, a graph kind, a driver or a metric is
added by adding its files and its ``BENCHMARK.json`` entries.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = "slambench"


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    config_file: Path
    family: str             # families/<family>.py
    traffic: dict
    graph: dict             # the configuration's graph with the mix's keys
    end_to_end: list        # BENCHMARK.json entries this cell reports
    per_layer: list
    root: Path              # the checkout that names the cell


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; BENCHMARK.json has "
                       f"{sorted(work)}")
    w = work[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config_file = root / cfg_entry["file"]
    config = json.loads(config_file.read_text())
    traffic = json.loads(
        (root / PACKAGE / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=name, chips=w["chips"], config=config, config_file=config_file,
        family=config.get("family", "se2"), traffic=traffic,
        graph={**config["graph"], **traffic.get("graph", {})},
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        root=root,
    )


FORBIDDEN = ("jax", "jaxlib", "flax", "toyslam_tpu")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that no run may hold: JAX and the
    JAX package (compared whole: ``toyslam_torch`` is not ``toyslam_tpu``)."""
    import sys

    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load(folder: str, name: str, root: Path = ROOT):
    """The module ``slambench/<folder>/<name>.py`` of ``root``."""
    path = root / PACKAGE / folder / f"{name}.py"
    if not path.exists():
        raise KeyError(f"no {path.relative_to(root)}")
    spec = importlib.util.spec_from_file_location(
        f"{PACKAGE}.{folder}.{name.replace('.', '_').replace('-', '_')}",
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``metrics/<metric>.py``."""
    return load("metrics", metric, root).read


def driver(c: Cell):
    """The ``Driver`` class of the cell's traffic mix."""
    return load("drivers", c.traffic["driver"], c.root).Driver


def family(c: Cell):
    """The module ``families/<family>.py`` of the cell's configuration."""
    return load("families", c.family, c.root)
