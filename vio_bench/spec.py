"""A cell of `BENCHMARK.json` and the files it names: the configuration
(`configs/<name>/config.json`, which names its OpenCV-YAML file), the
traffic mix (`traffic/<name>.json`), the comparison's limits
(`limits/<cell>.json`) and the metrics the cell reports (each a reader in
`metrics/<metric>.py`). Nothing here knows a cell by name: a new cell is
new files and entries.

A configuration's manifest may carry `program`: `VIOConfig` fields that
the upstream YAML does not (such as `{"full_ba_keyframes": true}`), each
also named under `assumed` with its reason. They are applied to the
program's configuration and to the reference's alike, before the
rehearsal's sizes; a field that either side's `VIOConfig` lacks stops the
run."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict          # the configuration's manifest
    config_dir: Path
    traffic: dict
    chips: int
    end_to_end: list      # BENCHMARK.json metric entries reported with --trace 0
    per_layer: list       # ... and with --trace 1
    limits: dict          # number compared -> limit

    @property
    def yaml(self) -> Path:
        return self.config_dir / self.config["yaml"]


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in reported


def load_cell(workload: str, rehearse: bool = False, bench_path: Path | None = None) -> Cell:
    """The cell `workload` of `bench_path` (the repository's
    BENCHMARK.json by default), its files read beside it; with `rehearse`
    the traffic's `rehearsal` parameters override its own."""
    bench_path = Path(bench_path or ROOT / "BENCHMARK.json")
    root = bench_path.parent
    data = root / HERE.name
    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json ({sorted(cells)})")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    manifest = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((data / "traffic" / f"{w['traffic']}.json").read_text())
    if rehearse:
        traffic.update(traffic.get("rehearsal", {}))
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload, reported)]
    limits = json.loads((data / "limits" / f"{workload}.json").read_text())
    program = manifest.get("program", {})
    if not isinstance(program, dict):
        raise ValueError(f"configuration {w['config']!r}: 'program' is not an object")
    unnamed = sorted(set(program) - set(manifest.get("assumed", {})))
    if unnamed:
        raise ValueError(f"configuration {w['config']!r}: program field(s) {unnamed} "
                         "not named under 'assumed' with a reason")
    return Cell(workload, manifest, (root / cfg_entry["file"]).parent, traffic, int(w["chips"]),
                e2e, per_layer, limits)


def program_fields(cell: Cell, config_type, side: str) -> dict:
    """The manifest's `program` fields, each checked to be a field of
    `config_type` (`side`'s `VIOConfig`)."""
    fields = cell.config.get("program", {})
    unknown = sorted(set(fields) - {f.name for f in dataclasses.fields(config_type)})
    if unknown:
        raise ValueError(f"configuration {cell.config['name']!r}: {side}'s VIOConfig has no "
                         f"field(s) {unknown} (the manifest's 'program')")
    return dict(fields)


def program_config(cell: Cell, rehearse: bool):
    """The configuration as the replay CLIs load it (the program's
    `load_config` of the YAML, with the manifest's `program` fields), at
    the rehearsal's tiny size with `rehearse`."""
    import dataclasses as dc

    from pose_estimation_tpu_torch import load_config
    from pose_estimation_tpu_torch.utils.config import VIOConfig

    cfg = load_config(cell.yaml, dataset=cell.config["dataset"],
                      **program_fields(cell, VIOConfig, "the program"))
    return dc.replace(cfg, **rehearsal_overrides(cell, cfg)) if rehearse else cfg


def reference_overrides(cell: Cell, rehearse: bool) -> dict:
    """The reference's changes to its own load of the YAML
    (`check.Reference`'s `overrides`): the manifest's `program` fields,
    then with `rehearse` the rehearsal's sizes."""
    from vio_bench.ref.utils.config import VIOConfig, load_config

    fields = program_fields(cell, VIOConfig, "the reference")
    if not rehearse:
        return fields
    cfg = load_config(cell.yaml, cell.config["dataset"], **fields)
    return {**fields, **rehearsal_overrides(cell, cfg)}


def rehearsal_overrides(cell: Cell, cfg) -> dict:
    """The rehearsal's changes to a loaded configuration (either package's
    `VIOConfig`): its sizes, and the intrinsics scaled to its width."""
    r = dict(cell.config["rehearsal"])
    scale = r.pop("focal_scale")
    k = {}
    for key in ("k_left", "k_right"):
        m = np.array(getattr(cfg, key), np.float64)
        m[0, 0] *= scale
        m[1, 1] *= scale
        m[0, 2], m[1, 2] = r["image_width"] / 2, r["image_height"] / 2
        k[key] = m
    return {**r, **k}


def reader(metric: str):
    """The reader of `metric`: `read(run) -> float | None` of
    `metrics/<metric>.py`."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"vio_bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
