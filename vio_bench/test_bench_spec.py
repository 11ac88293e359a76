"""The manifest's `program` key (`spec.py`): its fields reach the
program's configuration and the reference's, under the rehearsal's sizes;
a cell with keyframe full BA on comes from new files only and holds its
spans; a field that either side's `VIOConfig` lacks, or that `assumed`
does not name, stops the run before it measures; and a manifest without
the key loads to exactly the configuration the YAML gives, on both
sides."""

import dataclasses
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from vio_bench import check, spec  # noqa: E402
from vio_bench import run as bench  # noqa: E402
from vio_bench.test_bench_run import keep_views  # noqa: E402

CELLS = ("euroc-stream", "euroc-batch64", "kitti-stream", "kitti-batch32")


def _bench_with(tmp_path, program, assumed):
    """A BENCHMARK.json beside the repository's with one more cell,
    `euroc-x-stream`: euroc-mav's YAML and manifest with `program` and the
    `assumed` entries added."""
    root = tmp_path / "bench"
    cfg = root / "vio_bench" / "configs" / "euroc-x"
    cfg.mkdir(parents=True)
    shutil.copy(ROOT / "vio_bench/configs/euroc-mav/config.yml", cfg / "config.yml")
    manifest = json.loads((ROOT / "vio_bench/configs/euroc-mav/config.json").read_text())
    manifest.update(name="euroc-x", program=program)
    manifest["assumed"].update(assumed)
    (cfg / "config.json").write_text(json.dumps(manifest))
    for d in ("traffic", "limits"):
        shutil.copytree(ROOT / "vio_bench" / d, root / "vio_bench" / d)
    shutil.copy(ROOT / "vio_bench/limits/euroc-stream.json",
                root / "vio_bench/limits/euroc-x-stream.json")
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "euroc-x", "source": "test", "reduced": [], "why": "test",
                         "file": "vio_bench/configs/euroc-x/config.json"})
    b["workloads"].append({"name": "euroc-x-stream", "config": "euroc-x", "traffic": "stream",
                           "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return root / "BENCHMARK.json"


FULL_BA = {"full_ba_keyframes": True, "full_ba_iterations": 5}
REASONS = {"full_ba_keyframes": "a test", "full_ba_iterations": "a test"}


def test_program_fields_reach_both_sides(tmp_path):
    path = _bench_with(tmp_path, FULL_BA, REASONS)
    for rehearse in (False, True):
        cell = spec.load_cell("euroc-x-stream", rehearse=rehearse, bench_path=path)
        cfg = spec.program_config(cell, rehearse)
        assert cfg.full_ba_keyframes is True and cfg.full_ba_iterations == 5
        ov = spec.reference_overrides(cell, rehearse)
        assert {k: ov[k] for k in FULL_BA} == FULL_BA
        # the rehearsal's sizes come after the program's fields
        want_w = cell.config["rehearsal"]["image_width"] if rehearse else 752
        assert cfg.image_width == want_w and ov.get("image_width", 752) == want_w
    ref = check.Reference(cell.yaml, "euroc", ov, "cpu")
    assert ref.static.full_ba_keyframes is True and ref.static.full_ba_iterations == 5


def test_a_full_ba_cell_from_new_files_only(tmp_path, capsys, monkeypatch):
    path = _bench_with(tmp_path, FULL_BA, REASONS)
    views = keep_views(monkeypatch)
    rc = bench.main(["--workload", "euroc-x-stream", "--seed", str(2**31 + 61), "--seconds", "6",
                     "--rehearse", "--trace", "1", "--bench", str(path)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert line["correct"] is True and line["checks"]["frames_compared"]["value"] >= 1
    # the window ran full BA (which frames the seed draws for the comparison,
    # keyframes or not, depends on the window's length; the reference's full
    # BA on keyframes is held to the port's in test_bench_full_ba.py)
    names = {s.name for s in views[-1].record.program_trace.spans}
    assert {"lm.full_ba", "cond.full_ba"} <= names


@pytest.mark.parametrize("field,side", [("no_such_field", "the program"),
                                        ("rectify_mode", "the reference")])
def test_a_field_either_side_lacks_stops_the_run(tmp_path, field, side):
    """`rectify_mode` is the program's and not the frozen reference's."""
    path = _bench_with(tmp_path, {field: "sparse"}, {field: "a test"})
    with pytest.raises(ValueError, match=f"{side}'s VIOConfig has no field.*{field}"):
        bench.main(["--workload", "euroc-x-stream", "--seed", "1", "--seconds", "1",
                    "--rehearse", "--bench", str(path)])


def test_a_field_not_assumed_does_not_load(tmp_path):
    path = _bench_with(tmp_path, FULL_BA, {"full_ba_keyframes": "a test"})
    with pytest.raises(ValueError, match="full_ba_iterations.*not named under 'assumed'"):
        spec.load_cell("euroc-x-stream", bench_path=path)


def _same_config(a, b):
    assert type(a) is type(b)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert type(x) is type(y) and x == y, f.name


@pytest.mark.parametrize("workload", CELLS)
def test_manifests_without_the_key_load_as_the_yaml_gives(workload):
    from pose_estimation_tpu_torch import load_config
    from vio_bench.ref.utils.config import load_config as ref_load

    for rehearse in (False, True):
        cell = spec.load_cell(workload, rehearse=rehearse)
        assert "program" not in cell.config
        dataset = cell.config["dataset"]
        want = load_config(cell.yaml, dataset=dataset)
        ref_want = {}
        if rehearse:
            want = dataclasses.replace(want, **spec.rehearsal_overrides(cell, want))
            ref_want = spec.rehearsal_overrides(cell, ref_load(cell.yaml, dataset))
        _same_config(spec.program_config(cell, rehearse), want)
        ov = spec.reference_overrides(cell, rehearse)
        assert sorted(ov) == sorted(ref_want)
        for k, v in ref_want.items():
            assert np.array_equal(ov[k], v) and type(ov[k]) is type(v), k
