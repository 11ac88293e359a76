"""The harness end to end on the CPU: each traffic kind's rehearsal comes
out correct, and traced keeps the program's own spans for the readers of
them; a cell added from new files only runs; the timed path broken
underneath (a step that returns its state unchanged, half the batch left
out, an answer altered where it is produced) comes out not correct; a run
without a card, or without the program beside the benchmark, exits
non-zero and prints no result; and nothing `run.py` or the reference
loads is JAX, Flax or the JAX package (the reference loads nothing of the
port either)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from vio_bench import run as bench  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "pose_estimation_tpu"}


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    yield
    torch.set_num_threads(before)


def _rehearse(capsys, workload, seed, extra=(), seconds=1.5):
    rc = bench.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                     "--rehearse", *extra])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


@pytest.mark.parametrize("workload,seed", [("euroc-stream", 2**31 + 11),
                                           ("kitti-stream", 5),
                                           ("euroc-batch64", 2**31 + 12),
                                           ("kitti-batch32", 6)])
def test_rehearsal_is_correct(capsys, workload, seed):
    line = _rehearse(capsys, workload, seed)
    assert line["correct"] is True, line
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["metrics"] == {} and line["device"]["platform"] == "cpu"
    assert list(line)[-1] == "checks"
    assert line["checks"]["frames_compared"]["value"] >= 1


PROGRAM_SPAN_READERS = ("frame_device_ms", "frontend_device_ms", "backend_device_ms",
                        "lm_iter_device_ms", "device_idle_share_stamped",
                        "host_wait_ms_per_frame")


def keep_views(monkeypatch) -> list:
    """The `RunView`s that the metric readers of the runs that follow read."""
    views = []

    class Kept(bench.RunView):
        def __init__(self, *a):
            super().__init__(*a)
            views.append(self)

    monkeypatch.setattr(bench, "RunView", Kept)
    return views


@pytest.mark.parametrize("workload,seed", [("euroc-stream", 2**31 + 31), ("kitti-batch32", 32)])
def test_traced_rehearsal_keeps_the_program_spans(capsys, monkeypatch, workload, seed):
    """On the CPU the host clock stands in for the device's timer, so the
    program's spans are there; the profiler records no device work, so the
    readers that lay them against it find nothing, and none raises. The
    profiler's start falls inside the window, hence its longer length."""
    from pose_estimation_tpu_torch import profiling
    from vio_bench import spec

    views = keep_views(monkeypatch)
    line = _rehearse(capsys, workload, seed, ("--trace", "1"), seconds=6)
    assert line["correct"] is True, line
    trace = views[-1].record.program_trace
    assert {"ok_step.backend", "lm.ba"} <= {s.name for s in trace.spans}
    for name in PROGRAM_SPAN_READERS:
        value = spec.reader(name)(views[-1])
        assert value is None or value >= 0, name
    assert profiling.stamp_count() == 0       # tracing is off again after the run


def test_untraced_run_keeps_no_program_spans(capsys, monkeypatch):
    views = keep_views(monkeypatch)
    assert _rehearse(capsys, "kitti-stream", 33)["correct"] is True
    assert views[-1].record.program_trace is None and views[-1].record.trace is None


def _keep_lanes(monkeypatch, share):
    """The batched step leaves out the last `share` of its lanes: their
    state and pose stay as they were."""
    from pose_estimation_tpu_torch.parallel import batched
    from pose_estimation_tpu_torch.utils import lie
    from pose_estimation_tpu_torch.utils.tree import tree_map

    orig = batched.make_batched_step

    def make(consts, static, mesh=None):
        step = orig(consts, static, mesh)

        def partial_step(state_b, *inputs):
            new, m = step(state_b, *inputs)
            h = int(state_b.win.p.shape[0] * (1 - share))

            def keep(n, o):
                return torch.cat([n[:h], o[h:]])
            m = dict(m, rec_p=keep(m["rec_p"], state_b.win.p[:, -1]),
                     rec_quat=keep(m["rec_quat"], lie.mat_to_quat(state_b.win.R[:, -1])))
            return tree_map(keep, new, state_b), m
        return partial_step

    monkeypatch.setattr(batched, "make_batched_step", make)


def _unchanged(monkeypatch):
    """A frame step that returns its state unchanged, and its pose."""
    from pose_estimation_tpu_torch.models import vio
    from pose_estimation_tpu_torch.utils import lie

    orig = vio.ok_step

    def unchanged(state, *a, **k):
        _, m = orig(state, *a, **k)
        return state, dict(m, rec_p=state.win.p[-1], rec_quat=lie.mat_to_quat(state.win.R[-1]))

    monkeypatch.setattr(vio, "ok_step", unchanged)
    _keep_lanes(monkeypatch, 1.0)


def _half_batch(monkeypatch):
    _keep_lanes(monkeypatch, 0.5)


def _altered(monkeypatch):
    """Each frame's pose altered by 2 cm where the step produces it."""
    from pose_estimation_tpu_torch.models import vio

    orig = vio.frame_outputs

    def altered(*a, **k):
        m = orig(*a, **k)
        return dict(m, rec_p=m["rec_p"] + 0.02)

    monkeypatch.setattr(vio, "frame_outputs", altered)


@pytest.mark.parametrize("fault,workload", [(_unchanged, "euroc-stream"),
                                            (_unchanged, "euroc-batch64"),
                                            (_half_batch, "kitti-batch32"),
                                            (_altered, "kitti-stream"),
                                            (_altered, "euroc-batch64")])
def test_broken_step_is_not_correct(capsys, monkeypatch, fault, workload):
    fault(monkeypatch)
    line = _rehearse(capsys, workload, 17)
    assert line["correct"] is False, line


def test_a_cell_from_new_files_only(capsys, tmp_path):
    """A configuration, a traffic mix, a limits file and a cell added as
    files and entries, with no file of the harness edited."""
    bench_json = json.loads((ROOT / "BENCHMARK.json").read_text())
    new_cfg = tmp_path / "vio_bench" / "configs" / "euroc-fast"
    new_cfg.mkdir(parents=True)
    yml = (ROOT / "vio_bench/configs/euroc-mav/config.yml").read_text()
    (new_cfg / "config.yml").write_text(yml.replace("numberOfFeatures: 800",
                                                    "numberOfFeatures: 400"))
    manifest = json.loads((ROOT / "vio_bench/configs/euroc-mav/config.json").read_text())
    manifest["name"] = "euroc-fast"
    (new_cfg / "config.json").write_text(json.dumps(manifest))
    (tmp_path / "vio_bench" / "traffic").mkdir()
    traffic = json.loads((ROOT / "vio_bench/traffic/stream.json").read_text())
    traffic["rehearsal"]["warm_frames"] = 2
    (tmp_path / "vio_bench/traffic/stream-warm.json").write_text(json.dumps(traffic))
    (tmp_path / "vio_bench" / "limits").mkdir()
    shutil.copy(ROOT / "vio_bench/limits/euroc-stream.json",
                tmp_path / "vio_bench/limits/euroc-fast-stream.json")
    bench_json["configs"].append({"name": "euroc-fast", "source": "test",
                                  "file": "vio_bench/configs/euroc-fast/config.json",
                                  "reduced": [], "why": "test"})
    bench_json["workloads"].append({"name": "euroc-fast-stream", "config": "euroc-fast",
                                    "traffic": "stream-warm", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench_json))
    line = _rehearse(capsys, "euroc-fast-stream", 23,
                     ("--bench", str(tmp_path / "BENCHMARK.json")))
    assert line["correct"] is True and line["attempted"] > 0


def _run(args, cwd, **kw):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True, text=True,
                          timeout=600, env=env, **kw)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would measure")
    p = _run(["vio_bench/run.py", "--workload", "euroc-stream", "--seed", "1", "--seconds",
              "1"], ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "vio_bench", tmp_path / "vio_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(["vio_bench/run.py", "--workload", "euroc-stream", "--seed", "1", "--seconds",
              "1", "--rehearse"], tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


_LIST_MODULES = """
import atexit, json, runpy, sys
out = sys.argv[1]
atexit.register(lambda: open(out, "w").write(json.dumps(sorted(sys.modules))))
sys.argv = sys.argv[2:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""

_REFERENCE_ONLY = """
import json, sys
sys.path.insert(0, ".")
import numpy as np
from vio_bench import check, spec
from vio_bench.ref.utils.config import load_config
from vio_bench.world import Rig, World
cell = spec.load_cell("euroc-batch64", rehearse=True)
ov = spec.rehearsal_overrides(cell, load_config(cell.yaml, "euroc"))
ref = check.Reference(cell.yaml, "euroc", ov, "cpu")
c = load_config(cell.yaml, "euroc")
import dataclasses; c = dataclasses.replace(c, **ov)
w = World(Rig(c.image_width, c.image_height, c.k_left, c.r_cb, c.t_lr), c.profile.gravity_dir,
          c.sampling_rate, c.camera_frequency, c.imu_chunk, 4, 1, 20.0, 2.4e-3, "cpu")
import torch
state = check.copy_leaves(ref.template)
s = check.Sample(state, [torch.Generator().manual_seed(1).get_state()], [[1], [2]])
out = ref.run(s, w)
assert len(out) == 2
open(sys.argv[1], "w").write(json.dumps(sorted(sys.modules)))
"""


def test_nothing_loaded_is_jax_and_the_reference_loads_no_port(tmp_path):
    mods = tmp_path / "run.json"
    p = _run(["-c", _LIST_MODULES, str(mods), "vio_bench/run.py", "--workload",
              "kitti-batch32", "--seed", "3", "--seconds", "1", "--rehearse"], ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    tops = {m.split(".")[0] for m in json.loads(mods.read_text())}
    assert "pose_estimation_tpu_torch" in tops and "vio_bench" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    ref_mods = tmp_path / "ref.json"
    p = _run(["-c", _REFERENCE_ONLY, str(ref_mods)], ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    tops = {m.split(".")[0] for m in json.loads(ref_mods.read_text())}
    assert "vio_bench" in tops
    assert not tops & (FORBIDDEN | {"pose_estimation_tpu_torch"}), tops
