"""The comparison's control (`control.py`): on the CPU, at the rehearsal's
size, both readings come out for each seed (TF32 does not exist there, so
the control reads as the program does); on the card, at each cell's own
size and on three seeds, the control, the reference in TF32, reads far
above the program and fails the cell's limits."""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from vio_bench import check, control  # noqa: E402


def _readings(capsys, workload, seeds, device, rehearse=True):
    rc = control.main(["--workload", workload, "--seeds", seeds, "--seconds", "3",
                       "--device", device, *(["--rehearse"] if rehearse else [])])
    assert rc == 0
    return [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]


def test_control_reads_both_on_the_cpu(capsys):
    lines = _readings(capsys, "kitti-batch32", "4", "cpu")
    assert len(lines) == 1
    for side in ("program", "control"):
        assert lines[0][side]["frames"] >= 1
        assert set(check.NUMBERS) <= set(lines[0][side])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["euroc-stream", "euroc-batch64", "kitti-stream",
                                      "kitti-batch32"])
def test_control_fails_on_the_card(capsys, workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only there")
    limits = json.loads((ROOT / "vio_bench" / "limits" / f"{workload}.json").read_text())
    lines = _readings(capsys, workload, "1-3", "cuda", rehearse=False)
    with capsys.disabled():
        for line in lines:
            print(json.dumps(line))
    for line in lines:
        prog, ctrl = line["program"], line["control"]
        assert ctrl["pos_gap_max_m"] > 3 * prog["pos_gap_max_m"]
        assert not check.verdict(ctrl, limits)[0]
