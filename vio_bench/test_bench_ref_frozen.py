"""With keyframe full BA off, the frozen reference runs the same operations
in the same order as before that branch came into it, so it gives the same
bits: for each cell, at the rehearsal's size, the poses and keyframe flags
of `STEPS` frames run from the truth (a stream cell's one sequence through
`ok_step`, a batch cell's lanes through the batched step), held to those
the reference gave before, kept in `test_bench_ref_frozen.json` (as
`float.hex`). The file was recorded on an x86-64 CPU with PyTorch 2.13;
another CPU or PyTorch may round differently, and then this test says so
for the reference as it stands, full BA or not.

    python3 vio_bench/test_bench_ref_frozen.py --record

writes the file anew from the `vio_bench` beside this file: do so only
from a reference known to be the one the file should hold."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CELLS = ("euroc-stream", "euroc-batch64", "kitti-stream", "kitti-batch32")
STEPS = 8
FILE = Path(__file__).with_suffix(".json")


def poses(workload: str) -> list:
    """[[p, q, keyframe] a step, each over the lanes], as `float.hex`."""
    import torch

    from vio_bench import check, spec
    from vio_bench.ref.utils.config import load_config
    from vio_bench.world import Rig, World

    before = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        cell = spec.load_cell(workload, rehearse=True)
        dataset, w, tr = cell.config["dataset"], cell.config["world"], cell.traffic
        c = load_config(cell.yaml, dataset)
        ov = spec.rehearsal_overrides(cell, c)
        import dataclasses

        c = dataclasses.replace(c, **ov)
        b, off = int(tr.get("lanes", 1)), int(tr.get("lane_offset", 0))
        world = World(Rig(c.image_width, c.image_height, c.k_left, c.r_cb, c.t_lr),
                      c.profile.gravity_dir, c.sampling_rate, c.camera_frequency, c.imu_chunk,
                      2 + off * (b - 1) + STEPS, int(w["seed"]), w["landmarks_per_m"],
                      w["imu_noise"], "cpu")
        ref = check.Reference(cell.yaml, dataset, ov, "cpu")
        if tr["kind"] == "batch":
            sample = check.Sample(None, [], [[1 + off * j + k for j in range(b)]
                                             for k in range(STEPS)],
                                  batched=True, gen_seeds=[int(w["seed"]) + j for j in range(b)])
        else:
            gen = torch.Generator().manual_seed(7)
            sample = check.Sample(check.copy_leaves(ref.seeded(world, 1)), [gen.get_state()],
                                  [[1 + k] for k in range(STEPS)])
        out = ref.run(sample, world)
    finally:
        torch.set_num_threads(before)
    return [[[[float(x).hex() for x in row] for row in p], [[float(x).hex() for x in row]
                                                          for row in q], [bool(k) for k in kf]]
            for p, q, kf in out]


@pytest.mark.parametrize("workload", CELLS)
def test_reference_without_full_ba_gives_the_bits_it_gave(workload):
    want = json.loads(FILE.read_text())[workload]
    got = poses(workload)
    assert any(kf for _, _, kfs in got[1:] for kf in kfs), "no keyframe after the first frame"
    assert got == want


if __name__ == "__main__":
    if sys.argv[1:] != ["--record"]:
        sys.exit(__doc__)
    FILE.write_text("{\n" + ",\n".join(f"{json.dumps(w)}: {json.dumps(poses(w))}" for w in CELLS)
                    + "\n}\n")
    print(FILE)
