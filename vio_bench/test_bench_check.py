"""The verdict of `check.py` on poses made up for it: every lane-frame
counts, so a quarter of a batch's lanes, or one lane, gone wrong fails the
cell although the others agree, and a pose that is not finite fails it
whatever the limits name."""

import math
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from vio_bench import check  # noqa: E402

LIMITS = {"pos_gap_max_m": 5e-5, "rot_gap_max_rad": 5e-6}


class _Reference:
    """Poses of 2 steps of 64 lanes: lane j at (j, 0, 0), no rotation."""

    lanes, steps = 64, 2

    def run(self, sample, world, tf32=False):
        p = np.zeros((self.lanes, 3))
        p[:, 0] = np.arange(self.lanes)
        q = np.tile([1.0, 0.0, 0.0, 0.0], (self.lanes, 1))
        return [(p.copy(), q.copy(), np.zeros(self.lanes, bool)) for _ in range(self.steps)]


def _found(program):
    sample = check.Sample(None, [], [[0] * 64, [1] * 64], batched=True)
    ref = _Reference()
    truth = ref.run(sample, None)
    return check.gaps(ref, [sample], None, lambda s, k: program(truth[k][0].copy(),
                                                              truth[k][1].copy(), k))


def test_agreeing_poses_are_correct():
    found = _found(lambda p, q, k: (p, q))
    ok, shown = check.verdict(found, LIMITS)
    assert ok and found["frames"] == 128 and found["pos_gap_max_m"] == 0.0
    assert list(shown)[-2:] == ["nonfinite_poses", "frames_compared"]


@pytest.mark.parametrize("lanes", [slice(48, 64), slice(7, 8)])
def test_some_lanes_wrong_fail(lanes):
    def program(p, q, k):
        if k == 1:
            p[lanes, 1] += 0.02
        return p, q
    found = _found(program)
    assert not check.verdict(found, LIMITS)[0]


@pytest.mark.parametrize("limits", [LIMITS, {"rot_gap_max_rad": 5e-6}])
def test_a_pose_not_finite_fails(limits):
    def program(p, q, k):
        p[3, 2] = math.inf if k == 0 else p[3, 2]
        return p, q
    found = _found(program)
    ok, shown = check.verdict(found, limits)
    assert not ok and shown["nonfinite_poses"]["value"] == 1
