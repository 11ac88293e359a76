"""The front end (`ops/`, `frontend/`) on the device: a replay's ORB
extraction and matching spans (`ok_step.extract`, `ok_step.match`),
summed, mean over the window's replays of the frame or batch graph."""

from vio_bench import stamps


def read(run):
    t = stamps.program_trace(run)
    if t is None:
        return None
    return stamps.mean(stamps.per_replay_ms(t, ("ok_step.extract", "ok_step.match")))
