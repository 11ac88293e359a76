"""The backend (`backend/lm.py`, `backend/ba.py`) on the device: a
replay's `ok_step.backend` spans (the BA's solve with its WHILE and IF
bodies, the PSD clip, the marginalization), summed, mean over the
window's replays of the frame or batch graph."""

from vio_bench import stamps


def read(run):
    t = stamps.program_trace(run)
    if t is None:
        return None
    return stamps.mean(stamps.per_replay_ms(t, ("ok_step.backend",)))
