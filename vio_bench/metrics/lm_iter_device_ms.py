"""One LM iteration of the motion-only BA (`backend/lm.py`) on the device:
the `lm.ba` spans (a WHILE body's run in the stream cells, an iteration
of the fixed loop under `vmap` in the batch cells), mean over the
iterations run in the window."""

from vio_bench import stamps


def read(run):
    t = stamps.program_trace(run)
    if t is None:
        return None
    return stamps.mean([(s.end - s.start) / 1e6 for s in t.spans
                        if s.kind == "device" and s.name == "lm.ba"])
