"""The frame step (`models/vio.py`) on the device: the frame graph's (or
the batched step's) replay from its first stamp to its last
(`graph.frame`, `graph.batch`), mean over the window's replays."""

from vio_bench import stamps


def read(run):
    t = stamps.program_trace(run)
    if t is None:
        return None
    return stamps.mean([(s.end - s.start) / 1e6 for s in stamps.graph_replays(t)])
