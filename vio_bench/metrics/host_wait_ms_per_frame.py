"""The host state machine (`slam.py`) waiting for the device inside
`process`: the host spans `slam.wait` (the health check's read, the
refinement's and the recovery's gates, the SfM reads) under `slam.process`,
summed over the window, over its frames."""

from vio_bench import stamps


def read(run):
    t = stamps.program_trace(run)
    if t is None:
        return None
    frames = {s.frame for s in t.spans if s.kind == "host" and s.name == "slam.process"}
    if not frames:
        return None
    waits = sum(s.end - s.start for s in t.spans
                if s.kind == "host" and s.name == "slam.wait" and s.frame in frames)
    return waits / 1e6 / len(frames)
