"""What a run of a cell measured and kept: the traffic drivers fill it,
the metric readers (`metrics/`) and the comparison read it."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Record:
    frames: int = 0                 # frames completed in the window (lane-frames in a batch)
    window_s: float = 0.0
    setup_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    latencies_ms: list = dataclasses.field(default_factory=list)   # a stream's frames
    host_ms: list = dataclasses.field(default_factory=list)        # process() calls
    sync_ms: list = dataclasses.field(default_factory=list)        # the waits after them
    reset_ms: float = 0.0           # a stream's frames run outside OK, or leaving it
    bootstrap_s: float | None = None
    setup_frames: int = 0
    lm_iters: list | None = None    # the motion-only BA's iterations a frame (traced run)
    graph_nodes: int | None = None
    trace: object = None            # trace.Trace of the traced stretch
    program_trace: object = None    # the program's spans over the window (traced run)
    eager_in_window: int = 0
    memory_peak_bytes: int = 0
    samples: list = dataclasses.field(default_factory=list)
    world: object = None
    program_pose: object = None
