"""Frames completed in the window over the window's seconds (every lane's
frames in a batch)."""

from vio_bench import arith


def read(run):
    r = run.record
    return arith.rate(r.frames, r.window_s) if r.frames else None
