"""The host state machine (`slam.py`): the share of the window's time
spent on frames that the state machine ran outside OK or left OK on (a
reset: the frame that lost track or found its biases corrupted, then the
bootstrap's SYNC, SfM and initializing frames up to the first OK frame),
by the harness clock."""


def read(run):
    r = run.record
    return 100.0 * r.reset_ms / (r.window_s * 1e3) if r.frames else None
