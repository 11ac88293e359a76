"""The host state machine (`slam.py`): the harness clock from the call to
`process` to its return, mean over the window's frames outside the traced
stretch. It includes the waits that `process` makes itself at health
checks and refinements."""


def read(run):
    h = run.record.host_ms
    return sum(h) / len(h) if h else None
