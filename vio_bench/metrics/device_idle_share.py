"""The share of the traced stretch in which no kernel, copy or set ran on
the card, in %."""


def read(run):
    t = run.record.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
