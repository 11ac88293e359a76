"""The card's share of a stream frame as the host sees it: the harness
clock from the return of `process` to the return of the wait for the card
after it, mean over the window's frames outside the traced stretch. It
holds the frame's device work that `process` left queued (the graph's
replay), and not the host work before it, whose speed varies from run to
run on a shared host; so a change on the device shows here with less
noise than in `frames_per_s`."""


def read(run):
    s = run.record.sync_ms
    return sum(s) / len(s) if s else None
