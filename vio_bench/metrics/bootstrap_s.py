"""The host state machine's bootstrap (SYNC, SFM, INITIALIZING and the
eager first solves of `SolveGraphs`): the harness clock from the first
frame handed to `process` to the first OK frame, in set-up."""


def read(run):
    return run.record.bootstrap_s
