"""The motion-only BA's LM iterations a frame (`backend/lm.py`): the mean
of the counts the frame graph logs for its `ba` solve (`graphs.iteration_log`)
over the window's frames."""


def read(run):
    it = run.record.lm_iters
    return sum(it) / len(it) if it else None
