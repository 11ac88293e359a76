"""Process start to the window's start: imports, the kernels' build or
load, the world's generation, the bootstrap, the captures and the warm
frames."""


def read(run):
    return run.record.setup_s
