"""Seconds from the process's start to the first timed step: imports, the
CUDA context, the matrix from the cache, symbolic analysis, the cold
factor and the warm-up steps."""


def read(run):
    return run.setup_s
