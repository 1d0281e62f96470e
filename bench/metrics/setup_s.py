"""setup_s: seconds from the process's start to the first timed request:
importing torch and the port, loading (in a fresh checkout building) the
kernels, building the cell's DAG and warming up its one lane count."""


def read(run):
    return run.setup_s
