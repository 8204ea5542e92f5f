"""setup_s: the process's start to the measured window's, less the checking
work done in between (copies for the check): loading, building or finding
the kernels, drawing, and warming up."""


def read(run):
    return run["setup_s"]
