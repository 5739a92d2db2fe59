"""Set-up: from the start of the process through importing, building or
loading the kernel library, making the inputs and the weights, and the
warm-up calls that capture the program, to the window's start."""


def read(run):
    return run["setup_s"]
