"""K3 launches a call over the window (`kernels.matvec.LAUNCHES`, counted
by the program at each graph replay): the matting CG's iterations + 1,
the chunk's masked iterations included."""


def read(run):
    return run["window_counters"]["matvec"] / len(run["calls"])
