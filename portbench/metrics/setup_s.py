"""setup_s: from the process's start to the window's: inputs made from the
seed, the index, the CUDA context, kernels loaded or built, the warm job."""


def read(run):
    return run.setup_s
