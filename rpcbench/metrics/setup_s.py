"""setup_s: seconds from the process's start to the start of the measured
window: imports, the CUDA context, loading (on a first run, building) the
native library and the kernels, starting the server, making the inputs
from the seed, and the warm-up."""

def read(run):
    return run.setup_s
