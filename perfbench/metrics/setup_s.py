"""setup_s: from the process's start to the first timed batch: imports,
the CUDA context, the kernels loaded (or built), the deployment and the
traffic pool drawn, the session compiled and its graph captured, and one
warm-up batch a pool entry (host clock)."""


def read(run):
    return run.setup_s
