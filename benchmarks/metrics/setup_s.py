"""setup_s: seconds from the process's start to the window's: imports, CUDA's
start, the reads made and written, the warm-up job."""


def read(ctx):
    return ctx["setup_s"]
