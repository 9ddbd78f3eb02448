"""setup_s: from the process's start to the window's opening: imports,
CUDA start, the kernels' load (their build on a checkout's first run), the
traffic's generation and the warm-up."""


def read(ctx):
    return ctx.get("setup_s")
