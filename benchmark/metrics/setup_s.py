"""setup_s: seconds from the process's start to the first timed pass:
imports, inputs made from the seed, the kernels' library built or loaded,
one warm-up pass per distinct input."""


def read(ctx):
    return ctx.setup_s
