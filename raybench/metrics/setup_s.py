"""setup_s: seconds from the process's start to the first timed step
(imports, CUDA start, scene, BVH, kernel build or load, target, warm-up)."""


def read(ctx):
    return ctx.setup_s
