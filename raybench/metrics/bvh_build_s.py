"""bvh_build_s: host seconds of make_backend (the host SAH build, the wide
collapse and the copy to the card), timed by the harness in set-up."""


def read(ctx):
    return ctx.bvh_build_s
