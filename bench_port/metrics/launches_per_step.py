"""Device kernel launches a profiled step (copies and fills not counted):
the host dispatch layer's work, an exact count."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    return ctx.trace.launches_per_step()
