"""The device's idle share of a step, in percent: 1 - the union of the
intervals of every device operation a profiled step / the window's mean
step time (unprofiled)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s_per_step() / ctx.step_s)
