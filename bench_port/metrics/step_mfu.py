"""The whole step's share of the chip's peak, in percent: the step's
dense-product operations (the configuration's counts.py, each at the
peak of the precision it runs in) / the window's mean step time."""


def read(ctx):
    if ctx.counts is None or ctx.step_s <= 0:
        return None
    at_peak = sum(ops / ctx.peaks.FLOPS[dtype]
                  for _, ops, dtype in ctx.counts.step_terms_typed(ctx.cfg))
    return 100.0 * at_peak / ctx.step_s
