"""The stencil head's share of its roofline, in percent, forward and
backward together: the least time of a forward and a backward call (the
configuration's counts.head_bytes_ops against the peaks) / the device
time a profiled step of every kernel launched inside the benchmark's
range around ops.stencil.stencil_head and inside the backward ops whose
sequence numbers those forward ops carry."""


def read(ctx):
    name = getattr(ctx.system, 'STENCIL_RANGE', None)
    if ctx.trace is None or name is None:
        return None
    dev_s = ctx.trace.range_device_s(name)
    if not dev_s:
        return None
    (fb, fo), (bb, bo) = ctx.counts.head_bytes_ops(
        ctx.counts.head_rows(ctx.cfg), 2, ctx.cfg)
    least = ctx.peaks.bound_s(fb, fo) + ctx.peaks.bound_s(bb, bo)
    return 100.0 * least / dev_s
