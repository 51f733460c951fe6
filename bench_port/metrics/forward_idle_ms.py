"""The device's idle ms a profiled step while the training thread is
inside the program's ``tf.forward`` span: the idle gaps between busy
intervals, each split by its overlap with the span (harness/spans.py).
It holds the profiler's tax on every launch of the forward."""
from bench_port.harness import spans


def read(ctx):
    return spans.idle_ms(ctx.trace, 'forward')
