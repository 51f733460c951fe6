"""The device's idle ms a profiled step while the training thread is
inside the program's ``tf.backward`` span (the autograd engine launches
the kernels from its own thread meanwhile): the idle gaps, each split by
its overlap with the span (harness/spans.py).  It holds the profiler's
tax on every launch of the backward."""
from bench_port.harness import spans


def read(ctx):
    return spans.idle_ms(ctx.trace, 'backward')
