"""The device's idle ms a profiled step while the training thread is
inside the program's ``tf.step`` span and outside its ``tf.forward`` and
``tf.backward``: the batch copy, the draws, Adam and the schedule's
hooks.  The idle gaps, each split by its overlap with the spans
(harness/spans.py); it holds the profiler's tax on their launches."""
from bench_port.harness import spans


def read(ctx):
    return spans.idle_ms(ctx.trace, 'between')
