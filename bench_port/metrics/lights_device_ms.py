"""Device ms a profiled step of the secondary lights: the kernels under
the program's ``tf.lights`` spans (the outer light of every secondary
ray, and the inner-light MLP over the compacted hit slots; the trace
excluded) and under the backward ops carrying their forward ops'
sequence numbers."""
from bench_port.harness import spans


def read(ctx):
    return spans.device_ms(ctx.trace, 'tf.lights')
