"""Device ms a profiled step of the shading MLPs: the kernels under the
program's ``tf.shading`` span (shading.apply_shading) and under the
backward ops carrying its forward ops' sequence numbers."""
from bench_port.harness import spans


def read(ctx):
    return spans.device_ms(ctx.trace, 'tf.shading')
