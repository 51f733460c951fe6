"""Device ms a profiled step of the field gathers: the kernels under the
program's ``tf.gather`` spans (the patch atlas and its gather before the
stencil head; the split route's stencil features) and under the backward
ops carrying their forward ops' sequence numbers (the scatter-add VJPs)."""
from bench_port.harness import spans


def read(ctx):
    return spans.device_ms(ctx.trace, 'tf.gather')
