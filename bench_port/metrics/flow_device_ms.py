"""Device ms a profiled step of the conditional flows: the kernels under
the program's ``tf.flow`` spans (conditioning, sampling through the
frozen flow copies, and the live flows' densities of the NIS loss) and
under the backward ops carrying their forward ops' sequence numbers."""
from bench_port.harness import spans


def read(ctx):
    return spans.device_ms(ctx.trace, 'tf.flow')
