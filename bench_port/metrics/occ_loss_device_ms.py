"""Device ms a profiled step of the occ-loss march: the kernels under the
program's ``tf.occ_loss`` span (the selection, the reflected rays' march
through the field and the L1 term) and under the backward ops carrying
its forward ops' sequence numbers."""
from bench_port.harness import spans


def read(ctx):
    return spans.device_ms(ctx.trace, 'tf.occ_loss')
