"""Device ms a profiled step of the material field and its predictors:
the kernels under the program's ``tf.mat_field`` span (the VM field's
lookups and the metallic, roughness and albedo MLPs) and under the
backward ops carrying their forward ops' sequence numbers."""
from bench_port.harness import spans


def read(ctx):
    return spans.device_ms(ctx.trace, 'tf.mat_field')
