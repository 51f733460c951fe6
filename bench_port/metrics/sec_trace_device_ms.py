"""Device ms a profiled step of the budgeted secondary trace: the kernels
under the program's ``tf.sec_trace`` spans (the launch test, the
coarse march, the compacted refinement, and the scatter of its results
back to every ray) and under the backward ops carrying their forward
ops' sequence numbers."""
from bench_port.harness import spans


def read(ctx):
    return spans.device_ms(ctx.trace, 'tf.sec_trace')
