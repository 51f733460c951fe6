"""Device ms a profiled step of the sampler: the kernels under the
program's ``tf.sampler`` span (the atlas its field queries read and
sample_ray_hierarchical; occ_grid_sampling on the occupancy route) and
under the backward ops carrying its forward ops' sequence numbers."""
from bench_port.harness import spans


def read(ctx):
    return spans.device_ms(ctx.trace, 'tf.sampler')
