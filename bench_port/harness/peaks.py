"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's
data sheet; dense rates, no sparsity).  Frozen: a roofline or a peak
share is stated against these, with the card's power limit beside it."""
HBM_BYTES_PER_S = 3.35e12
FLOPS = {'float32': 67e12, 'tf32': 495e12, 'bfloat16': 989e12,
         'float16': 989e12, 'fp8': 1979e12}


def bound_s(nbytes: float, ops: float, dtype: str = 'float32') -> float:
    """The least time: the larger of bytes over the HBM rate and
    operations over the peak of ``dtype``."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FLOPS[dtype])
