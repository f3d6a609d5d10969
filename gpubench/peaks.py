"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its full 700 W power limit): HBM bytes/s and FLOP/s by compute
dtype (bf16 on the tensor cores, float32 on the CUDA cores)."""

PEAK_BYTES = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BF16 = PEAK_OPS["bfloat16"]


def least_seconds(ops: float, bytes_moved: float,
                  dtype: str = "bfloat16") -> float:
    """The least time the card could take for the work: the larger of
    operations over peak FLOP/s and bytes over peak bytes/s."""
    return max(ops / PEAK_OPS[dtype], bytes_moved / PEAK_BYTES)
