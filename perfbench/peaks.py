"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit).  Every roofline share and MFU of the
benchmark is taken against these."""

HBM_BYTES_PER_S = 3.35e12
# float32 outside the tensor cores
FP32_FLOPS = 67e12
# bf16 on the tensor cores
BF16_FLOPS = 989e12
# FP32-pipe instructions a second: FP32_FLOPS counts an FFMA as two
FP32_INSTR_PER_S = FP32_FLOPS / 2
# the SFU's MUFU.EX2: 16 a clock an SM against the FP32 pipe's 128
EX2_PER_S = FP32_INSTR_PER_S / 8


def flops(dtype: str) -> float:
    """The peak a cell computing in ``dtype`` is held against."""
    return BF16_FLOPS if dtype == "bfloat16" else FP32_FLOPS
