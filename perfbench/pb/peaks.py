"""Published dense peaks of one NVIDIA H100 SXM (data sheet, 700 W)."""

BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
