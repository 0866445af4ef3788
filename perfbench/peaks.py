"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W)."""

FP32_FLOPS = 67e12  # float32 outside the tensor cores: the fit runs with TF32 off
HBM_BYTES_PER_S = 3.35e12
