"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at its 700 W limit): what a roofline share or an MFU is taken against."""

H100_SXM = {
    "fp32_flops": 67e12,        # FP32 outside the tensor cores
    "tf32_flops": 495e12,
    "bf16_flops": 989e12,
    "fp8_flops": 1979e12,
    "hbm_bytes_per_s": 3.35e12,
    "hbm_bytes": 80e9,
}
