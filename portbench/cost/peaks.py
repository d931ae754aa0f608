"""Published peaks of the card, the yardstick of every roofline share.

NVIDIA H100 SXM (80 GB HBM3), data sheet, dense rates without sparsity,
at the full power limit of 700 W: 67 TFLOP/s in float32 outside the
tensor cores, 3.35 TB/s of HBM bandwidth."""

H100_SXM = {"f32_flops": 67e12, "hbm_bytes": 3.35e12}
