"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense, at
the full 700 W power limit). A roofline share is stated against these, with
the card's power limit beside it."""
HBM_BYTES_PER_S = 3.35e12      # HBM3
F32_OPS_PER_S = 67e12          # float32 outside the tensor cores
F64_OPS_PER_S = 34e12          # float64 outside the tensor cores
HBM_BYTES = 80e9
