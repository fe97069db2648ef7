"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet: dense
rates without sparsity, at the 700 W power limit)."""

BF16_FLOPS = 989e12  # tensor cores, bf16 and fp16
HBM_BYTES_PER_S = 3.35e12
BYTES = {"bfloat16": 2, "float32": 4}
