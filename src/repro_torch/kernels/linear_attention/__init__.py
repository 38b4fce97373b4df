from repro_torch.kernels.linear_attention.ops import linear_attention

__all__ = ["linear_attention"]
