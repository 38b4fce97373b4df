from repro_torch.kernels.matmul.ops import matmul

__all__ = ["matmul"]
