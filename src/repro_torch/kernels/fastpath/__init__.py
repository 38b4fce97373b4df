from repro_torch.kernels.fastpath.ops import lookup

__all__ = ["lookup"]
