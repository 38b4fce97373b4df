from repro_torch.data.pipeline import RequestGenerator

__all__ = ["RequestGenerator"]
