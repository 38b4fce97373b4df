from repro_torch.data.pipeline import RequestGenerator, SyntheticLM

__all__ = ["RequestGenerator", "SyntheticLM"]
