"""Data of the port: the synthetic LM token stream."""
from repro_torch.data.synthetic import SyntheticLMDataset, make_lm_batch

__all__ = ["SyntheticLMDataset", "make_lm_batch"]
