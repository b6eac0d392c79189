"""Data of the port: the synthetic LM token stream and the sharded
host -> device batcher."""
from repro_torch.data.pipeline import ShardedBatcher
from repro_torch.data.synthetic import SyntheticLMDataset, make_lm_batch

__all__ = ["SyntheticLMDataset", "make_lm_batch", "ShardedBatcher"]
