from .pipeline import SyntheticLMDataset, make_batch_for

__all__ = ["SyntheticLMDataset", "make_batch_for"]
