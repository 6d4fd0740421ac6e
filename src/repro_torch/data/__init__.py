"""Training data of the port (port of ``repro.data``)."""

from repro_torch.data.pipeline import SyntheticLMDataset, make_train_iterator

__all__ = ["SyntheticLMDataset", "make_train_iterator"]
