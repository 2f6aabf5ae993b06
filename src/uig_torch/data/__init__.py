from uig_torch.data.datasets import (FolderDataset, PackedDataset,
                                     SyntheticUnpairedDataset, eval_datasets,
                                     open_dataset, resolve_dataset)
from uig_torch.data.pipeline import UnpairedPipeline, make_input_pipeline


__all__ = [
    "FolderDataset",
    "PackedDataset",
    "SyntheticUnpairedDataset",
    "UnpairedPipeline",
    "eval_datasets",
    "make_input_pipeline",
    "open_dataset",
    "resolve_dataset",
]
