from uig_torch.data.folder import FolderDataset

__all__ = ["FolderDataset"]
