from uig_torch.train.cyclegan import CycleGANTrainer
from uig_torch.train.state import CycleGANState

__all__ = ["CycleGANState", "CycleGANTrainer"]
