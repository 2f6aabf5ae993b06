from uig_torch.train.cyclegan import CycleGANTrainer
from uig_torch.train.state import CycleGANState, VQGANState
from uig_torch.train.vqgan import VQGANTrainer

__all__ = ["CycleGANState", "CycleGANTrainer", "VQGANState", "VQGANTrainer"]
