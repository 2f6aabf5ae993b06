from uig_torch.train.cut import CUTTrainer
from uig_torch.train.cyclegan import CycleGANTrainer
from uig_torch.train.dclgan import DCLGANTrainer
from uig_torch.train.state import (CUTState, CycleGANState, DCLGANState,
                                   VQGANState)
from uig_torch.train.vqgan import VQGANTrainer

__all__ = ["CUTState", "CUTTrainer", "CycleGANState", "CycleGANTrainer",
           "DCLGANState", "DCLGANTrainer", "VQGANState", "VQGANTrainer"]
