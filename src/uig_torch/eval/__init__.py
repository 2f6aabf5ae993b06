"""Evaluation metrics of the port: LPIPS (``eval/lpips.py``), the training
loss's perceptual term."""

from uig_torch.eval.lpips import LPIPS, VGG16Features, make_lpips

__all__ = ["LPIPS", "VGG16Features", "make_lpips"]
