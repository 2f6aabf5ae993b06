"""Evaluation metrics of the port: LPIPS (``eval/lpips.py``), the training
loss's perceptual term; FID and KID (``eval/fid.py``) over the InceptionV3
(``eval/inception.py``) or random-conv features; the Inception Score
(``eval/is_score.py``); precision/recall/density/coverage
(``eval/prdc.py``)."""

from uig_torch.eval.fid import (FIDStats, collect_features, compute_fid,
                                compute_kid, frechet_distance,
                                kid_from_features, make_feature_fn,
                                stream_stats)
from uig_torch.eval.is_score import (compute_inception_score,
                                     inception_score_from_probs)
from uig_torch.eval.lpips import LPIPS, VGG16Features, make_lpips
from uig_torch.eval.prdc import compute_prdc, prdc_from_features

__all__ = ["FIDStats", "LPIPS", "VGG16Features", "collect_features",
           "compute_fid", "compute_inception_score", "compute_kid",
           "compute_prdc", "frechet_distance", "inception_score_from_probs",
           "kid_from_features", "make_feature_fn", "make_lpips",
           "prdc_from_features", "stream_stats"]
