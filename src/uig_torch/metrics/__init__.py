from uig_torch.metrics.writer import MetricsWriter, StepTimer

__all__ = ["MetricsWriter", "StepTimer"]
