from uig_torch.checkpoint.ckpt import CheckpointManager, dump_run_config

__all__ = ["CheckpointManager", "dump_run_config"]
