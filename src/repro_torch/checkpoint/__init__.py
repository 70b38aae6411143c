from repro_torch.checkpoint.checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
