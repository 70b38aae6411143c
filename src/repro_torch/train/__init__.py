from repro_torch.train.loop import TrainConfig, Trainer

__all__ = ["TrainConfig", "Trainer"]
