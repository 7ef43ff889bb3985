from acmgnn_tpu_torch.train.config import TrainConfig
from acmgnn_tpu_torch.train.trainer import run_experiment

__all__ = ["TrainConfig", "run_experiment"]
