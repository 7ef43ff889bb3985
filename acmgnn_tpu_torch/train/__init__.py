from acmgnn_tpu_torch.train.config import TrainConfig
from acmgnn_tpu_torch.train.trainer import run_experiment, train_single_split

__all__ = ["TrainConfig", "train_single_split", "run_experiment"]
