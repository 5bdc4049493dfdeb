from repro_torch.training.data import SyntheticDataset, synthetic_batch
from repro_torch.training.optimizer import AdamWConfig, adamw_init, adamw_update, zero1_plan
from repro_torch.training.train_step import TrainStepConfig, make_train_step

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "zero1_plan",
    "make_train_step",
    "TrainStepConfig",
    "synthetic_batch",
    "SyntheticDataset",
]
