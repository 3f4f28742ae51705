from .optim import (Optimizer, f32_global_norm, freeze_mask, lr_schedule_factory,
                    optimizer_factory)
from .ae_trainer import AETrainer
from .trainer import Trainer
