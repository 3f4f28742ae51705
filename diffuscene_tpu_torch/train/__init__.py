from .optim import Optimizer, f32_global_norm, lr_schedule_factory, optimizer_factory
from .ae_trainer import AETrainer
from .trainer import Trainer
