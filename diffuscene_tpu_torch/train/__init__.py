from .optim import Optimizer, lr_schedule_factory, optimizer_factory
from .ae_trainer import AETrainer
