from . import checkpoint  # noqa: F401
from .optimizers import Optimizer, build_scheduler  # noqa: F401
from .trainer import Trainer, TrainerConfig  # noqa: F401
