from .train_step import make_train_step
from .trainer import do_train

__all__ = ["do_train", "make_train_step"]
