from .state import TrainState, create_train_state
from .steps import make_pretrain_eval_step, make_pretrain_step

__all__ = ["TrainState", "create_train_state", "make_pretrain_step",
           "make_pretrain_eval_step"]
