from .checkpoint import partial_load, trainable_mask_from_loaded
from .state import TrainState, create_train_state
from .steps import (make_downstream_eval_step, make_downstream_step, make_pretrain_eval_step,
                    make_pretrain_step)

__all__ = ["TrainState", "create_train_state", "make_pretrain_step",
           "make_pretrain_eval_step", "make_downstream_step", "make_downstream_eval_step",
           "partial_load", "trainable_mask_from_loaded"]
