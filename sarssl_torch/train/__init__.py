from .checkpoint import partial_load, trainable_mask_from_loaded
from .learner import (DownstreamLearner, EarlyStopping, PretrainLearner, mae_without_training,
                      smooth_data)
from .schedules import cosine_schedule, exp_decay, linear_schedule
from .state import Adam, TrainState, create_train_state
from .steps import (make_downstream_eval_step, make_downstream_step, make_pretrain_eval_step,
                    make_pretrain_step)

__all__ = ["Adam", "TrainState", "create_train_state", "make_pretrain_step",
           "make_pretrain_eval_step", "make_downstream_step", "make_downstream_eval_step",
           "partial_load", "trainable_mask_from_loaded", "cosine_schedule", "linear_schedule",
           "exp_decay", "EarlyStopping", "PretrainLearner", "DownstreamLearner", "smooth_data",
           "mae_without_training"]
