from .checkpoint import partial_load, trainable_mask_from_loaded
from .grid import (StackedState, VmappedGridRunner, make_scanned_downstream_steps,
                   make_vmapped_downstream_steps, slice_state, stack_states)
from .learner import (DownstreamLearner, EarlyStopping, PretrainLearner, mae_without_training,
                      smooth_data)
from .schedules import cosine_schedule, exp_decay, linear_schedule
from .state import Adam, StackedAdam, TrainState, create_train_state, make_adam
from .steps import (make_downstream_eval_step, make_downstream_step, make_pretrain_eval_step,
                    make_pretrain_step)

__all__ = ["Adam", "StackedAdam", "TrainState", "create_train_state", "make_adam",
           "make_pretrain_step",
           "make_pretrain_eval_step", "make_downstream_step", "make_downstream_eval_step",
           "partial_load", "trainable_mask_from_loaded", "cosine_schedule", "linear_schedule",
           "exp_decay", "EarlyStopping", "PretrainLearner", "DownstreamLearner", "smooth_data",
           "mae_without_training", "StackedState", "VmappedGridRunner",
           "make_vmapped_downstream_steps", "make_scanned_downstream_steps", "stack_states",
           "slice_state"]
