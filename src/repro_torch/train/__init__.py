from repro_torch.train.loop import SimulatedFailure, Trainer
from repro_torch.train.steps import (TrainState, init_state, make_eval_step,
                                     make_train_step)

__all__ = ["TrainState", "init_state", "make_train_step", "make_eval_step",
           "Trainer", "SimulatedFailure"]
