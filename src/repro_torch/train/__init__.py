"""Training substrate: state, train step, fault-tolerant host loop."""

from .loop import LoopConfig, train
from .state import TrainState, init_state
from .step import CompressedTrainState, make_train_step

__all__ = ["LoopConfig", "train", "TrainState", "init_state",
           "make_train_step", "CompressedTrainState"]
