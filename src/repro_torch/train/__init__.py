"""Training on one device or a mesh (the port of ``repro.train``): the
synthetic data stream (``data``), AdamW (``optimizer``) and the train
step (``train_step``)."""
from .data import batch_spec, sharded_batch, synthetic_batch
from .optimizer import AdamWConfig, TrainState, adamw_update, init_state
from .train_step import eval_state_shapes, init_train_state, make_train_step

__all__ = ["AdamWConfig", "TrainState", "adamw_update", "batch_spec",
           "eval_state_shapes", "init_state", "init_train_state",
           "make_train_step", "sharded_batch", "synthetic_batch"]
