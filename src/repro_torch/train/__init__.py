"""repro_torch.train — the train state and the train/eval step factories
(counterpart of ``repro.train``, chip scope)."""
from repro_torch.train.state import TrainState, abstract_state, create
from repro_torch.train.step import (make_eval_step, make_train_step,
                                    shard_batch, value_and_grad)

__all__ = ["TrainState", "create", "abstract_state", "make_train_step",
           "make_eval_step", "value_and_grad", "shard_batch"]
