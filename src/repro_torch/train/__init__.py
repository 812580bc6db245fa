"""Training, in torch: the train step (AdamW or TreeNewton, gradient
accumulation) and the int8 error-feedback gradient all-reduce.

Counterpart of ``repro/train``.
"""
from repro_torch.train import compress  # noqa: F401
from repro_torch.train.step import (TrainConfig, init_state,  # noqa: F401
                                    make_train_step, reshape_for_accum)
