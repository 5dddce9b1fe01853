# Training: the optimizers (AdamW, Adafactor, global-norm clipping) and the
# train-step factory.
from .optimizer import (Optimizer, adafactor, adamw, clip_by_global_norm,  # noqa: F401
                        global_norm, make_optimizer)
from .train_loop import loss_and_grads, make_train_step  # noqa: F401
