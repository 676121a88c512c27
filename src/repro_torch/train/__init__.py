"""Training substrate of the port: optimizers, the train step (gradient
accumulation, remat), gradient compression, the fault-tolerant loop
(counterpart of ``src/repro/train``)."""
from .optimizer import make_optimizer  # noqa: F401
from .train_step import make_train_step  # noqa: F401
