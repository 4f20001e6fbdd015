"""Training of the port: train-step factories (``steps``) and the
fault-tolerant loop (``loop``)."""
from .loop import run_training
from .steps import make_lm_train_step, make_train_step

__all__ = ["make_lm_train_step", "make_train_step", "run_training"]
