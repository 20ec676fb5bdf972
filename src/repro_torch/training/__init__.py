from repro_torch.training.loss import accuracy, softmax_nll, softmax_xent
from repro_torch.training.optimizers import Optimizer, adam, sgd

__all__ = ["Optimizer", "accuracy", "adam", "sgd", "softmax_nll", "softmax_xent"]
