from .trainer import TrainState, Trainer, make_train_step, value_and_grad

__all__ = ["TrainState", "Trainer", "make_train_step", "value_and_grad"]
