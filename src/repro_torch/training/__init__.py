from .trainer import Trainer

__all__ = ["Trainer"]
