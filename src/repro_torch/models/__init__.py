from .cnn import MnistCNN, ResNet, load_jax_params

__all__ = ["MnistCNN", "ResNet", "load_jax_params"]
