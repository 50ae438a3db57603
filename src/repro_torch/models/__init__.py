from .cnn import MnistCNN, ResNet
from .common import ModelConfig, load_jax_params
from .transformer import DecoderLM


def build_model(cfg: ModelConfig):
    """Config → model object with init/apply (+decode for LMs). Raises
    ``NotImplementedError`` for what the port does not build yet."""
    return DecoderLM(cfg)


__all__ = ["ModelConfig", "DecoderLM", "MnistCNN", "ResNet", "build_model", "load_jax_params"]
