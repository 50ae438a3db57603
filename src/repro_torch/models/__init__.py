from .cnn import MnistCNN, ResNet
from .common import ModelConfig, load_jax_params
from .encdec import EncDecLM
from .transformer import DecoderLM


def build_model(cfg: ModelConfig):
    """Config → model object with init/apply/loss (+decode for LMs)."""
    if cfg.is_encdec:
        return EncDecLM(cfg)
    return DecoderLM(cfg)


__all__ = ["ModelConfig", "DecoderLM", "EncDecLM", "MnistCNN", "ResNet", "build_model",
           "load_jax_params"]
