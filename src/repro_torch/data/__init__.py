from .synthetic import (
    SyntheticImageDataset,
    SyntheticTokenStream,
    make_synthetic_cifar,
    make_synthetic_mnist,
    make_synthetic_wikitext,
)
from .pipeline import batch_iterator, lm_batch_iterator, shard_batch

__all__ = [
    "SyntheticImageDataset",
    "SyntheticTokenStream",
    "make_synthetic_mnist",
    "make_synthetic_cifar",
    "make_synthetic_wikitext",
    "batch_iterator",
    "lm_batch_iterator",
    "shard_batch",
]
