from . import ops, ref
from .kernel import decode_attention
