from . import ops, ref
from .kernel import flash_attention
