from . import ops, ref
