from .ops import aggregate_flat, fed_opt_flat

__all__ = ["aggregate_flat", "fed_opt_flat"]
