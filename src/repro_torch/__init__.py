"""repro_torch — the PyTorch/CUDA port of ``repro`` (serverless federated learning).

Same layout as ``src/repro``: a module's counterpart sits at the same relative
path. The port imports torch and never jax, and nothing of ``repro``. Entry
points run on the card (``device="cuda"``) unless the caller asks for the CPU.
"""
