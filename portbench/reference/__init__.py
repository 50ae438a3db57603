"""The plain reference: ResNet-18 with GroupNorm and Adam, Mamba2's forward,
FedAvg and the store's npz wire, written from their published descriptions
in plain PyTorch and NumPy, float32 with TF32 off unless a control asks for
less. It imports nothing of the program it judges."""
