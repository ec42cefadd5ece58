"""Hand-written kernels (the dense engine's megakernel, kernels/megatrace.py)."""
