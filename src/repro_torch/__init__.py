"""PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The JAX package ``repro`` stays the reference; this package mirrors its
module names (``repro_torch/core/lyapunov.py`` <-> ``repro/core/lyapunov.py``)
and imports neither ``jax`` nor anything of ``repro``: the numpy-only
and plain-Python modules it needs (energy, fleet, arrivals, lyapunov,
data/synthetic, models/config, fault/monitor) are its own copies.

Entry points place their tensors on ``device="cuda"`` unless the caller
asks for the CPU, and raise when CUDA is asked for and absent. Kernels
(``repro_torch.kernels``) are written by hand for Hopper; each has a
plain PyTorch version that runs only on CPU tensors the caller asked for,
or on CUDA when requested explicitly with ``kernel="reference"``.
"""
