"""The kernel-mode rule every hand kernel of the port shares.

A wrapper's ``kernel`` argument takes one of three values, the middle one
named after the kernel's route (``"triton"`` for K1/K2, ``"cuda"`` for
K3/K4):

- ``"auto"``: the hand kernel for CUDA tensors, the plain version for CPU
  tensors (which only a caller that asked for the CPU has);
- the route's name: the hand kernel; a CPU tensor raises;
- ``"reference"``: the plain version on either device, an explicit choice
  (``chip_smoke.py`` uses it to hold the kernels against it on the card).

There is no fallback: a CUDA tensor under ``auto`` or the route's name
launches the kernel or raises.
"""
from __future__ import annotations


def kernel_modes(route: str) -> tuple:
    return ("auto", route, "reference")


def check_kernel_mode(mode: str, route: str) -> str:
    modes = kernel_modes(route)
    if mode not in modes:
        raise ValueError(f"unknown kernel mode {mode!r}; expected one of "
                         f"{modes}")
    return mode


def use_kernel(mode: str, t, route: str) -> bool:
    """Whether ``mode`` launches the hand kernel for tensor ``t``."""
    check_kernel_mode(mode, route)
    if mode == "reference" or (mode == "auto" and not t.is_cuda):
        return False
    if not t.is_cuda:
        raise ValueError(f"kernel={route!r} needs CUDA tensors; got tensors "
                         f"on {t.device}")
    return True
