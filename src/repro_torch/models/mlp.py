"""A plain MLP image classifier — the second real federated workload.

The counterpart of ``repro/models/mlp.py``: cifarlike (B, 32, 32, C)
images -> logits through dense layers over the flattened pixels, with the
hidden widths of LeNet-5's FC head (120, 84). Like ``models/lenet.py`` the
parameters are ONE flat f32 vector in ``jax.tree.leaves`` order of the
JAX package's parameter dict (``fc1/b, fc1/w, fc2/b, ...``, dense kernels
as (in, out)): 379,774 elements at 32x32x3, so K1 applies a push to the
whole model in one pass.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def layout(num_classes: int = 10, in_channels: int = 3, image_hw: int = 32,
           hidden=(120, 84)):
    """(name, shape) of each leaf, in the flat vector's order."""
    dims = (image_hw * image_hw * in_channels,) + tuple(hidden) \
        + (num_classes,)
    out = []
    for i in range(len(dims) - 1):
        out += [(f"fc{i + 1}/b", (dims[i + 1],)),
                (f"fc{i + 1}/w", (dims[i], dims[i + 1]))]
    return tuple(out)


LAYOUT = layout()
PARAM_COUNT = sum(math.prod(s) for _, s in LAYOUT)      # 379,774


def unflatten(flat, lay=LAYOUT) -> dict:
    """Views of the flat vector, keyed ``"fc1/w"`` etc."""
    out, off = {}, 0
    for name, shape in lay:
        size = math.prod(shape)
        out[name] = flat[off:off + size].view(shape)
        off += size
    return out


def init_mlp(generator: torch.Generator, device="cpu"):
    """Flat f32 parameters: truncated-normal (+-3 sigma) kernels scaled by
    fan-in^-1/2, zero biases — the JAX init's distribution, drawn from
    ``generator`` on the CPU, then moved."""
    parts = []
    for name, shape in LAYOUT:
        t = torch.zeros(shape)
        if name.endswith("/w"):
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0,
                                        generator=generator)
            t *= shape[0] ** -0.5
        parts.append(t.reshape(-1))
    return torch.cat(parts).to(device)


def params_from_jax(tree, device="cpu") -> torch.Tensor:
    """The JAX package's MLP parameter dict (``{"fc1": {"w", "b"},
    ...}``, numpy or jax arrays) as the port's flat f32 vector."""
    leaves = []
    for name, shape in LAYOUT:
        layer, kind = name.split("/")
        a = np.asarray(tree[layer][kind], dtype=np.float32)
        if a.shape != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {a.shape}")
        leaves.append(a.reshape(-1))
    return torch.from_numpy(np.concatenate(leaves)).to(device)


def mlp_logits(flat, images):
    """images: (B, H, W, C) float32 -> logits (B, 10)."""
    p = unflatten(flat)
    x = images.reshape(images.shape[0], -1)
    n = len(LAYOUT) // 2
    for i in range(1, n):
        x = F.relu(x @ p[f"fc{i}/w"] + p[f"fc{i}/b"])
    return x @ p[f"fc{n}/w"] + p[f"fc{n}/b"]


def mlp_loss(flat, images, labels):
    """Mean cross-entropy of the logits against integer labels."""
    logp = F.log_softmax(mlp_logits(flat, images), dim=-1)
    return -logp.gather(1, labels[:, None]).mean()
