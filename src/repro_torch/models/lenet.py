"""LeNet-5 — the model the paper trains on CIFAR-10 (Sec. VI: DL4J LeNet-5).

The counterpart of ``repro/models/lenet.py``. The parameters are ONE flat
f32 vector of 62,006 elements in ``jax.tree.leaves`` order of the JAX
package's parameter dict (``conv1/b, conv1/w, conv2/b, conv2/w, fc1/b,
fc1/w, ...``), with the JAX layouts: HWIO convolution kernels and
(in, out) dense kernels. So the server's flat vectors compare element by
element with the JAX package's, and K1 applies a push to the whole model
with no flatten or concat. Images are NHWC at the public functions; the
forward pass permutes to NCHW internally. Convolutions and pooling are
VALID, as in the JAX model.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


# (name, shape) in the flat vector's order: 10 classes, 3 input channels
LAYOUT = (
    ("conv1/b", (6,)), ("conv1/w", (5, 5, 3, 6)),
    ("conv2/b", (16,)), ("conv2/w", (5, 5, 6, 16)),
    ("fc1/b", (120,)), ("fc1/w", (16 * 5 * 5, 120)),
    ("fc2/b", (84,)), ("fc2/w", (120, 84)),
    ("fc3/b", (10,)), ("fc3/w", (84, 10)),
)
PARAM_COUNT = sum(math.prod(s) for _, s in LAYOUT)      # 62,006


def unflatten(flat) -> dict:
    """Views of the flat vector, keyed ``"conv1/w"`` etc."""
    out, off = {}, 0
    for name, shape in LAYOUT:
        size = math.prod(shape)
        out[name] = flat[off:off + size].view(shape)
        off += size
    return out


def init_lenet(generator: torch.Generator, device="cpu"):
    """Flat f32 parameters: truncated-normal (+-3 sigma) kernels scaled by
    fan-in^-1/2, zero biases — the JAX init's distribution, drawn from
    ``generator`` (on the CPU, then moved, so every device gets the same
    values from one seed)."""
    parts = []
    for name, shape in LAYOUT:
        t = torch.zeros(shape)
        if name.endswith("/w"):
            fan_in = math.prod(shape[:-1])
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0,
                                        generator=generator)
            t *= fan_in ** -0.5
        parts.append(t.reshape(-1))
    return torch.cat(parts).to(device)


def params_from_jax(tree, device="cpu") -> torch.Tensor:
    """The JAX package's LeNet parameter dict (numpy or jax arrays, as
    ``{"conv1": {"w", "b"}, ...}``) as the port's flat f32 vector."""
    leaves = []
    for name, shape in LAYOUT:
        layer, kind = name.split("/")
        a = np.asarray(tree[layer][kind], dtype=np.float32)
        if a.shape != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {a.shape}")
        leaves.append(a.reshape(-1))
    return torch.from_numpy(np.concatenate(leaves)).to(device)


def _conv(x, w, b):
    """VALID convolution of NCHW ``x`` by the HWIO kernel ``w``.

    On CUDA it is ``conv_im2col``: cuBLAS sums in a fixed order, so two
    runs on the card give the same bits, and a local epoch stays within
    1e-5 of the CPU's. cuDNN gives neither for the cohort's grouped
    convolution (one group a lane under ``vmap``): its default
    weight-gradient algorithm accumulates with atomics, in an order that
    varies from run to run, and restricted to deterministic algorithms it
    takes Winograd transforms whose epoch lands ~50x farther from the
    CPU's. On the CPU it is ``F.conv2d``, which keeps its speed when
    several processes share the cores (the im2col route's many small
    parallel operations do not)."""
    if x.is_cuda:
        return conv_im2col(x, w, b)
    return F.conv2d(x, w.permute(3, 2, 0, 1), b)


def conv_im2col(x, w, b):
    """``_conv`` as im2col and one matmul: the (c, kh, kw) patches of ``x``
    as columns (``F.unfold``), times the kernel as an (o, c*kh*kw)
    matrix."""
    kh, kw, c, o = w.shape
    n, _, h, wd = x.shape
    cols = F.unfold(x, (kh, kw))                     # (n, c*kh*kw, L)
    y = w.permute(3, 2, 0, 1).reshape(o, c * kh * kw) @ cols
    return y.view(n, o, h - kh + 1, wd - kw + 1) + b[:, None, None]


def lenet_logits(flat, images):
    """images: (B, 32, 32, C) float32 NHWC -> logits (B, 10)."""
    p = unflatten(flat)
    x = images.permute(0, 3, 1, 2)                         # NHWC -> NCHW
    x = F.max_pool2d(F.relu(_conv(x, p["conv1/w"], p["conv1/b"])), 2)
    x = F.max_pool2d(F.relu(_conv(x, p["conv2/w"], p["conv2/b"])), 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)      # HWC flatten
    x = F.relu(x @ p["fc1/w"] + p["fc1/b"])
    x = F.relu(x @ p["fc2/w"] + p["fc2/b"])
    return x @ p["fc3/w"] + p["fc3/b"]


def lenet_loss(flat, images, labels):
    """Mean cross-entropy of the logits against integer labels."""
    logp = F.log_softmax(lenet_logits(flat, images), dim=-1)
    return -logp.gather(1, labels[:, None]).mean()
