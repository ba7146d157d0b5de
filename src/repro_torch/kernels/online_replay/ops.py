"""Public wrapper of online's in-slot replay: the kernel
(``csrc/online_replay.cu``) or its plain version, picked by ``kernel``
(``"auto"``, ``"cuda"`` or ``"reference"``) by the rule of
``kernels/mode.py``. ``OnlinePolicy.scan_step`` calls it once a slot."""
from __future__ import annotations

from .. import mode
from .kernel import check_inputs, online_replay_cuda
from .ref import online_replay_ref


def online_replay(waiting, base, rhs, gap_idle, gap_vec, H, *,
                  kernel: str = "auto"):
    """One slot of Alg. 2's decisions for every config row, users in
    index order, and the gap sum of the waiting users' operands in numpy's
    summation order, as the numpy engine's ``decide_batch`` sums them (see
    ``csrc/online_replay.cu`` and ``ref.np_sum_order``). Returns (start
    (B, n) bool, gap_sum (B,) f64)."""
    if mode.use_kernel(kernel, base, "cuda"):
        return online_replay_cuda(waiting, base, rhs, gap_idle, gap_vec, H)
    check_inputs(waiting, base, rhs, gap_idle, gap_vec, H)
    return online_replay_ref(waiting, base, rhs, gap_idle, gap_vec, H)
