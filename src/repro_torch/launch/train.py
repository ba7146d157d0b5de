"""End-to-end async federated LM trainer — the counterpart of
``repro/launch/train.py``.

The paper's system mapped onto accelerators: each *island* plays the role
of a battery device. Islands pull the global model from the
``AsyncParameterServer``, run ``local_steps`` momentum-SGD steps on their
own data shard (each step's update is one K2 launch), and push back (one
K1 launch) — scheduled per slot by the paper's Lyapunov controller
(Alg. 2) against a per-island power profile (the co-running discount
models low-price windows). Heartbeats, straggler EWMAs and injected
failures with re-absorption by the queue are as in the JAX trainer.

Every host-side draw (failures, app arrivals, data batches) is numpy in
the JAX trainer's order, so a run with the same seed and the same initial
parameters makes the same decisions in the same slots. The initial
parameters come from a ``torch.Generator`` (not jax's bits). Tensors live
on ``device`` (CUDA unless the caller asks for the CPU); ``icfg.kernel``
picks how K1 and K2 run (``auto``: Triton on CUDA tensors, the plain
version on CPU tensors).

Pushes can be compressed (``compress_ratio > 0``: top-k with error
feedback on the island's delta, ``optim/compression.py``); the server
state is checkpointed every ``ckpt_every`` slots and at the end
(``ckpt_dir``, the JAX package's on-disk layout) and a run can ``resume``
from the last checkpoint; ``n_shards > 0`` serves from the sharded
serving-tier server (``serve/server.py``: one K1 launch a shard a push).
Every aggregation rule of the JAX trainer runs (``replace``,
``fedasync_poly``, ``gap_aware``; ``hetero_aware`` needs a fleet, which
the trainer binds to no server, and raises at the first push, as in the
JAX trainer).

    python -m repro_torch.launch.train --arch qwen3-0.6b --no-smoke \\
        --islands 4 --slots 120
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..checkpoint.checkpointer import Checkpointer
from ..core.energy import APPS, DEVICE_NAMES, TESTBED
from ..core.lyapunov import OnlineScheduler, UserSlotState
from ..core.server import AsyncParameterServer
from ..data.synthetic import synthetic_tokens, token_batches
from ..device import resolve_device
from ..fault.monitor import HeartbeatMonitor, StragglerDetector
from ..kernels.fused_update import KERNEL_MODES
from ..kernels.fused_update.ops import tree_map
from ..models import build_model
from ..optim.compression import ErrorFeedback
from ..serve.server import ShardedAsyncParameterServer
from .steps import make_train_step


@dataclasses.dataclass
class IslandConfig:
    n_islands: int = 4
    slots: int = 300                 # scheduler slots
    slot_seconds: float = 1.0
    local_steps: int = 4             # train steps per local epoch
    batch: int = 8
    seq: int = 64
    eta: float = 0.05
    beta: float = 0.9
    # V scales with the queue-backlog magnitude: the paper's knee V~4e3 is
    # for 25 devices x 3 h; a few-island run needs Q-threshold
    # V*(P^b - P^d) reachable within Q <= n_islands.
    V: float = 5.0
    L_b: float = 50.0
    epsilon: float = 0.05
    app_arrival_p: float = 0.02      # low-price-window arrival probability
    train_slots: int = 8             # slots one local epoch occupies
    compress_ratio: float = 0.0      # 0 = off; else top-k ratio w/ EF
    aggregation: str = "replace"
    kernel: str = "auto"             # K1/K2 impl: auto|triton|reference
    n_shards: int = 0                # >0: sharded serving-tier server
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50             # slots
    eval_every: int = 50
    resume: bool = False             # restore server params from ckpt_dir
    fail_p: float = 0.0              # per-island per-slot failure probability
    down_slots: int = 30             # slots a failed island stays dark
    heartbeat_timeout: float = 5.0   # slots without a beat => evicted
    seed: int = 0


def _slot_tensor(t: int) -> torch.Tensor:
    """The checkpoint's ``slot`` leaf: a 0-d int32, as the JAX trainer
    saves it."""
    return torch.tensor(t, dtype=torch.int32)


def _to_device(batch, device):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


class Island:
    """One island: train step + local data shard + power profile."""

    def __init__(self, uid: int, cfg_model, icfg: IslandConfig, device):
        self.uid = uid
        self.icfg = icfg
        self.device = TESTBED[DEVICE_NAMES[uid % len(DEVICE_NAMES)]]
        self.torch_device = device
        self.step_fn = make_train_step(cfg_model, eta=icfg.eta,
                                       beta=icfg.beta, kernel=icfg.kernel)
        stream = synthetic_tokens(200_000, cfg_model.vocab_size,
                                  seed=1000 + uid)
        self._batches = token_batches(stream, icfg.batch, icfg.seq,
                                      n_batches=10 ** 9, seed=uid)
        self.ef = (ErrorFeedback(icfg.compress_ratio)
                   if icfg.compress_ratio > 0 else None)
        self.energy_j = 0.0
        self.updates = 0
        self.busy_slots = 0
        self.app: Optional[str] = None

    def local_epoch(self, params, v, lag: int):
        metrics = None
        for _ in range(self.icfg.local_steps):
            batch = _to_device(next(self._batches), self.torch_device)
            params, v, metrics = self.step_fn(params, v, batch, lag)
        self.updates += 1
        return params, v, metrics


def run(cfg_model, icfg: IslandConfig, *, device="cuda", log=print):
    dev = resolve_device(device)
    model = build_model(cfg_model)
    params = model.init(torch.Generator().manual_seed(icfg.seed), device=dev)
    if icfg.n_shards > 0:
        # serving-tier store: params partitioned into shards, pushes
        # applied shard-local (same pull/push protocol)
        server = ShardedAsyncParameterServer(
            params, eta=icfg.eta, beta=icfg.beta,
            aggregation=icfg.aggregation, n_shards=icfg.n_shards,
            kernel=icfg.kernel, device=dev)
    else:
        server = AsyncParameterServer(params, eta=icfg.eta, beta=icfg.beta,
                                      aggregation=icfg.aggregation,
                                      kernel=icfg.kernel, device=dev)
    sched = OnlineScheduler(icfg.V, icfg.L_b, icfg.eta, icfg.beta,
                            icfg.epsilon, icfg.slot_seconds)
    islands = [Island(i, cfg_model, icfg, dev)
               for i in range(icfg.n_islands)]
    ckpt = Checkpointer(icfg.ckpt_dir) if icfg.ckpt_dir else None
    rng = np.random.default_rng(icfg.seed)
    start_slot = 0
    if ckpt and icfg.resume and ckpt.latest_step() is not None:
        restored, _ = ckpt.restore({"params": params,
                                    "slot": _slot_tensor(0)})
        server.params = restored["params"]
        start_slot = int(restored["slot"])
        log(f"resumed from checkpoint at slot {start_slot}")
    del params      # the server holds the model (the sharded one a copy)

    # fault tolerance: islands heartbeat once per slot while alive; a
    # crashed island stops beating, gets evicted after the timeout, and
    # re-enters the queue when it comes back (elastic membership — the
    # queue re-absorbs it, Def. 3 arrivals).
    clock = {"t": 0.0}
    hb = HeartbeatMonitor(icfg.heartbeat_timeout, clock=lambda: clock["t"])
    straggle = StragglerDetector(clock=lambda: clock["t"])
    downtime = {i.uid: 0 for i in islands}
    failures = 0

    # evaluation stream (held out)
    eval_stream = synthetic_tokens(20_000, cfg_model.vocab_size, seed=7)
    eval_batches = [_to_device(b, dev) for _, b in zip(range(4), token_batches(
        eval_stream, icfg.batch, icfg.seq, 4, seed=7))]

    @torch.no_grad()
    def evaluate(p):
        return float(np.mean([float(model.loss(p, b)[0])
                              for b in eval_batches]))

    state = {i.uid: {"mode": "waiting", "left": 0, "pull": None}
             for i in islands}
    history = []
    for t in range(start_slot, start_slot + icfg.slots):
        clock["t"] = float(t)
        # initial cohort enters the task queue at t=0 (Def. 3: A(0) = n)
        arrivals = len(islands) if t == start_slot else 0
        served = 0
        gap_sum = 0.0
        for isl in islands:
            # --- failure injection / recovery ---------------------------
            if downtime[isl.uid] > 0:
                downtime[isl.uid] -= 1
                if downtime[isl.uid] == 0:
                    state[isl.uid] = {"mode": "waiting", "left": 0,
                                      "pull": None}
                    arrivals += 1          # re-absorbed by the queue
                    hb.beat(isl.uid)
                continue
            if icfg.fail_p and rng.random() < icfg.fail_p:
                failures += 1
                downtime[isl.uid] = icfg.down_slots
                if state[isl.uid]["mode"] == "training":
                    server.in_flight.discard(isl.uid)   # lost island
                state[isl.uid]["mode"] = "dead"
                continue
            hb.beat(isl.uid)
            # low-price window (the "app") arrival / expiry
            if isl.app is None and rng.random() < icfg.app_arrival_p:
                isl.app = APPS[rng.integers(0, len(APPS))]
                isl._app_left = icfg.train_slots
            elif isl.app is not None:
                isl._app_left -= 1
                if isl._app_left <= 0:
                    isl.app = None

            st = state[isl.uid]
            if st["mode"] == "training":
                st["left"] -= 1
                isl.busy_slots += 1
                if st["left"] <= 0:
                    pulled_params, pulled_v, lag_est = st["pull"]
                    st["pull"] = None
                    new_p, _, _ = isl.local_epoch(pulled_params, pulled_v,
                                                  lag_est)
                    straggle.on_update(isl.uid)
                    if isl.ef is not None:
                        delta = tree_map(lambda a, b: a - b, new_p,
                                         pulled_params)
                        payload = isl.ef.compress(delta)
                        delta = ErrorFeedback.decompress(payload)
                        new_p = tree_map(
                            lambda b, d: (b.float() + d).to(b.dtype),
                            pulled_params, delta)
                    server.push(isl.uid, new_p)
                    st["mode"] = "waiting"
                    arrivals += 1
                continue

            # waiting: Lyapunov per-slot decision (paper Alg. 2)
            a = isl.app is not None
            ap = isl.device.apps[isl.app] if a else None
            u = UserSlotState(
                p_corun=ap.p_corun if a else 0.0,
                p_app=ap.p_app if a else 0.0,
                p_train=isl.device.p_train, p_idle=isl.device.p_idle,
                app_running=a,
                lag_estimate=server.lag_estimate(isl.uid),
                idle_gap=st.get("idle_gap", 0.0))
            d = sched.decide(u, server.v_norm)
            gap_sum += d.gap
            if d.schedule:
                g_params, _ = server.pull(isl.uid)
                v0 = tree_map(torch.zeros_like, g_params)
                st["pull"] = (g_params, v0, u.lag_estimate)
                st["mode"] = "training"
                st["left"] = icfg.train_slots
                st["idle_gap"] = 0.0
                served += 1
            else:
                st["idle_gap"] = st.get("idle_gap", 0.0) + icfg.epsilon

        # energy accounting (Eq. 10) — dead islands draw nothing
        for isl in islands:
            if state[isl.uid]["mode"] == "dead":
                continue
            training = state[isl.uid]["mode"] == "training"
            p = isl.device.power(training, isl.app is not None, isl.app)
            isl.energy_j += p * icfg.slot_seconds
        sched.update_queues(arrivals, served, gap_sum)

        if ckpt and t and t % icfg.ckpt_every == 0:
            ckpt.save({"params": server.params, "slot": _slot_tensor(t)}, t)
        if t and t % icfg.eval_every == 0:
            l = evaluate(server.params)
            history.append((t, l, sum(i.energy_j for i in islands)))
            log(f"slot {t:5d}  eval_loss {l:.4f}  "
                f"E {sum(i.energy_j for i in islands) / 1e3:.2f} kJ  "
                f"updates {server.lag_tracker.version}  "
                f"Q {sched.Q:.0f} H {sched.H:.1f}")

    if ckpt:
        # the JAX trainer's final save: step and slot ``icfg.slots``
        ckpt.save({"params": server.params,
                   "slot": _slot_tensor(icfg.slots)}, icfg.slots)
        ckpt.wait()
    return {
        "final_loss": evaluate(server.params),
        "energy_j": sum(i.energy_j for i in islands),
        "updates": server.lag_tracker.version,
        "history": history,
        "params": server.params,
        "failures": failures,
        "stragglers": sorted(straggle.stragglers()),
        "final_slot": start_slot + icfg.slots,
    }


def main(argv=None):
    from ..configs import get_config, get_smoke_config

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the reduced smoke config (--no-smoke: full width)")
    ap.add_argument("--islands", type=int, default=4)
    ap.add_argument("--slots", type=int, default=300)
    ap.add_argument("--steps-per-epoch", type=int, default=4)
    ap.add_argument("--compress", type=float, default=0.0)
    ap.add_argument("--aggregation", default="replace",
                    choices=["replace", "fedasync_poly", "gap_aware"])
    ap.add_argument("--shards", type=int, default=0,
                    help=">0: serve from the sharded parameter store")
    ap.add_argument("--kernel", default="auto", choices=list(KERNEL_MODES),
                    help="K1/K2 implementation (auto = Triton on CUDA "
                         "tensors, the plain version on CPU tensors)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    icfg = IslandConfig(n_islands=args.islands, slots=args.slots,
                        local_steps=args.steps_per_epoch,
                        compress_ratio=args.compress,
                        aggregation=args.aggregation,
                        kernel=args.kernel,
                        n_shards=args.shards,
                        ckpt_dir=args.ckpt_dir)
    t0 = time.time()
    out = run(cfg, icfg, device=args.device)
    print(f"done in {time.time() - t0:.1f}s  final_loss={out['final_loss']:.4f}"
          f"  energy={out['energy_j'] / 1e3:.2f} kJ  updates={out['updates']}")


if __name__ == "__main__":
    main()
