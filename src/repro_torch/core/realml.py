"""Real-ML coupling for the simulator (Fig. 5): LeNet-5 on cifarlike data,
momentum SGD (Eq. 1), asynchronous parameter server.

The counterpart of ``repro/core/realml.py``. A ``BatchedMLBackend`` owns
the server, the per-client shards and the in-flight (pulled) parameter
snapshots, and exposes *batched* entry points that the numpy engine calls
once per slot cohort: ``pull_batch`` when users start training, then
``finish_async_batch`` when a slot's trainers finish — one local epoch for
the whole cohort at once (``torch.func.vmap`` over the lanes of a
``grad``, a Python loop over the steps), followed by the chunk's pushes
applied in user order by ONE launch of the K1 kernel
(``kernels/fused_update``).

Parameters are flat f32 vectors (``models/lenet.py``), so the server's
parameters and momentum are single buffers and a chunk of pushes is one
K1 pass over the whole model: each push's mix and momentum update, and
every norm the finish needs — the entry ``||v||`` and each push's
post-push norm, so push j's pre-push Eq. (4) norm is norm j and the final
``||v||`` norm k. No torch operation runs around the launch.

Randomness: the initial parameters come from a ``torch.Generator`` seeded
with the run seed, and each client's minibatch permutations from its own
generator seeded with ``hash(client_id) % 2**31`` (the JAX client's key
seed). Both are drawn on the CPU, so a CUDA run and a CPU run of the port
see the same values. They are not jax's bits: the parity tests carry the
JAX parameters over (``params_from_jax``) and feed the JAX package's
permutations through ``_next_perm``.

Equivalence contract (``tests/test_torch_slice.py``): while H == 0 the
online decision ignores the momentum norm, so the schedule — update
counts, lags, push order — equals the JAX package's exactly; accuracy and
the gaps agree within float tolerance (two libraries' f32 convolutions).
"""
from __future__ import annotations

from typing import Dict, Type, Union

import numpy as np
import torch
from torch.func import grad, vmap

from ..data.synthetic import cifarlike_dataset, dirichlet_partition
from ..device import resolve_device
from ..kernels.fused_update import KMAX, fused_apply_cohort
from ..models.lenet import init_lenet, lenet_logits, lenet_loss
from .aggregation import AggregationRule
from .server import AsyncParameterServer
from .staleness import gradient_gap


class BatchedMLBackend:
    """Protocol for batched real-ML coupling.

    A backend instance is single-run state: it owns the parameter server,
    the per-client data, and the pulled-parameter snapshots of every
    in-flight user. Construct a fresh backend per run.

    Attributes the engine relies on: ``n_users`` (validated against
    ``SimConfig.n_users``), ``server.rule`` (checked against
    ``SimConfig.aggregation``) and ``eval_every`` (slots between accuracy
    samples).
    """

    name: str = ""
    n_users: int = 0
    eval_every: int = 600

    def bind_fleet(self, fleet_spec, cfg=None) -> None:
        """Receive the run's ``FleetSpec`` and ``SimConfig``
        (``FederatedSim`` calls this at construction)."""

    def pull_batch(self, uids: np.ndarray, version: int) -> None:
        """Snapshot the current global parameters for every uid starting
        training this slot (``version`` is the engine's global version)."""
        raise NotImplementedError

    def finish_async_batch(self, uids: np.ndarray, versions: np.ndarray,
                           lags: np.ndarray, eta: float, beta: float,
                           need_gaps: bool = True):
        """Train the finisher cohort one local epoch and apply its pushes
        in ``uids`` order. Returns ``(gaps, weights)``: each push's Eq. (4)
        gap against the momentum norm *before* that push, and the applied
        mixing weight; ``(None, None)`` with ``need_gaps=False``."""
        raise NotImplementedError

    def v_norm(self) -> float:
        """Current global momentum norm (a host float: a device sync)."""
        raise NotImplementedError

    def evaluate(self) -> float:
        """Test accuracy of the current global model."""
        raise NotImplementedError


ML_BACKENDS: Dict[str, Type[BatchedMLBackend]] = {}


def register_ml_backend(cls: Type[BatchedMLBackend]) -> Type[BatchedMLBackend]:
    if not cls.name:
        raise ValueError(f"{cls.__name__} must set a registry name")
    ML_BACKENDS[cls.name] = cls
    return cls


def registered_ml_backends() -> tuple:
    return tuple(ML_BACKENDS)


def make_backend(ml: Union[str, BatchedMLBackend], n_users: int, *,
                 seed: int = 0, **kwargs) -> BatchedMLBackend:
    """Resolve ``ml`` to a fresh backend instance. Strings go through the
    registry; instances pass through as-is."""
    if isinstance(ml, BatchedMLBackend):
        return ml
    if isinstance(ml, str):
        if ml not in ML_BACKENDS:
            raise ValueError(f"unknown ML backend {ml!r}; expected one of "
                             f"{registered_ml_backends()} or a "
                             "BatchedMLBackend instance")
        return ML_BACKENDS[ml](n_users, seed=seed, **kwargs)
    raise ValueError(f"ml must be a name or BatchedMLBackend instance, "
                     f"got {type(ml).__name__}")


def _masked_epoch(params, idx, mask, flat_x, flat_y, eta, beta, loss_fn):
    """One local momentum-SGD epoch (Eq. 1) for every lane at once.

    ``params`` is ``(C, N)`` (one flat parameter vector per lane), ``idx``
    ``(C, S, B)`` minibatch rows of ``flat_x``/``flat_y`` and ``mask``
    ``(C, S)``; a masked step leaves that lane's (params, momentum)
    untouched (ragged shards). Returns the trained ``(C, N)``."""
    lane_grad = vmap(grad(loss_fn))
    p = params
    v = torch.zeros_like(params)
    for s in range(idx.shape[1]):
        rows = idx[:, s]
        g = lane_grad(p, flat_x[rows], flat_y[rows])
        v2 = beta * v + (1 - beta) * g
        p2 = p - eta * v2
        m = mask[:, s, None]
        p = torch.where(m, p2, p)
        v = torch.where(m, v2, v)
    return p


class ImageClassifierBackend(BatchedMLBackend):
    """Batched backend for an image classifier with flat parameters on
    cifarlike shards. Subclasses bind three module-level model functions
    (``model_init(generator, device)``, ``model_loss(flat, images,
    labels)``, ``model_logits(flat, images)``) and a registry ``name``.

    Cohorts are processed in chunks of at most ``COHORT_CHUNK`` lanes (a
    cap on the memory of the batched epoch, and K1's ``KMAX``). PyTorch
    runs eagerly, so a chunk needs no padding lanes: every lane is a real
    push, and a chunk's pushes are one K1 launch. A chunk runs as many
    steps as its longest shard; shorter shards mask their extra steps.
    """

    model_init: staticmethod
    model_loss: staticmethod
    model_logits: staticmethod

    COHORT_CHUNK = KMAX     # lanes per batched epoch, pushes per K1 launch
    ALPHA = 100.0       # Dirichlet concentration of the client split
    NOISE = 8.0         # cifarlike difficulty (JAX backend's default)

    def __init__(self, n_users: int, *,
                 eta: float = 0.01, beta: float = 0.9,
                 n_train: int = 10000, n_test: int = 2000,
                 batch_size: int = 20,
                 aggregation: Union[str, AggregationRule] = "replace",
                 seed: int = 0, eval_every: int = 600,
                 kernel: str = "auto", device="cuda"):
        dev = resolve_device(device)
        # construction order (data -> shards -> params -> server) follows
        # the JAX backend's
        images, labels = cifarlike_dataset(n_train, seed=seed,
                                           noise=self.NOISE)
        test_x, test_y = cifarlike_dataset(n_test, seed=seed + 1,
                                           noise=self.NOISE)
        # the paper's non-IID split
        shards = dirichlet_partition(labels, n_users, alpha=self.ALPHA,
                                     seed=seed)
        # the JAX Client's per-client key seed, as a CPU torch.Generator
        self._client_gens = [
            torch.Generator().manual_seed(hash(i) % (2 ** 31))
            for i in range(n_users)]
        params0 = self.model_init(torch.Generator().manual_seed(seed),
                                  device=dev)
        self.server = AsyncParameterServer(params0, eta=eta, beta=beta,
                                           aggregation=aggregation,
                                           kernel=kernel, device=dev)
        self.device = dev
        self.kernel = kernel
        self.n_users = n_users
        self.eta = eta
        self.beta = beta
        self.batch_size = batch_size
        self.eval_every = eval_every
        self.fleet_spec = None

        # client shards concatenated flat; a minibatch gather is one index
        # into these (offset + client-local permutation)
        self._shard_sizes = np.array([len(s) for s in shards], np.int64)
        self._offsets = np.concatenate(
            [[0], np.cumsum(self._shard_sizes)[:-1]]).astype(np.int64)
        self._flat_x = torch.from_numpy(np.concatenate(
            [images[s] for s in shards], axis=0)).to(dev)
        self._flat_y = torch.from_numpy(np.concatenate(
            [labels[s] for s in shards], axis=0).astype(np.int64)).to(dev)
        self._steps = self._shard_sizes // batch_size
        self._test_x = torch.from_numpy(test_x).to(dev)
        self._test_y = torch.from_numpy(test_y.astype(np.int64)).to(dev)
        # pulled-parameter snapshot per in-flight uid: references to the
        # server's (never mutated) parameter tensors
        self._inflight: list = [self.server.params] * n_users

    def bind_fleet(self, fleet_spec, cfg=None) -> None:
        self.fleet_spec = fleet_spec
        self.server.fleet_spec = fleet_spec

    def _next_perm(self, uid: int) -> np.ndarray:
        """The client's next epoch permutation of its shard."""
        return torch.randperm(int(self._shard_sizes[uid]),
                              generator=self._client_gens[uid]).numpy()

    def _cohort_chunks(self, uids):
        """Yield ``(params, idx, mask)`` per chunk of at most
        ``COHORT_CHUNK`` lanes: ``params`` ``(k, N)`` (a free broadcast when
        every lane pulled one snapshot), ``idx`` ``(k, S, B)`` and
        ``mask`` ``(k, S)`` on the device."""
        B = self.batch_size
        for c0 in range(0, len(uids), self.COHORT_CHUNK):
            chunk = [int(u) for u in uids[c0:c0 + self.COHORT_CHUNK]]
            k = len(chunk)
            S = int(max(self._steps[u] for u in chunk))
            idx = np.zeros((k, S, B), np.int64)
            mask = np.zeros((k, S), bool)
            for j, uid in enumerate(chunk):
                steps = int(self._steps[uid])
                perm = self._next_perm(uid)      # consume even if 0 steps
                if steps:
                    idx[j, :steps] = (self._offsets[uid]
                                      + perm[:steps * B]).reshape(steps, B)
                    mask[j, :steps] = True
            lanes = [self._inflight[u] for u in chunk]
            if all(l is lanes[0] for l in lanes):
                params = lanes[0].expand(k, -1)
            else:
                params = torch.stack(lanes)
            yield (params, torch.from_numpy(idx).to(self.device),
                   torch.from_numpy(mask).to(self.device))

    def pull_batch(self, uids, version):
        for uid in np.asarray(uids):
            params, _ = self.server.pull(int(uid))
            self._inflight[int(uid)] = params

    def finish_async_batch(self, uids, versions, lags, eta, beta,
                           need_gaps=True):
        server = self.server
        uids = np.asarray(uids)
        lags = np.asarray(lags)
        if server.rule.needs_gap:
            raise NotImplementedError(
                f"aggregation rule {server.rule.name!r} reads the Eq. 4 "
                "gap; gap-reading rules are still to port (ROADMAP Queue 1 "
                "item 4)")
        weights = np.broadcast_to(np.asarray(
            server.rule.weight(lags, None, None, fleet=self.fleet_spec,
                               users=uids), dtype=np.float64), lags.shape)
        inv_eta = 1.0 / max(self.eta, 1e-12)
        p, v = server.params, server._v
        vnorms = []
        pos = 0
        for params, idx, mask in self._cohort_chunks(uids):
            trained = _masked_epoch(params, idx, mask, self._flat_x,
                                    self._flat_y, self.eta, self.beta,
                                    self.model_loss).contiguous()
            k = trained.shape[0]
            w = weights[pos:pos + k]
            # weights of 1 (replace) are K1's cached ones: no copy
            w = None if np.all(w == 1.0) else torch.tensor(
                w, dtype=torch.float32, device=self.device)
            p, v, _, norms = fused_apply_cohort(p, v, trained, w, inv_eta,
                                                self.beta, kernel=self.kernel)
            if need_gaps:
                vnorms.append(norms[:k])     # each push's pre-push norm
            pos += k
        server.params, server._v = p, v
        # a 0-d device tensor; v_norm() converts it when a policy asks
        server.v_norm = norms[k]
        for uid in uids:
            server.lag_tracker.on_push(int(uid))
            server.in_flight.discard(int(uid))
        if not need_gaps:
            return None, None
        vn = (vnorms[0] if len(vnorms) == 1 else torch.cat(vnorms))
        vn = vn.cpu().numpy().astype(np.float64)
        return (np.asarray(gradient_gap(vn, lags, eta, beta), dtype=float),
                np.array(weights))

    def v_norm(self) -> float:
        return float(self.server.v_norm)

    @torch.no_grad()
    def evaluate(self) -> float:
        logits = self.model_logits(self.server.params, self._test_x)
        return float((logits.argmax(-1) == self._test_y).float().mean())


@register_ml_backend
class LeNetBackend(ImageClassifierBackend):
    """The paper's workload: LeNet-5 (Sec. VI, 62,006 parameters) on
    cifarlike shards. noise=8.0 calibrates cifarlike difficulty so
    accuracy climbs gradually over many local epochs."""

    name = "lenet"
    model_init = staticmethod(init_lenet)
    model_loss = staticmethod(lenet_loss)
    model_logits = staticmethod(lenet_logits)
