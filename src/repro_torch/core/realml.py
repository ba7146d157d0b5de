"""Real-ML coupling for the simulator (Fig. 5): LeNet-5 on cifarlike data,
momentum SGD (Eq. 1), asynchronous parameter server vs FedAvg.

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
``||v||`` norm k. The rule's weights enter as K1's ``(k,)`` weight tensor:
none under ``replace``, the host weights of ``fedasync_poly`` and
``hetero_aware`` (lag and user only, known before the chunk). Under
``gap_aware`` push j's weight reads the norm push j - 1 left behind, so
each push is its own one-push K1 launch whose weight is computed on the
device from the previous launch's norm (``scan_weight``, the rule's tensor
twin), with no host copy between pushes.

With ``sync=True`` (the ``sync`` policy, FedAvg) the server is a
``SyncServer``: each finisher cohort is trained from the round's pulled
model and submitted (``local_train_batch``, ``submit_batch``), and the
round's models are averaged when it closes (``sync_aggregate``). No K1
runs under sync.

On the card LeNet's convolutions are im2col and a matmul
(``models/lenet.py``), so two runs there give the same models bit for
bit.

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

from types import SimpleNamespace
from typing import Dict, Type, Union

import numpy as np
import torch
from torch.func import grad, vmap

from ..data.synthetic import cifarlike_dataset, dirichlet_partition
from ..device import resolve_device
from ..kernels.fused_update import KMAX, fused_apply_cohort
from ..models.lenet import init_lenet, lenet_logits, lenet_loss
from .aggregation import AggregationRule
from .server import AsyncParameterServer, SyncServer
from .staleness import gradient_gap, momentum_scale


class BatchedMLBackend:
    """Protocol for batched real-ML coupling.

    A backend instance is single-run state: it owns the parameter server,
    the per-client data, and the pulled-parameter snapshots of every
    in-flight user. Construct a fresh backend per run.

    Attributes the engine relies on: ``n_users`` (validated against
    ``SimConfig.n_users``), ``sync`` (FedAvg rounds: matched against the
    policy's ``sync_rounds``), ``server.rule`` (async servers; checked
    against ``SimConfig.aggregation``) and ``eval_every`` (slots between
    accuracy samples).
    """

    name: str = ""
    n_users: int = 0
    sync: bool = False
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

    def local_train_batch(self, uids: np.ndarray, versions=None):
        """Sync rounds: one local epoch for every uid from its pulled
        parameters; returns the trained models, one row a uid."""
        raise NotImplementedError

    def submit_batch(self, uids, trained, lags, eta, beta):
        """Sync rounds: hand the trained models to the server for the
        round's average. Returns ``(gaps, weights)`` for the push log."""
        raise NotImplementedError

    def sync_aggregate(self) -> None:
        """Sync rounds: average the round's submissions (round close)."""
        raise NotImplementedError

    def v_norm(self) -> float:
        """Current global momentum norm (a host float: a device sync; 0.0
        under sync)."""
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
                 sync: bool = False, seed: int = 0,
                 **kwargs) -> BatchedMLBackend:
    """Resolve ``ml`` to a fresh backend instance. Strings go through the
    registry; instances pass through as-is (their constructor already fixed
    n_users/sync/seed)."""
    if isinstance(ml, BatchedMLBackend):
        return ml
    if isinstance(ml, str):
        if ml not in ML_BACKENDS:
            raise ValueError(f"unknown ML backend {ml!r}; expected one of "
                             f"{registered_ml_backends()} or a "
                             "BatchedMLBackend instance")
        return ML_BACKENDS[ml](n_users, sync=sync, seed=seed, **kwargs)
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


def gap_aware_pushes(p, v, trained, lags, vn_pre, rule, carry, uids, eta,
                     beta, inv_eta, kernel):
    """Apply ``trained``'s k rows in order under a gap-reading rule: one
    one-push K1 launch a row, push j's weight computed on the device from
    the norm the previous launch left (``vn_pre``, a ``(1,)`` f32 tensor,
    for push 0 the entry norm):

        gap_j = eta * (1 - beta^lag_j) / (1 - beta) * vn_pre     (Eq. 4)
        w_j   = rule.scan_weight(gap_j, ...)                     (f32)

    No host copy between pushes: the Eq. 4 scales of the chunk go to the
    device once. Returns (p', v', pre-push norms (k,), weights (k,),
    final norm (1,)), all on ``p``'s device."""
    k = trained.shape[0]
    dev = p.device
    scales = torch.tensor(np.asarray(momentum_scale(np.asarray(lags), eta,
                                                    beta), np.float32),
                          device=dev)
    lag_t = torch.as_tensor(np.asarray(lags), device=dev)
    uid_t = torch.as_tensor(np.asarray(uids), device=dev)
    consts = rule.scan_operands()
    pre, ws = [], []
    for j in range(k):
        pv = SimpleNamespace(lag=lag_t[j:j + 1], gap=scales[j:j + 1] * vn_pre,
                             v_norm=vn_pre, users=uid_t[j:j + 1],
                             consts=consts, float_dtype=torch.float32)
        _, w = rule.scan_weight(carry, pv)
        p, v, _, norms = fused_apply_cohort(p, v, trained[j:j + 1], w,
                                            inv_eta, beta, kernel=kernel)
        pre.append(vn_pre)
        ws.append(w)
        vn_pre = norms[1:]
    return p, v, torch.cat(pre), torch.cat(ws), vn_pre


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

    def __init__(self, n_users: int, *, sync: bool = False,
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
        if sync:
            self.server = SyncServer(params0, device=dev)
        else:
            self.server = AsyncParameterServer(params0, eta=eta, beta=beta,
                                               aggregation=aggregation,
                                               kernel=kernel, device=dev)
        self.device = dev
        self.kernel = kernel
        self.sync = sync
        self.n_users = n_users
        self.eta = eta
        self.beta = beta
        self.batch_size = batch_size
        self.eval_every = eval_every
        self.fleet_spec = None
        self._agg_carry = None

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
        """Bind the run's FleetSpec: the async server's host weights and
        the rule's carry (``hetero_aware``'s per-user scales) read it."""
        self.fleet_spec = fleet_spec
        if not self.sync:
            self.server.fleet_spec = fleet_spec
            self._agg_carry = self.server.rule.init_carry(
                self.n_users, cfg, fleet_spec)

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

    def _train(self, params, idx, mask):
        """One chunk's batched local epoch: the trained ``(k, N)``."""
        return _masked_epoch(params, idx, mask, self._flat_x, self._flat_y,
                             self.eta, self.beta,
                             self.model_loss).contiguous()

    def local_train_batch(self, uids, versions=None):
        uids = np.asarray(uids)
        if not len(uids):
            return None
        parts = [self._train(*chunk) for chunk in self._cohort_chunks(uids)]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def submit_batch(self, uids, trained, lags, eta, beta):
        # the Eq. 4 gap against the sync backend's norm, 0.0: a FedAvg
        # round has no server momentum
        gaps = np.asarray(gradient_gap(self.v_norm(), np.asarray(lags), eta,
                                       beta), dtype=float)
        for j in range(len(uids)):
            self.server.submit(trained[j])
        return gaps, np.ones(len(uids))

    def sync_aggregate(self):
        self.server.aggregate()

    def finish_async_batch(self, uids, versions, lags, eta, beta,
                           need_gaps=True):
        server = self.server
        rule = server.rule
        uids = np.asarray(uids)
        lags = np.asarray(lags)
        inv_eta = 1.0 / max(self.eta, 1e-12)
        p, v = server.params, server._v
        vnorms, wparts = [], []
        if rule.needs_gap:
            # the entry norm: the device scalar the last finish left, or
            # the server's float (0.0 before the first push)
            vn = server.v_norm
            vn = vn.reshape(1) if torch.is_tensor(vn) else torch.full(
                (1,), float(vn), dtype=torch.float32, device=self.device)
        else:
            # lag- and user-only weights are known before the chunk; K1
            # applies them in f32, and the log records what it applied
            weights = np.broadcast_to(np.asarray(
                rule.weight(lags, None, None, fleet=self.fleet_spec,
                            users=uids), dtype=np.float32), lags.shape)
        pos = 0
        for params, idx, mask in self._cohort_chunks(uids):
            trained = self._train(params, idx, mask)
            k = trained.shape[0]
            if rule.needs_gap:
                p, v, pre, w, vn = gap_aware_pushes(
                    p, v, trained, lags[pos:pos + k], vn, rule,
                    self._agg_carry, uids[pos:pos + k], self.eta, self.beta,
                    inv_eta, self.kernel)
                vnorms.append(pre)
                wparts.append(w)
            else:
                w = weights[pos:pos + k]
                # weights of 1 (replace) are K1's cached ones: no copy
                w = None if np.all(w == 1.0) else torch.from_numpy(
                    w.copy()).to(self.device)
                p, v, _, norms = fused_apply_cohort(
                    p, v, trained, w, inv_eta, self.beta,
                    kernel=self.kernel)
                vnorms.append(norms[:k])     # each push's pre-push norm
                vn = norms[k:]
            pos += k
        server.params, server._v = p, v
        # a 0-d device tensor; v_norm() converts it when a policy asks
        server.v_norm = vn[0]
        for uid in uids:
            server.lag_tracker.on_push(int(uid))
            server.in_flight.discard(int(uid))
        if not need_gaps:
            return None, None
        if rule.needs_gap:
            # one copy to the host for the finish: norms, then weights
            both = torch.cat(vnorms + wparts).cpu().numpy()
            vn, applied = both[:len(uids)], both[len(uids):]
        else:
            vn = torch.cat(vnorms).cpu().numpy()
            applied = weights
        return (np.asarray(gradient_gap(vn.astype(np.float64), lags, eta,
                                        beta), dtype=float),
                applied.astype(np.float64))

    def v_norm(self) -> float:
        return 0.0 if self.sync else float(self.server.v_norm)

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
