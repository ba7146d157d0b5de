"""The port's numpy core (energy, fleet, arrivals, Lyapunov scheduler) is a
copy of the JAX package's: on the same seeds it must give identical
tables, device assignments, arrival draws and online decisions."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import arrivals as j_arr  # noqa: E402
from repro.core import energy as j_energy  # noqa: E402
from repro.core import fleet as j_fleet  # noqa: E402
from repro.core.lyapunov import OnlineScheduler as JSched  # noqa: E402
from repro_torch.core import arrivals as t_arr  # noqa: E402
from repro_torch.core import energy as t_energy  # noqa: E402
from repro_torch.core import fleet as t_fleet  # noqa: E402
from repro_torch.core.lyapunov import OnlineScheduler as TSched  # noqa: E402

SEEDS = (0, 1, 7)


def _assert_tables_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


def test_catalog_tables_identical():
    _assert_tables_equal(j_energy.catalog_tables(), t_energy.catalog_tables())
    assert j_energy.table2_savings() == t_energy.table2_savings()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fleet", ("paper", "synthetic"))
def test_fleet_specs_identical(fleet, seed):
    a = j_fleet.resolve_fleet(fleet).build(np.random.default_rng(seed), 37)
    b = t_fleet.resolve_fleet(fleet).build(np.random.default_rng(seed), 37)
    np.testing.assert_array_equal(a.device_ids, b.device_ids)
    _assert_tables_equal(a.tables, b.tables)
    assert [d.name for d in a.devices] == [d.name for d in b.devices]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("process", ("bernoulli", "diurnal", "bursty"))
def test_arrival_draws_identical(process, seed):
    a = j_arr.resolve_arrival(process).sample(
        np.random.default_rng(seed), 500, 13, len(j_energy.APPS))
    b = t_arr.resolve_arrival(process).sample(
        np.random.default_rng(seed), 500, 13, len(t_energy.APPS))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("H", (0.0, 3.5))
def test_decide_batch_identical(seed, H):
    rng = np.random.default_rng(seed)
    k = 40
    p_s = rng.uniform(0.5, 11.0, k)
    p_i = rng.uniform(0.2, 9.0, k)
    ig = rng.uniform(0.0, 2.0, k)
    outs = []
    for Sched in (JSched, TSched):
        s = Sched(V=5.0, L_b=10.0, eta=0.01, beta=0.9)
        s.Q, s.H = 30.0, H
        d = s.decide_batch(p_s, p_i, ig, lag_base=3, v_norm=0.7)
        s.update_queues(arrivals=4, served=d.n_served, gap_sum=d.gap_sum)
        outs.append((d, s.queue_state()))
    (da, qa), (db, qb) = outs
    np.testing.assert_array_equal(da.schedule, db.schedule)
    np.testing.assert_array_equal(da.gaps, db.gaps)
    assert (da.gap_sum, da.n_served, qa) == (db.gap_sum, db.n_served, qb)
