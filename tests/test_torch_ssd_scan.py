"""K3's plain versions — the CPU route of the port's SSD scan — against
the JAX package: the Pallas intra-chunk kernel and its wrapper (run as
its own tests run them, in interpret mode), the sequential recurrence
``ssd_chunked_ref`` and the model's XLA ``ssd_chunked``, on inputs drawn
with numpy.

Bound: 1e-4, that of ``tests/test_kernels.py`` (TestSSDScan). The
intra-chunk step carries ``exp(cum_i - cum_j)``, and the cumsum is taken
in another order in each library, so agreement is at f32 rounding of
that difference, not bit for bit. The CUDA kernel itself is held
against this plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ssd_chunked_pallas  # noqa: E402
from repro.kernels.ssd_scan import ssd_chunked_ref as jax_seq  # noqa: E402
from repro.kernels.ssd_scan.kernel import ssd_intra_chunk  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    bf16_bound, bf16_rounding_slack, ssd_chunked, ssd_chunked_ref,
    ssd_intra_chunk_ref, ssd_intra_chunk_ref_bf16)
from repro_torch.kernels.ssd_scan.ref import _warp_cumsum  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

SHAPES = ((2, 64, 4, 16, 16, 16), (1, 128, 2, 32, 64, 32),
          (2, 96, 3, 8, 24, 32), (1, 64, 8, 64, 128, 16))


def _softplus(x):
    return np.logaddexp(x, 0.0)


def _inputs(B, S, nh, ph, s, seed):
    """X, dt (softplus'd), A (negative), B, C as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((B, S, nh, ph)).astype(f),
            _softplus(rng.standard_normal((B, S, nh))).astype(f),
            (-np.exp(0.3 * rng.standard_normal(nh))).astype(f),
            (0.5 * rng.standard_normal((B, S, nh, s))).astype(f),
            (0.5 * rng.standard_normal((B, S, nh, s))).astype(f))


def _close(a, b, tol=1e-4):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float32),
                               np.asarray(b, dtype=np.float32),
                               rtol=tol, atol=tol)


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("B,S,nh,ph,s,chunk", SHAPES)
def test_intra_chunk_ref_matches_pallas_kernel(B, S, nh, ph, s, chunk):
    X, dtv, A, Bh, Ch = _inputs(B, S, nh, ph, s, B + S + nh)
    # the (B, nh) -> BH fold of the wrapper: index b * nh + h
    fold = [np.moveaxis(t, 2, 1).reshape(B * nh, S, -1) for t in (X, Bh, Ch)]
    dtf = np.moveaxis(dtv, 2, 1).reshape(B * nh, S)
    Af = np.tile(A, B)
    args = (fold[0], dtf, Af, fold[1], fold[2])
    ours = ssd_intra_chunk_ref(*_t(args), chunk=chunk)
    theirs = ssd_intra_chunk(*_j(args), chunk=chunk, interpret=True)
    assert len(ours) == len(theirs) == 4
    for a, b in zip(ours, theirs):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        _close(a, b)


@pytest.mark.parametrize("B,S,nh,ph,s,chunk", SHAPES)
def test_wrapper_matches_pallas_wrapper_and_recurrence(B, S, nh, ph, s,
                                                       chunk):
    args = _inputs(B, S, nh, ph, s, B + S + nh)
    y, final = ssd_chunked(*_t(args), chunk)
    yp, fp = ssd_chunked_pallas(*_j(args), chunk, interpret=True)
    yr, fr = jax_seq(*_j(args))
    for ours, theirs in ((y, yp), (y, yr), (final, fp), (final, fr)):
        _close(ours, theirs)
    # the port's own recurrence is the JAX one
    ys, fs = ssd_chunked_ref(*_t(args))
    _close(ys, yr)
    _close(fs, fr)


def test_init_state_continuation():
    """Two halves with the state carried == one call, and == the JAX
    wrapper's continuation (prefill-continuation correctness)."""
    B, S, nh, ph, s, chunk = 1, 64, 2, 8, 16, 16
    X, dtv, A, Bh, Ch = _t(_inputs(B, S, nh, ph, s, 4))
    y_all, f_all = ssd_chunked(X, dtv, A, Bh, Ch, chunk)
    h = S // 2
    y1, f1 = ssd_chunked(X[:, :h], dtv[:, :h], A, Bh[:, :h], Ch[:, :h],
                         chunk)
    y2, f2 = ssd_chunked(X[:, h:], dtv[:, h:], A, Bh[:, h:], Ch[:, h:],
                         chunk, init_state=f1)
    _close(y2, y_all[:, h:])
    _close(f2, f_all)
    j = _j(_inputs(B, S, nh, ph, s, 4))
    _, jf1 = ssd_chunked_pallas(*[t[:, :h] if t.ndim > 1 else t for t in j],
                                chunk, interpret=True)
    jy2, jf2 = ssd_chunked_pallas(*[t[:, h:] if t.ndim > 1 else t
                                    for t in j], chunk, init_state=jf1,
                                  interpret=True)
    _close(y2, jy2)
    _close(f2, jf2)


@pytest.mark.parametrize("S,chunk", ((40, 16), (7, 8), (64, 16)))
def test_model_ssd_chunked_pads_like_jax(S, chunk):
    """The model's ``ssd_chunked`` pads S to a chunk multiple with dt = 0
    steps and slices the padding off, as ``repro.models.ssm.ssd_chunked``
    does; with an initial state too."""
    B, nh, ph, s = 2, 4, 16, 16
    args = _inputs(B, S, nh, ph, s, S)
    init = np.random.default_rng(1).standard_normal(
        (B, nh, s, ph)).astype(np.float32)
    for state in (None, init):
        y, final = ssm.ssd_chunked(*_t(args), chunk,
                                   None if state is None
                                   else torch.from_numpy(state))
        yj, fj = jax_ssm.ssd_chunked(*_j(args), chunk,
                                     None if state is None
                                     else jnp.asarray(state))
        assert tuple(y.shape) == yj.shape == (B, S, nh, ph)
        _close(y, yj)
        _close(final, fj)


def test_bad_calls_raise():
    X, dtv, A, Bh, Ch = _t(_inputs(1, 40, 2, 8, 16, 0))
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_chunked(X, dtv, A, Bh, Ch, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_chunked(X[:, :32], dtv[:, :32], A, Bh[:, :32], Ch[:, :32], 16,
                    kernel="cuda")
    y, _ = ssd_chunked(X[:, :32], dtv[:, :32], A, Bh[:, :32], Ch[:, :32], 16,
                       kernel="reference")
    assert y.shape == X[:, :32].shape


def _grouped(B, S, nh, ph, s, g, seed):
    """Inputs with one B and C per group of nh / g heads: (B, S, g, s)."""
    X, dtv, A, _, _ = _inputs(B, S, nh, ph, s, seed)
    rng = np.random.default_rng(seed + 100)
    Bg, Cg = ((0.5 * rng.standard_normal((B, S, g, s))).astype(np.float32)
              for _ in "BC")
    return X, dtv, A, Bg, Cg


@pytest.mark.parametrize("g", (1, 2))
def test_group_shared_bc_matches_pallas_on_repeated(g):
    """The port's scan given each group's B and C once (nh = 4 heads in g
    groups) equals JAX's Pallas wrapper and sequential recurrence given
    them repeated over the heads of a group."""
    B, S, nh, ph, s, chunk = 2, 64, 4, 16, 16, 16
    X, dtv, A, Bg, Cg = _grouped(B, S, nh, ph, s, g, 10 + g)
    y, final = ssd_chunked(*_t((X, dtv, A, Bg, Cg)), chunk)
    rep = [np.repeat(t, nh // g, axis=2) for t in (Bg, Cg)]
    yp, fp = ssd_chunked_pallas(*_j((X, dtv, A, *rep)), chunk,
                                interpret=True)
    yr, fr = jax_seq(*_j((X, dtv, A, *rep)))
    for ours, theirs in ((y, yp), (y, yr), (final, fp), (final, fr)):
        _close(ours, theirs)


def test_intra_chunk_group_form_equals_folded_per_head_form():
    """ssd_intra_chunk_ref's 4-D group form (B, H, S, .) with B/C
    (B, G, S, s) equals its folded per-head form (B*H, S, .) with B/C
    repeated, as the JAX parity tests call it."""
    B, S, nh, ph, s, g, chunk = 2, 32, 4, 8, 16, 2, 16
    X, dtv, A, Bg, Cg = _t(_grouped(B, S, nh, ph, s, g, 5))
    grouped = ssd_intra_chunk_ref(X.movedim(2, 1), dtv.movedim(2, 1), A,
                                  Bg.movedim(2, 1), Cg.movedim(2, 1),
                                  chunk=chunk)
    fold = [t.repeat_interleave(nh // g, dim=2).movedim(2, 1)
            .reshape(B * nh, S, -1) for t in (Bg, Cg)]
    folded = ssd_intra_chunk_ref(
        X.movedim(2, 1).reshape(B * nh, S, ph),
        dtv.movedim(2, 1).reshape(B * nh, S), A.repeat(B), *fold,
        chunk=chunk)
    for a, b in zip(grouped, folded):
        torch.testing.assert_close(a.reshape(b.shape), b, rtol=1e-6,
                                   atol=1e-6)


def test_strided_inputs_equal_contiguous():
    """The scan reads views: X and the group's B and C as slices of one
    wider (B, S, channels) tensor (the model's conv output), dt
    transposed; the result equals the one from contiguous copies."""
    B, S, nh, ph, s, g, chunk = 2, 48, 4, 8, 16, 2, 16
    X, dtv, A, Bg, Cg = _t(_grouped(B, S, nh, ph, s, g, 6))
    xbc = torch.cat([X.reshape(B, S, -1), Bg.reshape(B, S, -1),
                     Cg.reshape(B, S, -1)], dim=-1)
    Xv, Bv, Cv = torch.split(xbc, [nh * ph, g * s, g * s], dim=-1)
    dt_t = dtv.transpose(1, 2).contiguous().transpose(1, 2)
    views = (Xv.reshape(B, S, nh, ph), dt_t, A, Bv.reshape(B, S, g, s),
             Cv.reshape(B, S, g, s))
    assert not any(t.is_contiguous() for t in views[:2] + views[3:])
    y, f = ssd_chunked(*views, chunk)
    yc, fc = ssd_chunked(*(t.contiguous() for t in views), chunk)
    torch.testing.assert_close(y, yc, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(f, fc, rtol=1e-6, atol=1e-6)


def test_warp_order_cumsum_is_a_cumsum():
    rng = np.random.default_rng(2)
    for Q in (8, 16, 32, 96, 256):
        x = torch.from_numpy(rng.standard_normal((3, 2, Q)))
        torch.testing.assert_close(_warp_cumsum(x), torch.cumsum(x, -1),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("B,S,nh,ph,s,chunk", SHAPES)
def test_bf16_rounding_companion_within_its_bound(B, S, nh, ph, s, chunk):
    """The bf16-rounding plain version (what the bf16 CUDA kernel is held
    against) differs from the f32 one by no more than ``bf16_bound`` —
    and does differ: it rounds."""
    X, dtv, A, Bg, Cg = _grouped(B, S, nh, ph, s, 1, B + S)
    bf = [torch.from_numpy(t).to(torch.bfloat16) for t in (X, Bg, Cg)]
    args = (bf[0].movedim(2, 1), torch.from_numpy(dtv).movedim(2, 1),
            torch.from_numpy(A), bf[1].movedim(2, 1), bf[2].movedim(2, 1))
    rounded = ssd_intra_chunk_ref_bf16(*args, chunk=chunk)
    exact = ssd_intra_chunk_ref(*args, chunk=chunk)
    bounds = bf16_bound(*args, chunk=chunk)
    for a, b, bound in zip(rounded[:2], exact[:2], bounds):
        assert bool(torch.all((a - b).abs() <= bound))
        assert float((a - b).abs().max()) > 0
    for a, b in zip(rounded[2:], exact[2:]):     # expcum, decay: unrounded
        _close(a, b, 1e-6)
    slack = bf16_rounding_slack(*args, chunk=chunk)
    assert slack.shape == rounded[0].shape and bool((slack >= 0).all())
    assert float(slack.max()) <= float(bounds[0].max())
