"""The port's push compression (``repro_torch/optim/compression.py``)
against the JAX package's on the CPU, inputs drawn from numpy seeds.

Top-k on distinct magnitudes: the same selection, values and
decompressed tensor, bit for bit. Among equal magnitudes the two
libraries may keep different indices (``jax.lax.top_k`` keeps the lower
index; ``torch.topk`` does not say), so there the kept magnitudes must
agree as a multiset and each package's decompressed tensor plus its
residual must give back the input exactly. int8: ``q`` and ``scale``
equal bit for bit (both round half to even; checked on the ±0.5·scale
boundary). ``ErrorFeedback``: payloads and residuals equal bit for bit
over a stream of random updates (the sums are elementwise f32)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.optim import compression as jc  # noqa: E402
from repro_torch.optim import compression as tc  # noqa: E402


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("shape,k", [
    ((1000,), 10), ((1000,), 1), ((1000,), 0), ((1000,), 999),
    ((1000,), 1000), ((1000,), 5000), ((16, 24), 37), ((), 3), ((0,), 4),
    ((3, 0), 1)])
def test_topk_matches_jax_on_distinct_magnitudes(shape, k):
    x = np.random.default_rng(sum(shape) + k).standard_normal(shape) \
        .astype(np.float32)
    ours = tc.topk_compress(torch.from_numpy(x), k)
    theirs = jc.topk_compress(jnp.asarray(x), k)
    assert ours.shape == tuple(theirs.shape)
    assert ours.indices.dtype == torch.int32
    order = np.argsort(np.asarray(ours.indices))
    order_j = np.argsort(np.asarray(theirs.indices))
    _eq(np.asarray(ours.indices)[order], np.asarray(theirs.indices)[order_j])
    _eq(ours.values.numpy()[order], np.asarray(theirs.values)[order_j])
    dec = tc.topk_decompress(ours)
    assert dec.dtype == torch.float32 and tuple(dec.shape) == shape
    _eq(dec, jc.topk_decompress(theirs))


@pytest.mark.parametrize("seed", range(3))
def test_topk_ties_keep_equal_magnitudes_and_reconstruct(seed):
    rng = np.random.default_rng(seed)
    # few distinct magnitudes with both signs: ties straddle the k-th
    x = (rng.integers(1, 4, 200) * rng.choice([-1, 1], 200)) \
        .astype(np.float32)
    for ratio in (0.035, 0.25, 0.665):
        ours, theirs = tc.ErrorFeedback(ratio), jc.ErrorFeedback(ratio)
        p = ours.compress({"x": torch.from_numpy(x)})["x"]
        pj = theirs.compress({"x": jnp.asarray(x)})["x"]
        _eq(np.sort(np.abs(p.values.numpy())),
            np.sort(np.abs(np.asarray(pj.values))))
        for dec, res in ((tc.topk_decompress(p).numpy(),
                          ours.residual["x"].numpy()),
                         (np.asarray(jc.topk_decompress(pj)),
                          np.asarray(theirs.residual["x"]))):
            _eq(dec + res, x)
            assert np.count_nonzero(dec) == int(200 * ratio)
            kept = dec != 0
            _eq(dec[kept], x[kept])
            _eq(res[kept], 0.0)


@pytest.mark.parametrize("n,seed,scale", [(1, 0, 1.0), (100, 1, 1e-3),
                                          (4097, 2, 50.0), (33, 3, 1e4)])
def test_int8_matches_jax(n, seed, scale):
    x = (scale * np.random.default_rng(seed).standard_normal(n)) \
        .astype(np.float32)
    q, s = tc.int8_quantize(torch.from_numpy(x))
    qj, sj = jc.int8_quantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.dim() == 0
    _eq(q, qj)
    _eq(s, sj)
    _eq(tc.int8_dequantize(q, s), jc.int8_dequantize(qj, sj))
    assert np.abs(tc.int8_dequantize(q, s).numpy() - x).max() <= \
        float(s) * 0.5 + 1e-6 * scale


@pytest.mark.parametrize("top", (127.0, 63.5))
def test_int8_rounds_half_to_even_like_jax(top):
    """max |x| = 127 * scale with scale 1 or 0.5 (exact), and entries at
    (k + 0.5) * scale: both packages round them to the even k."""
    scale = top / 127.0
    halves = np.array([0.5, 1.5, 2.5, 3.5, -0.5, -1.5, -2.5, 126.5],
                      np.float32)
    x = np.concatenate([[top], halves * scale]).astype(np.float32)
    q, s = tc.int8_quantize(torch.from_numpy(x))
    qj, _ = jc.int8_quantize(jnp.asarray(x))
    assert float(s) == scale
    _eq(q, qj)
    _eq(q.numpy()[1:], [0, 2, 2, 4, 0, -2, -2, 126])


def test_int8_zero_vector_matches_jax():
    x = np.zeros(17, np.float32)
    q, s = tc.int8_quantize(torch.from_numpy(x))
    qj, sj = jc.int8_quantize(jnp.asarray(x))
    _eq(q, qj)
    assert float(s) == float(sj) == pytest.approx(1e-12)


@pytest.mark.parametrize("ratio,min_k", [(0.05, 1), (0.01, 3), (1.0, 1)])
def test_error_feedback_stream_matches_jax(ratio, min_k):
    rng = np.random.default_rng(int(ratio * 100) + min_k)
    shapes = {"a": (40, 6), "b": (31,), "c": ()}
    ours, theirs = tc.ErrorFeedback(ratio, min_k), jc.ErrorFeedback(ratio,
                                                                   min_k)
    total = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    sent = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    for _ in range(6):
        upd = {k: rng.standard_normal(s).astype(np.float32)
               for k, s in shapes.items()}
        p = ours.compress({k: torch.from_numpy(v) for k, v in upd.items()})
        pj = theirs.compress({k: jnp.asarray(v) for k, v in upd.items()})
        dec = tc.ErrorFeedback.decompress(p)
        dec_j = jc.ErrorFeedback.decompress(pj)
        for k in shapes:
            assert isinstance(p[k], tc.TopK)
            _eq(dec[k], dec_j[k])
            _eq(ours.residual[k], theirs.residual[k])
            total[k] += upd[k]
            sent[k] += dec[k].numpy()
    # what was sent plus what is carried is what was given (f32 sums)
    for k in shapes:
        np.testing.assert_allclose(sent[k] + ours.residual[k].numpy(),
                                   total[k], rtol=1e-5, atol=1e-5)
        if ratio == 1.0:
            _eq(ours.residual[k], np.zeros(shapes[k]))
