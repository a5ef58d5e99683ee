"""The SGD factorization of the port (``ops/factorize.py``, ``models/mf.py``)
against ``polara_tpu``'s on the CPU: the same numpy inputs through both
packages, each tolerance stated with its test."""
import numpy as np
import optax
import pytest
import torch
import jax.numpy as jnp

from polara_tpu.data import RecommenderData as JaxData
from polara_tpu.datasets import make_synthetic_interactions
from polara_tpu.models import ProbabilisticMF as JaxPMF
from polara_tpu.ops import factorize as jf
from polara_tpu_torch.data import RecommenderData as TorchData
from polara_tpu_torch.models import ProbabilisticMF as TorchPMF
from polara_tpu_torch.ops import factorize as tf
from polara_tpu_torch.runtime.convert import factors_from_jax

N_ROWS, N_COLS, RANK = 60, 40, 4
OPTIMIZERS = ["sgd", "adagrad", "rmsprop", "adam", "adanorm", "gnprop",
              "gnpropz"]


@pytest.fixture(scope="module")
def stream():
    rs = np.random.RandomState(0)
    pairs = np.unique(np.stack([rs.randint(0, N_ROWS, 900),
                                rs.randint(0, N_COLS, 900)], 1), axis=0)
    vals = rs.randint(1, 6, len(pairs)).astype(np.float32)
    return pairs[:, 0], pairs[:, 1], vals


@pytest.mark.parametrize("kernel", [False, True])
def test_batch_grads_match_jax(stream, kernel):
    """One padded batch (last 28 entries weigh 0), generalized weights,
    with and without a KPMF kernel on the rows: rtol 1e-5 (f32; the
    scatter sums run in another order), atol 1e-5 of each output's
    largest magnitude."""
    rows, cols, vals = stream
    rs = np.random.RandomState(1)
    p = (0.1 * rs.randn(N_ROWS, RANK)).astype(np.float32)
    q = (0.1 * rs.randn(N_COLS, RANK)).astype(np.float32)
    sel = rs.randint(0, len(rows), 128)
    weight = (np.arange(128) < 100).astype(np.float32)
    row_inv = rs.rand(N_ROWS).astype(np.float32)
    col_inv = rs.rand(N_COLS).astype(np.float32)
    k = rs.rand(N_ROWS, N_ROWS).astype(np.float32)
    k = k + k.T
    args = (rows[sel], cols[sel], vals[sel], weight)
    want = jf._batch_grads(
        jnp.asarray(p), jnp.asarray(q), *map(jnp.asarray, args), 0.5,
        jnp.asarray(row_inv), jnp.asarray(col_inv),
        jf.KernelOperator.from_dense(jnp.asarray(k)) if kernel else None,
        None)
    got = tf._batch_grads(
        torch.as_tensor(p), torch.as_tensor(q), *map(torch.as_tensor, args),
        0.5, torch.as_tensor(row_inv), torch.as_tensor(col_inv),
        tf.KernelOperator.from_dense(torch.as_tensor(k)) if kernel else None,
        None)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_steps_match_optax(name):
    """Five steps of each hand-written optimizer against the JAX
    package's ``_make_optimizer`` (optax) on the same gradients, in f64:
    rtol 1e-5 on the parameters after every step.  Gradient rows span
    1e-4..1 and some rows get none, so the ``eps`` placement (inside or
    outside the root), adagrad's 0.1 start and the row-norm optimizers'
    untouched rows all show."""
    rs = np.random.RandomState(2)
    params = [rs.randn(N_ROWS, RANK), rs.randn(N_COLS, RANK)]
    jopt, topt = jf._make_optimizer(name, 0.05), tf._make_optimizer(name,
                                                                    0.05)
    jp = tuple(jnp.asarray(x) for x in params)
    tp = tuple(torch.as_tensor(x) for x in params)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for _ in range(5):
        grads = []
        for n in (N_ROWS, N_COLS):
            g = rs.randn(n, RANK) * 10.0 ** rs.uniform(-4, 0, (n, 1))
            g[rs.rand(n) < 0.3] = 0.0
            grads.append(g)
        updates, jstate = jopt.update(tuple(map(jnp.asarray, grads)),
                                      jstate, jp)
        jp = optax.apply_updates(jp, updates)
        updates, tstate = topt.update(tuple(map(torch.as_tensor, grads)),
                                      tstate)
        tp = tf.apply_updates(tp, updates)
        for t, j in zip(tp, jp):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="Unknown optimizer"):
        tf._make_optimizer("lbfgs", 0.1)


def test_mf_train_padding_weighs_nothing():
    """50 events in one batch of 64: the 14 entries that repeat the stream
    (``np.resize``) weigh 0.  With a zero learning rate the factors stay
    at their start, and the epoch's RMSE is that of the 50 real events
    alone (rtol 1e-6)."""
    rs = np.random.RandomState(3)
    rows = rs.randint(0, 20, 50)
    cols = rs.randint(0, 10, 50)
    vals = rs.rand(50).astype(np.float32)
    res = tf.mf_train(rows, cols, vals, (20, 10), 3, lrate=0.0,
                      batch_size=64, num_epochs=1, seed=0, device="cpu")
    err = vals - np.sum(res.p.numpy()[rows] * res.q.numpy()[cols], 1)
    np.testing.assert_allclose(res.rmse_history[0],
                               np.sqrt(np.mean(err.astype(np.float64) ** 2)),
                               rtol=1e-6)


def _mean_final_rmse(train, rows, cols, vals, seeds):
    return float(np.mean([train(rows, cols, vals, seed).rmse_history[-1]
                          for seed in seeds]))


def test_mf_train_end_rmse_matches_jax(stream):
    """Different random streams (permutations, starts), so the trained
    factors differ: the final RMSE, averaged over three seeds, within 3%
    of the JAX package's; both stop by the same tolerance rule."""
    rows, cols, vals = stream
    kwargs = dict(shape=(N_ROWS, N_COLS), rank=RANK, lrate=0.05,
                  num_epochs=30, batch_size=64, generalized=True)

    def jax_train(r, c, v, seed):
        return jf.mf_train(r, c, v, seed=seed, **kwargs)

    def torch_train(r, c, v, seed):
        return tf.mf_train(r, c, v, seed=seed, device="cpu", **kwargs)

    want = _mean_final_rmse(jax_train, rows, cols, vals, (0, 1, 2))
    got = _mean_final_rmse(torch_train, rows, cols, vals, (0, 1, 2))
    assert abs(got - want) <= 0.03 * want, (got, want)


def test_mf_train_stops_on_tolerance(stream):
    """The relative-improvement test ends training early (a huge ``tol``
    stops after the first two epochs: the float64-max start value gives
    epoch 1 an improvement of ~1)."""
    rows, cols, vals = stream
    history = []
    tf.mf_train(rows, cols, vals, (N_ROWS, N_COLS), RANK, tol=0.99,
                num_epochs=10, seed=0, device="cpu", iter_errors=history)
    assert len(history) == 2


@pytest.fixture(scope="module")
def pmf_pair():
    events = make_synthetic_interactions(n_users=200, n_items=60,
                                         n_events=4000, seed=0)
    pair = []
    for cls in (JaxData, TorchData):
        data = cls(events.copy(), "userid", "movieid", "rating", seed=0,
                   verbose=False)
        data.warm_start = False
        data.holdout_size = 1
        data.test_ratio = 0.25
        data.test_fold = 1
        data.prepare()
        pair.append(data)
    return pair


def _pmf(cls, data, **kw):
    model = cls(data, device="cpu", **kw) if cls is TorchPMF else cls(data,
                                                                      **kw)
    model.verbose = False
    model.rank = RANK
    model.learn_rate = 0.05
    model.num_epochs = 30
    model.batch_size = 256
    return model


def test_pmf_model_end_metrics_match_jax(pmf_pair):
    """PMF through the data model: HR@10 averaged over three seeds within
    0.1 of the JAX package's (50 test users, one held-out item each; one
    seed's HR@10 spreads by ~0.035 in either package, so 0.1 is about
    three standard deviations of the difference of two means), and RMSE
    histories that fall."""
    jdata, tdata = pmf_pair
    hr = {}
    for cls, data in ((JaxPMF, jdata), (TorchPMF, tdata)):
        scores = []
        for seed in (0, 1, 2):
            model = _pmf(cls, data, seed=seed)
            scores.append(model.evaluate("relevance").hr)
            assert model.rmse_history[-1] < model.rmse_history[0]
        hr[cls] = np.mean(scores)
    assert abs(hr[TorchPMF] - hr[JaxPMF]) <= 0.1, hr


def test_pmf_carried_factors_give_jax_recommendations(pmf_pair):
    """The JAX model's factors carried across (dyadic, so every score is
    exact in f32): identical recommendations through the port's scorer,
    and warm start raises as in the JAX package."""
    jdata, tdata = pmf_pair
    ref = _pmf(JaxPMF, jdata, seed=0)
    ref.build()
    rs = np.random.RandomState(4)
    factors = {name: np.round(rs.randn(*np.asarray(v).shape) * 4) / 4
               for name, v in ref.factors.items()}
    ref.factors = {k: jnp.asarray(v, jnp.float32) for k, v in factors.items()}
    port = _pmf(TorchPMF, tdata)
    port.set_factors(factors_from_jax(factors, device="cpu"))
    np.testing.assert_array_equal(port.recommendations, ref.recommendations)
