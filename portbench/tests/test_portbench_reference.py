"""The plain references against tiny plain runs on the CPU."""
import math

import numpy as np
import pytest
import torch

from portbench import plain, spec

CPU = torch.device("cpu")


def tiny_events(seed=0, n_users=40, n_items=30, per_user=8):
    rs = np.random.RandomState(seed)
    rows, cols = [], []
    for u in range(n_users):
        items = rs.choice(n_items, per_user, replace=False)
        rows += [u * 3 + 100] * per_user        # sparse external ids
        cols += list(items * 7 + 5)
    rows, cols = np.array(rows), np.array(cols)
    vals = rs.randint(1, 6, len(rows)).astype(np.float64)
    return rows, cols, vals


def tiny_problem(seed=0):
    rows, cols, vals = tiny_events(seed)
    hold = np.zeros(len(rows), bool)
    hold[::8] = True                          # first event of each user
    return plain.make_problem(rows, cols, vals, hold), (rows, cols, vals,
                                                        hold)


def test_problem_reindexes_as_polara_does():
    problem, (rows, cols, vals, hold) = tiny_problem()
    items = np.unique(cols[~hold])
    users = list(dict.fromkeys(rows[~hold]))         # first appearance
    assert problem.n_items == len(items) and problem.n_users == len(users)
    for r, c, v in zip(problem.rows, problem.cols, problem.vals):
        assert (users[r] * 1, items[c]) in set(zip(rows[~hold],
                                                   cols[~hold]))
    kept = [i for i in np.where(hold)[0] if cols[i] in set(items)]
    assert len(problem.test_users) == len(kept)
    for t, i in zip(problem.test_users, kept):
        assert users[t] == rows[i]


def test_holdout_items_absent_from_training_are_dropped():
    rows = np.array([0, 0, 1, 1, 1])
    cols = np.array([1, 2, 1, 3, 9])
    vals = np.ones(5)
    hold = np.array([False, True, False, False, True])
    problem = plain.make_problem(rows, cols, vals, hold)
    # items 2 and 9 appear only in the holdout: both users are dropped
    assert len(problem.test_users) == 0


def loop_metrics(problem, recs):
    out = {k: 0.0 for k in ("precision", "recall", "miss_rate", "ndcg",
                            "map", "arhr")}
    tp_sum = fp_sum = fn_sum = 0.0
    for u, row in enumerate(recs):
        row = [r for r in row if r >= 0]
        target = problem.hold_items[u]
        rank = row.index(target) + 1 if target in row else 0
        tp = 1.0 if rank else 0.0
        fp, fn = len(row) - tp, 1.0 - tp
        tp_sum, fp_sum, fn_sum = tp_sum + tp, fp_sum + fp, fn_sum + fn
        if tp:
            out["precision"] += tp / (tp + fp)
            out["recall"] += 1.0
            out["arhr"] += 1.0 / rank
            out["map"] += 1.0 / rank
            out["ndcg"] += 1.0 / math.log2(1 + rank)
        else:
            out["miss_rate"] += 1.0
    n = len(recs)
    out = {k: v / n for k, v in out.items()}
    flat = [r for row in recs for r in row if 0 <= r < problem.n_items]
    out.update(coverage=len(set(flat)) / problem.n_items,
               true_positive=tp_sum, false_positive=fp_sum,
               false_negative=fn_sum)
    return out


def test_metrics_match_a_loop():
    problem, _ = tiny_problem()
    rs = np.random.RandomState(1)
    recs = np.stack([rs.choice(problem.n_items, 10, replace=False)
                     for _ in problem.test_users])
    recs[:5, 0] = problem.hold_items[:5]           # some hits, rank 1
    recs[5:9, 3] = problem.hold_items[5:9]         # rank 4
    recs[-1, -2:] = -1                             # a short row
    got = plain.metrics(problem, recs)
    want = loop_metrics(problem, recs)
    assert set(got) == set(want)
    for name in want:
        assert got[name] == pytest.approx(want[name], rel=1e-12), name
    assert plain.metric_gap(got, want) < 1e-12
    assert plain.metric_gap({**got, "ndcg": got["ndcg"] * 1.001},
                            want) > 1e-4
    assert plain.metric_gap({"hr": 1.0}, want) == math.inf


def test_judge_picks_reads_gaps_and_bad_picks():
    problem, _ = tiny_problem()
    rs = np.random.RandomState(2)
    v = torch.as_tensor(rs.randn(problem.n_items, 4))

    def scores_of(rows):
        return plain.dense_rows(problem, problem.test_users[rows], CPU) \
            @ v @ v.T

    scores = scores_of(np.arange(len(problem.test_users)))
    seen = plain.dense_rows(problem, problem.test_users, CPU) != 0
    best = torch.topk(scores.masked_fill(seen, -torch.inf), 5, dim=1)
    recs = best.indices.numpy()
    assert plain.judge_picks(problem, recs, scores_of, 5, CPU) == \
        {"pick_gap": 0.0, "bad_picks": 0.0}
    worse = recs.copy()
    unseen_worst = torch.topk(scores.masked_fill(seen, torch.inf), 1,
                              dim=1, largest=False).indices.numpy()
    worse[0, 0] = unseen_worst[0, 0]
    assert plain.judge_picks(problem, worse, scores_of, 5,
                             CPU)["pick_gap"] > 0.01
    seen_pick = recs.copy()
    seen_pick[1, 2] = int(problem.cols[problem.user_start[
        problem.test_users[1]]])
    assert plain.judge_picks(problem, seen_pick, scores_of, 5,
                             CPU)["bad_picks"] == 1
    repeated = recs.copy()
    repeated[2, 1] = repeated[2, 0]
    assert plain.judge_picks(problem, repeated, scores_of, 5,
                             CPU)["bad_picks"] == 1
    assert plain.judge_picks(problem, recs[:, :4], scores_of, 5,
                             CPU)["pick_gap"] == math.inf


def test_puresvd_reference_reads_exact_factors_as_exact():
    problem, _ = tiny_problem()
    ref = spec.reference("puresvd-ml10m")
    cfg = {"model": {"attributes": {"rank": 5}}}
    state = ref.prepare(problem, cfg, 0, CPU)
    dense = plain.dense_rows(problem, np.arange(problem.n_users), CPU)
    _, s, vt = torch.linalg.svd(dense, full_matrices=False)
    exact = {"movieid": vt[:5].T, "singular_values": s[:5]}
    checks = ref.factor_checks(state, exact)
    assert checks["svd_vec_resid"] < 1e-12
    assert checks["svd_energy_gap"] < 1e-12
    # neither the singular values nor the vectors' scale are judged
    scaled = {"movieid": 3 * vt[:5].T, "singular_values": 2 * s[:5]}
    assert ref.factor_checks(state, scaled)["svd_vec_resid"] < 1e-12
    off = {"movieid": vt[1:6].T, "singular_values": s[1:6]}
    assert ref.factor_checks(state, off)["svd_vec_resid"] < 1e-12
    assert ref.factor_checks(state, off)["svd_energy_gap"] > 1e-3
    bent = {"movieid": (vt[:5].T + 1e-3 * torch.randn(problem.n_items, 5,
                                                      dtype=torch.float64)),
            "singular_values": s[:5]}
    assert ref.factor_checks(state, bent)["svd_vec_resid"] > 1e-5
    panel = ref.user_panel(exact, problem, np.arange(3), CPU)
    assert torch.allclose(panel, dense[problem.test_users[:3]] @ vt[:5].T)


def loop_ials(problem, y, reg, epochs, alpha=1.0, eps=1.0):
    """Hu et al.'s solve entity by entity, in numpy."""
    r = np.zeros((problem.n_users, problem.n_items))
    r[problem.rows, problem.cols] = problem.vals
    c = np.where(r > 0, alpha * np.log2(r / eps + 1), 0.0)
    k = y.shape[1]
    for _ in range(epochs):
        x = np.stack([np.linalg.solve(
            y.T @ y + (y.T * c[u]) @ y + reg * np.eye(k),
            y.T @ ((c[u] + 1) * (r[u] > 0))) for u in range(len(r))])
        y = np.stack([np.linalg.solve(
            x.T @ x + (x.T * c[:, i]) @ x + reg * np.eye(k),
            x.T @ ((c[:, i] + 1) * (r[:, i] > 0)))
            for i in range(r.shape[1])])
    return x, y


def test_ials_reference_matches_a_loop():
    problem, _ = tiny_problem()
    ref = spec.reference("ials-ml10m")
    cfg = {"model": {"attributes": {"rank": 4},
                     "defaults": {"alpha": 1.0, "epsilon": 1.0,
                                  "regularization": 0.01, "num_epochs": 3}}}
    state = ref.prepare(problem, cfg, 123, CPU)
    y0 = ref.initial_items(problem.n_items, 4, 123, CPU).double().numpy()
    x, y = loop_ials(problem, y0, 0.01, 3)
    assert np.allclose(state["users"].numpy(), x, rtol=1e-9, atol=1e-11)
    assert np.allclose(state["items"].numpy(), y, rtol=1e-9, atol=1e-11)
    checks = ref.factor_checks(state, {"userid": torch.as_tensor(x),
                                       "movieid": torch.as_tensor(y)})
    assert checks["als_gap"] < 1e-9
    assert ref.factor_checks(state, {"userid": torch.as_tensor(x) * 1.01,
                                     "movieid": torch.as_tensor(y)}
                             )["als_gap"] > 1e-3
    assert ref.factor_checks(state, {"movieid": torch.as_tensor(y)}
                             )["als_gap"] == math.inf
