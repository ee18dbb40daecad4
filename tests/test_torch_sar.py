"""The port's SAR (mmlspark_tpu_torch/recommendation/sar.py, indexer.py)
held against the JAX package's on the same seeded interactions.

tests/test_recommendation.py's SAR and indexer cases run in both packages:
affinity and similarity bit for bit (the co-occurrence product's 0/1 sums
are exact integers on any device), predictions and top-k ratings within
1e-6 of each row's largest, ids equal except between ratings that close.
Beside them: an exact-tie case for `lax.top_k`'s order (the lower index
first among equal values), blocked scoring equal to one block byte for
byte, and a SARModel saved by the JAX package, loaded and scored by the
port. Everything runs on the CPU (`device="cpu"`).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu.core.pipeline import PipelineStage as JaxStage  # noqa: E402
from mmlspark_tpu.core.schema import Table as JaxTable  # noqa: E402
from mmlspark_tpu.recommendation import SAR as JaxSAR  # noqa: E402
from mmlspark_tpu.recommendation import RecommendationIndexer as JaxIndexer  # noqa: E402
from mmlspark_tpu_torch.core.pipeline import PipelineStage  # noqa: E402
from mmlspark_tpu_torch.core.schema import Table  # noqa: E402
from mmlspark_tpu_torch.recommendation import SAR, RecommendationIndexer, SARModel  # noqa: E402
from mmlspark_tpu_torch.recommendation.sar import SCORE_ROWS, topk_desc  # noqa: E402

TOL = 1e-6


def interactions(n_users=20, n_items=15, seed=0) -> dict:
    """tests/test_recommendation.py's block-structured taste."""
    rng = np.random.default_rng(seed)
    rows = []
    for u in range(n_users):
        block = u % 3
        liked = [i for i in range(n_items) if i % 3 == block]
        for i in rng.choice(liked, size=4, replace=True):
            rows.append((u, int(i), 1.0))
        rows.append((u, int(rng.integers(n_items)), 1.0))
    arr = np.asarray(rows, np.float64)
    return {"user": arr[:, 0], "item": arr[:, 1], "rating": arr[:, 2]}


def movielens_like(n_users=300, n_items=120, seed=3) -> dict:
    """Zipf-like popularity, ratings 1-5, timestamps over three years."""
    rng = np.random.default_rng(seed)
    pop = 1.0 / np.arange(1, n_items + 1) ** 0.9
    pop /= pop.sum()
    users, items = [], []
    for u in range(n_users):
        n = int(rng.integers(20, 40))
        users.append(np.full(n, u))
        items.append(rng.choice(n_items, size=n, replace=False, p=pop))
    u = np.concatenate(users).astype(np.float64)
    it = np.concatenate(items).astype(np.float64)
    return {"user": u, "item": it,
            "rating": rng.integers(1, 6, size=len(u)).astype(np.float64),
            "time": rng.uniform(0.0, 3 * 365 * 86400.0, size=len(u))}


def fit_both(cols: dict, **params):
    jm = JaxSAR(**params).fit(JaxTable(dict(cols)))
    pm = SAR(device="cpu", **params).fit(Table(dict(cols)))
    return jm, pm


def assert_same_model(jm, pm):
    np.testing.assert_array_equal(pm.user_affinity, jm.user_affinity)
    np.testing.assert_array_equal(pm.item_similarity, jm.item_similarity)
    np.testing.assert_array_equal(pm.seen, jm.seen)


def assert_same_recs(jrecs, precs):
    """Ratings within TOL of each row's largest; ids equal wherever the
    rating is clear of the row's other ratings by more than that."""
    jr, pr = np.asarray(jrecs["ratings"]), np.asarray(precs["ratings"])
    ji, pi = np.asarray(jrecs["recommendations"]), np.asarray(precs["recommendations"])
    assert jr.shape == pr.shape and ji.dtype == pi.dtype == np.int64
    scale = np.maximum(np.abs(jr).max(axis=1, keepdims=True), 1.0)
    assert np.all(np.abs(jr - pr) <= TOL * scale)
    gap = np.abs(jr[:, :, None] - jr[:, None, :]) + np.eye(jr.shape[1])[None] * 1e9
    clear = gap.min(axis=2) > TOL * scale
    np.testing.assert_array_equal(pi[clear], ji[clear])
    np.testing.assert_array_equal(np.asarray(precs["user"]), np.asarray(jrecs["user"]))


class TestIndexer:
    def test_roundtrip_matches_the_jax_package(self):
        cols = {"customer": ["bob", "amy", "bob", "cat"], "product": ["x", "y", "x", "z"]}
        kw = dict(user_input_col="customer", user_output_col="user",
                  item_input_col="product", item_output_col="item")
        jm = JaxIndexer(**kw).fit(JaxTable(dict(cols)))
        pm = RecommendationIndexer(**kw).fit(Table(dict(cols)))
        for c in ("user", "item"):
            np.testing.assert_array_equal(np.asarray(pm.transform(Table(dict(cols)))[c]),
                                          np.asarray(jm.transform(JaxTable(dict(cols)))[c]))
        assert pm.recover_user(1) == jm.recover_user(1) == "bob"
        assert pm.inverse_transform_items([[0, 2]]) == [["x", "z"]]
        assert (pm.n_users, pm.n_items) == (jm.n_users, jm.n_items)


CASES = {
    "block_jaccard": (interactions, dict(support_threshold=1)),
    "block_lift": (interactions, dict(support_threshold=1, similarity_function="lift")),
    "block_cooccurrence": (interactions, dict(support_threshold=1,
                                              similarity_function="cooccurrence")),
    "movielens_decay": (movielens_like, dict(rating_col="rating", time_col="time")),
    "movielens_lift_support3": (movielens_like, dict(rating_col="rating", time_col="time",
                                                     similarity_function="lift",
                                                     support_threshold=3)),
    "movielens_cooccur_start_time": (movielens_like, dict(
        rating_col="rating", time_col="time", similarity_function="cooccurrence",
        start_time="1973-01-01 00:00:00", time_decay_coeff=90)),
}


class TestSAR:
    @pytest.mark.parametrize("case", sorted(CASES))
    def test_fit_and_recommend_match_the_jax_package(self, case):
        data, params = CASES[case]
        cols = data()
        jm, pm = fit_both(cols, **params)
        assert_same_model(jm, pm)
        for remove_seen in (True, False):
            assert_same_recs(jm.recommend_for_all_users(k=7, remove_seen=remove_seen),
                             pm.recommend_for_all_users(k=7, remove_seen=remove_seen))
        jp = np.asarray(jm.transform(JaxTable(dict(cols)))["prediction"])
        pp = np.asarray(pm.transform(Table(dict(cols)))["prediction"])
        assert np.all(np.abs(pp - jp) <= TOL * max(np.abs(jp).max(), 1.0))

    def test_blocked_scoring_equals_one_block(self):
        _, pm = fit_both(movielens_like(), rating_col="rating", time_col="time")
        whole = pm.recommend_for_all_users(k=10, user_block=10_000)
        for block in (1, 37, SCORE_ROWS, 4096):
            part = pm.recommend_for_all_users(k=10, user_block=block)
            for c in ("recommendations", "ratings"):
                np.testing.assert_array_equal(np.asarray(part[c]), np.asarray(whole[c]))

    def test_remove_seen_marks_exhausted_slots(self):
        arr = np.asarray([(0, i) for i in range(4)] + [(1, 4)], np.float64)
        cols = {"user": arr[:, 0], "item": arr[:, 1]}
        jm, pm = fit_both(cols, support_threshold=1)
        recs = pm.recommend_for_all_users(k=3, remove_seen=True)
        row0 = list(map(int, np.asarray(recs["recommendations"])[0]))
        assert row0.count(-1) == 2 and 4 in row0
        assert_same_recs(jm.recommend_for_all_users(k=3), recs)

    def test_explicit_vocab_and_indexer_wiring(self):
        arr = np.asarray([(0, i) for i in range(4)] + [(1, 0)], np.float64)
        cols = {"user": arr[:, 0], "item": arr[:, 1]}
        jm, pm = fit_both(cols, support_threshold=1, num_items=5, num_users=2)
        assert pm.item_similarity.shape == (5, 5)
        recs = pm.recommend_for_all_users(k=3, remove_seen=True)
        assert 4 in list(map(int, np.asarray(recs["recommendations"])[0]))
        assert_same_recs(jm.recommend_for_all_users(k=3), recs)
        t = Table({"customer": ["bob", "amy", "bob"], "product": ["x", "y", "x"]})
        idx = RecommendationIndexer(user_input_col="customer", user_output_col="user",
                                    item_input_col="product", item_output_col="item").fit(t)
        model = SAR(support_threshold=1, device="cpu").set_indexer_model(idx).fit(
            idx.transform(t))
        assert model.user_affinity.shape == (idx.n_users, idx.n_items)

    def test_vocab_too_small_raises(self):
        t = Table({"user": np.asarray([0.0, 1.0]), "item": np.asarray([0.0, 7.0])})
        with pytest.raises(ValueError, match="exceed declared vocab"):
            SAR(num_items=3, device="cpu").fit(t)

    def test_time_decay_prefers_recent(self):
        rows = [(0, 1, 0.0), (0, 1, 0.0), (0, 2, 100_000_000.0),
                (1, 1, 0.0), (1, 2, 100_000_000.0)]
        arr = np.asarray(rows, np.float64)
        cols = {"user": arr[:, 0], "item": arr[:, 1], "time": arr[:, 2]}
        jm, pm = fit_both(cols, time_col="time", time_decay_coeff=30, support_threshold=1)
        assert pm.user_affinity[0, 2] > pm.user_affinity[0, 1]
        assert_same_model(jm, pm)

    def test_cuda_without_a_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="cuda"):
            SAR(support_threshold=1).fit(Table(interactions()))


class TestTopKTies:
    def test_topk_desc_is_lax_top_k_on_exact_ties(self):
        import jax

        rng = np.random.default_rng(8)
        scores = rng.choice(np.asarray([0.0, 0.5, 1.0, -np.inf], np.float32), size=(64, 40))
        scores[:, ::7] = 0.0
        jv, ji = jax.lax.top_k(scores, 12)
        pv, pi = topk_desc(torch.as_tensor(scores), 12)
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))

    def test_recommendations_on_tied_scores_follow_the_lower_index(self):
        # users who saw one item each, no co-occurrence: every unseen score
        # is exactly 0.0, so lax.top_k's rule alone fixes the order
        arr = np.asarray([(u, u % 6) for u in range(12)], np.float64)
        cols = {"user": arr[:, 0], "item": arr[:, 1]}
        jm, pm = fit_both(cols, support_threshold=1, num_items=9)
        jr = jm.recommend_for_all_users(k=5)
        pr = pm.recommend_for_all_users(k=5)
        for c in ("recommendations", "ratings"):
            np.testing.assert_array_equal(np.asarray(pr[c]), np.asarray(jr[c]))
        assert list(np.asarray(pr["recommendations"])[0]) == [1, 2, 3, 4, 5]


class TestPersistence:
    def test_a_model_saved_by_the_jax_package_loads_and_recommends_alike(self, tmp_path):
        cols = movielens_like(n_users=120, n_items=60)
        jm = JaxSAR(rating_col="rating", time_col="time", support_threshold=2).fit(
            JaxTable(dict(cols)))
        jm.save(str(tmp_path / "sar"))
        pm = PipelineStage.load(str(tmp_path / "sar"))
        assert isinstance(pm, SARModel)
        pm.to("cpu")
        assert_same_model(jm, pm)
        assert_same_recs(jm.recommend_for_all_users(k=10), pm.recommend_for_all_users(k=10))

    def test_a_model_saved_by_the_port_loads_in_the_jax_package(self, tmp_path):
        cols = interactions()
        pm = SAR(support_threshold=1, device="cpu").fit(Table(dict(cols)))
        pm.save(str(tmp_path / "sar"))
        jm = JaxStage.load(str(tmp_path / "sar"))
        assert_same_model(jm, pm)
        back = PipelineStage.load(str(tmp_path / "sar")).to("cpu")
        for c in ("recommendations", "ratings"):
            np.testing.assert_array_equal(
                np.asarray(back.recommend_for_all_users(k=5)[c]),
                np.asarray(pm.recommend_for_all_users(k=5)[c]))
