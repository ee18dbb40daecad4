"""The port's parallel layers on four spawned gloo ranks: the model and
sequence mesh axes, ring and Ulysses attention (tests/test_parallel.py:
34-110), the tensor-parallel MLP (:113-126), the GPipe pipeline and MoE
dispatch (tests/test_parallel_pp_ep.py), and `use_mesh` serving.

Each layer is held against its one-rank counterpart in the port and
against the JAX package on the same seeded numpy inputs, at the reference
tests' tolerances. The ranks run tests/test_torch_parallel_jobs.py, which
imports no jax; the reference side runs on the CPU devices of
tests/conftest.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mmlspark_tpu.parallel import dense_attention as jax_dense  # noqa: E402
from mmlspark_tpu.parallel.moe import EXPERT_AXIS  # noqa: E402
from mmlspark_tpu.parallel.moe import init_moe as jax_init_moe  # noqa: E402
from mmlspark_tpu.parallel.moe import moe_ffn_sharded as jax_moe_sharded  # noqa: E402
from mmlspark_tpu_torch.nn.attention import dense_attention  # noqa: E402
from mmlspark_tpu_torch.parallel import RankPool  # noqa: E402
from mmlspark_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from mmlspark_tpu_torch.parallel.moe import MoEParams, moe_ffn_local  # noqa: E402
from mmlspark_tpu_torch.parallel.ring_attention import ring_attention_local  # noqa: E402

import test_torch_parallel_jobs as jobs  # noqa: E402

WORLD = 4
RTOL, ATOL = 2e-4, 2e-5          # tests/test_parallel.py:38


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(WORLD, backend="gloo", workdir=str(tmp_path_factory.mktemp("ranks")),
                 timeout_s=120, threads=1)
    yield p
    p.close()


def _assemble(results, key="out", axis=0):
    """The shards' blocks of `key` concatenated in shard order."""
    got = sorted((r for r in results if r is not None), key=lambda r: r["shard"])
    return np.concatenate([r[key] for r in got], axis=axis)


def qkv(b=2, t=64, h=4, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, t, h, d)).astype(np.float32) for _ in range(3))


def _dense_grads(q, k, v, causal):
    qt, kt, vt = (torch.as_tensor(a).requires_grad_(True) for a in (q, k, v))
    (dense_attention(qt, kt, vt, causal=causal) ** 2).sum().backward()
    return qt.grad.numpy(), kt.grad.numpy(), vt.grad.numpy()


class TestMeshAxes:
    @pytest.mark.parametrize("grid", [(2, 2, 1), (2, 1, 2), (1, 4, 1)],
                             ids=["data2_seq2", "data2_model2", "seq4"])
    def test_grid_lines_and_psums(self, pool, grid):
        n_data, n_seq, n_model = grid
        out = {r["rank"]: r for r in pool.run(jobs.axes, n_data, n_seq, n_model)}
        sizes = {"data": n_data, "seq": n_seq, "model": n_model}
        layout = np.arange(WORLD).reshape(n_data, n_seq, n_model)
        for rank, doc in out.items():
            want_shape = {k: v for k, v in sizes.items() if k != "seq" or n_seq > 1}
            assert doc["shape"] == want_shape
            at = np.argwhere(layout == rank)[0]
            for ax, name in enumerate(("data", "seq", "model")):
                idx = list(at)
                idx[ax] = slice(None)
                line = [int(r) for r in layout[tuple(idx)]]
                assert doc[name]["ranks"] == line, (rank, name)
                assert doc[name]["index"] == line.index(rank)
                assert doc[name]["psum"] == float(sum(line))

    def test_one_process_axes(self):
        from mmlspark_tpu_torch.parallel import make_mesh

        mesh = make_mesh()
        assert mesh.axis("data") is mesh and mesh.axis("seq").size == 1
        with pytest.raises(ValueError, match="needs 4 processes"):
            make_mesh(n_data=1, n_seq=4)


class TestRingAttention:
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("local_chunk", [None, 4])
    def test_matches_dense(self, pool, causal, local_chunk):
        q, k, v = qkv(seed=1 + causal)
        got = _assemble(pool.run(jobs.attention, "ring", q, k, v, causal, local_chunk, WORLD),
                        axis=1)
        port = dense_attention(*(torch.as_tensor(a) for a in (q, k, v)), causal=causal).numpy()
        ref = np.asarray(jax_dense(*(jnp.asarray(a) for a in (q, k, v)), causal=causal))
        np.testing.assert_allclose(got, port, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)

    def test_local_chunk_grads_match_dense(self, pool):
        # t 64 over 4 ranks, chunks of 4: the chunk loop really runs, and
        # k and v's gradients come back through the reverse ring
        q, k, v = qkv(seed=5)
        res = pool.run(jobs.attention, "ring", q, k, v, True, 4, WORLD, True)
        dq, dk, dv = (_assemble(res, key, axis=1) for key in ("dq", "dk", "dv"))
        for got, want in zip((dq, dk, dv), _dense_grads(q, k, v, True)):
            np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-5)
        gd = jax.grad(lambda q_: (jax_dense(q_, jnp.asarray(k), jnp.asarray(v),
                                            causal=True) ** 2).sum())(jnp.asarray(q))
        np.testing.assert_allclose(dq, np.asarray(gd), rtol=5e-4, atol=5e-5)

    def test_local_chunk_must_divide(self):
        q, k, v = (torch.as_tensor(a) for a in qkv(t=6))
        with pytest.raises(ValueError, match="local_chunk"):
            ring_attention_local(q, k, v, Mesh((0,)), local_chunk=4)


class TestUlysses:
    @pytest.mark.parametrize("causal,local_chunk", [(False, None), (True, None), (True, 8)])
    def test_matches_dense(self, pool, causal, local_chunk):
        q, k, v = qkv(t=32, h=8, seed=3)
        got = _assemble(pool.run(jobs.attention, "ulysses", q, k, v, causal, local_chunk,
                                 WORLD), axis=1)
        ref = np.asarray(jax_dense(*(jnp.asarray(a) for a in (q, k, v)), causal=causal))
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)

    def test_local_chunk_grads_match_dense(self, pool):
        q, k, v = qkv(t=32, h=8, seed=6)
        res = pool.run(jobs.attention, "ulysses", q, k, v, True, 8, WORLD, True)
        for key, want in zip(("dq", "dk", "dv"), _dense_grads(q, k, v, True)):
            np.testing.assert_allclose(_assemble(res, key, axis=1), want, rtol=5e-4, atol=5e-5)


class TestTensorParallel:
    @pytest.mark.parametrize("ring", [False, True])
    def test_tp_mlp_matches_local(self, pool, ring):
        rng = np.random.default_rng(0)
        x = rng.normal(size=(16, 32)).astype(np.float32)
        w1 = rng.normal(size=(32, 64)).astype(np.float32)
        b1 = rng.normal(size=(64,)).astype(np.float32)
        w2 = rng.normal(size=(64, 32)).astype(np.float32)
        b2 = rng.normal(size=(32,)).astype(np.float32)
        res = [r for r in pool.run(jobs.tp_mlp, x, w1, b1, w2, b2, WORLD, ring)]
        local = np.asarray((jax.nn.gelu(x @ w1 + b1) @ w2) + b2)
        for r in res:
            np.testing.assert_allclose(r["out"], local, rtol=2e-4, atol=2e-4)
            # every rank leaves with the full x @ w1 + b1, moved, never added
            np.testing.assert_allclose(r["gathered"], x @ w1 + b1, rtol=1e-5, atol=1e-5)
            assert r["gathered"].tobytes() == res[0]["gathered"].tobytes()


def _stage_np(w, b, x):
    return x + np.tanh(x @ w + b)


class TestPipelineParallel:
    @pytest.mark.parametrize("n_stages,n_micro", [(4, 1), (4, 4), (4, 8), (2, 2)])
    def test_matches_sequential(self, pool, n_stages, n_micro):
        rng = np.random.default_rng(n_micro)
        b, d = 16, 12
        ws = rng.normal(size=(n_stages, d, d)).astype(np.float32) * 0.3
        bs = rng.normal(size=(n_stages, d)).astype(np.float32) * 0.1
        x = rng.normal(size=(b, d)).astype(np.float32)
        want = x
        for i in range(n_stages):
            want = _stage_np(ws[i], bs[i], want)
        res = pool.run(jobs.pipeline, ws, bs, x, n_micro, n_stages)
        assert sum(r is not None for r in res) == n_stages
        for r in res:
            if r is not None:
                np.testing.assert_allclose(r["out"], want, rtol=2e-5, atol=1e-6)

    def test_batch_not_divisible_raises(self):
        from mmlspark_tpu_torch.parallel.pipeline_parallel import pipeline_forward

        mesh = Mesh((0,), axis_names=("pipe",))
        with pytest.raises(ValueError, match="not divisible"):
            pipeline_forward(jobs._stage_fn, (torch.zeros(1, 4, 4), torch.zeros(1, 4)),
                             torch.zeros(7, 4), n_micro=3, mesh=mesh)


def _ref_params(d, h, e, seed):
    p = jax_init_moe(jax.random.PRNGKey(seed), d, h, e)
    return {k: np.array(getattr(p, k)) for k in p._fields}, p


def _port_params(params: dict, dtype=torch.float32) -> MoEParams:
    return MoEParams(**{k: torch.tensor(v).to(dtype) for k, v in params.items()})


class TestExpertParallel:
    def test_sharded_equals_local_and_the_reference(self, pool):
        from jax.sharding import Mesh as JaxMesh
        from jax.sharding import PartitionSpec as P

        try:
            from jax import shard_map
        except ImportError:  # jax < 0.5: shard_map lives under experimental
            from jax.experimental.shard_map import shard_map

        d, h, e, t_local = 8, 16, 8, 16
        params, jp = _ref_params(d, h, e, 0)
        x = np.random.default_rng(1).normal(size=(WORLD * t_local, d)).astype(np.float32)
        cf = float(e)      # no token drops: every path must agree
        sharded = _assemble(pool.run(jobs.moe, params, x, cf, WORLD))
        local = moe_ffn_local(_port_params(params), torch.as_tensor(x), cf).numpy()
        np.testing.assert_allclose(sharded, local, rtol=1e-4, atol=1e-5)
        mesh = JaxMesh(np.asarray(jax.devices()[:WORLD]), (EXPERT_AXIS,))
        spec = type(jp)(w_gate=P(), w1=P(EXPERT_AXIS), b1=P(EXPERT_AXIS),
                        w2=P(EXPERT_AXIS), b2=P(EXPERT_AXIS))
        fn = jax.jit(shard_map(lambda p, xx: jax_moe_sharded(p, xx, capacity_factor=cf),
                               mesh=mesh, in_specs=(spec, P(EXPERT_AXIS)),
                               out_specs=P(EXPERT_AXIS)))
        ref = np.asarray(fn(jp, jnp.asarray(x)))
        np.testing.assert_allclose(sharded, ref, rtol=1e-4, atol=1e-5)

    def test_tight_capacity_drops_like_the_reference(self, pool):
        d, h, e, t_local = 8, 16, 8, 16
        params, _ = _ref_params(d, h, e, 4)
        x = np.random.default_rng(2).normal(size=(WORLD * t_local, d)).astype(np.float32)
        sharded = _assemble(pool.run(jobs.moe, params, x, 1.0, WORLD))
        assert sharded.shape == x.shape and np.isfinite(sharded).all()
        assert np.all(sharded == 0.0, axis=1).sum() >= 1       # some token dropped

    def test_sharded_gradients_match_local(self, pool):
        d, h, e, t_local = 4, 8, 4, 8
        params, _ = _ref_params(d, h, e, 2)
        x = np.random.default_rng(3).normal(size=(WORLD * t_local, d)).astype(np.float32)
        res = pool.run(jobs.moe, params, x, 4.0, WORLD, True)
        p = MoEParams(*(t.requires_grad_(True) for t in _port_params(params)))
        xt = torch.as_tensor(x).requires_grad_(True)
        (moe_ffn_local(p, xt, 4.0) ** 2).sum().backward()
        # the local fit's cap is 4 x 32 / 4 = 32 slots, the sharded one's
        # 4 x 8 / 4 = 8 a shard: no token drops in either
        for key, want in (("dw1", p.w1.grad), ("dw2", p.w2.grad), ("dx", xt.grad)):
            np.testing.assert_allclose(_assemble(res, key), want.numpy(), rtol=1e-4, atol=1e-5)
        for g in (p.w_gate.grad, p.w1.grad, p.b1.grad, p.w2.grad, p.b2.grad):
            assert torch.isfinite(g).all()
        assert float(p.w1.grad.abs().sum()) > 0

    def test_bf16_routing_ranks_exact_past_256(self):
        from mmlspark_tpu.parallel.moe import moe_ffn_local as jax_moe_local

        # the reference test's inputs (test_parallel_pp_ep.py:125-145: its
        # rng fixture, key 3): one expert sees > 256 tokens
        d, h, e, t = 4, 8, 2, 600
        params, jp = _ref_params(d, h, e, 3)
        params["w_gate"] = np.zeros_like(params["w_gate"])
        params["w_gate"][:, 0] = 1.0         # every token to expert 0
        xf = np.random.default_rng(42).normal(size=(t, d)).astype(np.float32)
        out32 = moe_ffn_local(_port_params(params), torch.as_tensor(xf), float(e)).numpy()
        out16 = moe_ffn_local(_port_params(params, torch.bfloat16),
                              torch.as_tensor(xf).bfloat16(), float(e)).float().numpy()
        # every token keeps ITS OWN expert output: a merged slot would give
        # O(1) errors and zero rows
        assert not np.any(np.all(out16 == 0.0, axis=1))
        np.testing.assert_allclose(out16, out32, rtol=0.15, atol=0.05)
        # and the JAX package's bf16 routing of the same tokens, to about an ulp
        jp16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                            jp._replace(w_gate=jnp.asarray(params["w_gate"])))
        ref16 = np.asarray(jax_moe_local(jp16, jnp.asarray(xf, jnp.bfloat16), float(e)),
                           np.float32)
        np.testing.assert_allclose(out16, ref16, rtol=2 ** -6, atol=2 ** -5)


class TestUseMeshServing:
    def test_two_ranks_serve_the_single_process_rows(self, pool):
        from mmlspark_tpu_torch.core.schema import Table
        from mmlspark_tpu_torch.nn.models import ModelBundle
        from mmlspark_tpu_torch.nn.runner import DeepModelTransformer

        bundle = ModelBundle.init("transformer", (16,), seed=0, vocab_size=50, d_model=32,
                                  num_heads=4, num_layers=2, d_ff=64, num_outputs=3,
                                  attention_impl="flash")
        x = np.random.default_rng(5).integers(0, 50, size=(21, 16)).astype(np.int32)
        fetch = {"logits": "logits", "p": "probability"}
        res = pool.run(jobs.serve, bundle.to_bytes(), x, fetch, 5, [0, 1])
        assert [r is None for r in res] == [False, False, True, True]
        want = DeepModelTransformer(input_col="x", fetch_dict=fetch, mini_batch_size=6,
                                    device="cpu").set_model(bundle).transform(Table({"x": x}))
        for r in res[:2]:
            assert r["launches"] == 0             # K2 counts card launches only
            for c in fetch:
                assert r["cols"][c].shape[0] == len(x)
                np.testing.assert_allclose(r["cols"][c], np.asarray(want[c]),
                                           rtol=1e-4, atol=1e-4)
        assert res[0]["cols"]["logits"].tobytes() == res[1]["cols"]["logits"].tobytes()
