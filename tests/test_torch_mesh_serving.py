"""Parity of the port's sharded serving engines (``GenerationEngine``,
``InferenceEngine`` and ``CausalLMAdapter`` under ``mesh=``) on the CPU.

The port runs in one spawned gloo world of 8 ranks
(``tests/torch_dist_worker.py``'s ``serving`` suite: a ``file://`` store
under ``tmp_path``, one CPU thread a rank, no ``jax``); a mesh smaller
than 8 takes the first ranks, whose first is the engine's driver. The
world starts when the module's first test asks for it and runs while the
JAX side computes. Every case uses the reference tests' configuration
(``tests/test_generation.py``'s ``CFG``: vocab 50, hidden 32, 2 layers, 2
heads, fp32) with the same seeded numpy weights on both sides.

- On the reference tests' meshes, against the JAX engine on the
  conftest's 8 virtual CPU devices: the contiguous cache, the paged
  gather route and the fused route with fp32 and int8 pools at
  ``{data: 4, model: 2}``, greedy and sampled; the fused route's refusal
  at ``{data: 1, model: 8}``.
- Port-only cases at ``{model: 2}``, against the port's meshless engine
  in this process: a shared prefix with copy-on-write, on-demand
  preemption with swap, speculation at k=2, page export and import, the
  batching engine through ``CausalLMAdapter(mesh=)`` (and the registry's
  ladder on ``{data: 8}``), a follower's ``submit``, and a follower killed
  mid-decode (the suite's last case; its rank exits by SIGKILL).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import bert as jbert
from deeplearning4j_tpu.parallel.mesh import make_mesh as jax_make_mesh
from deeplearning4j_tpu.serving import GenerationEngine as JaxEngine
from deeplearning4j_tpu_torch.models import bert as tbert
from deeplearning4j_tpu_torch.serving import GenerationEngine

import torch_dist_worker as W
from torch_threads import one_torch_thread  # noqa: F401,E402

TIMEOUT = 300.0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = W.World("serving", 8, tmp_path_factory.mktemp("torch_mesh_serving"),
                TIMEOUT, killed=(1,))
    yield w
    w.close()


JCFG = jbert.TransformerConfig(dtype=jnp.float32, causal=True,
                               attention_impl="full", remat=False,
                               **W.SERVE)


def _port(cfg=None, params=None, **kw):
    """The port's meshless engine on the cases' weights."""
    return GenerationEngine(tbert.params_from_numpy(
        W.serve_params() if params is None else params, device="cpu"),
        W.serve_cfg() if cfg is None else cfg, device="cpu", **kw)


CASES = [pytest.param(s, kw, id=cid) for cid, s, kw in W.SERVE_CASES]


@pytest.mark.parametrize("shape,kw", CASES)
def test_mesh_streams_match_jax_on_same_mesh(world, shape, kw):
    """Greedy and sampled (``temperature=0.8, top_k=5, seed=3``) streams
    of the port's engine on the mesh equal the JAX engine's on the same
    mesh: heads over 'model' on every route and pool, 'data' replicated."""
    cid = next(c for c, s, k in W.SERVE_CASES if (s, k) == (shape, kw))
    params = jax.tree_util.tree_map(jnp.asarray, W.serve_params())
    p = W.serve_prompt(6, seed=21)
    with JaxEngine(params, JCFG, mesh=jax_make_mesh(dict(shape)), slots=2,
                   max_len=32, **kw) as eng:
        want = {"greedy": eng.generate(p, max_new_tokens=6, timeout=300),
                "sampled": eng.generate(p, max_new_tokens=6, timeout=300,
                                        **W.SAMPLED)}
    got = world.case(cid)
    assert got["greedy"] == want["greedy"]
    assert got["sampled"] == want["sampled"]
    assert got["plans"] > 12   # the pool, then every prefill and step


def test_fused_refusal_names_heads_like_jax(world):
    """``paged_attention='fused'`` with 2 heads over an 8-way 'model'
    axis raises ``ValueError`` naming the heads, as the reference does."""
    with pytest.raises(ValueError, match="heads"):
        jbert.make_paged_decode_step(
            JCFG, 8, mesh=jax_make_mesh({"data": 1, "model": 8}),
            paged_attention="fused")
    got = world.case("fused-refusal")["raised"]
    assert got is not None and "heads" in got


def test_shared_prefix_with_copy_on_write_equals_meshless(world):
    with _port(W.serve_cfg("flash"), slots=4, max_len=32,
               block_size=8) as eng:
        pid = eng.register_prefix(W.serve_prompt(10, seed=40))
        hs = [eng.submit(W.serve_prompt(3, seed=60 + i), prefix_id=pid,
                         max_new_tokens=5, **(W.SAMPLED if i else {}))
              for i in range(3)]
        want = [h.result(timeout=120) for h in hs]
        cow = int(eng.metrics.kv_cow_copies_total.value)
    got = world.case("prefix-cow")
    assert got["streams"] == want
    assert got["cow"] == cow == 3


def test_preemption_with_swap_equals_meshless(world):
    """A 5-block on-demand pool preempts one of two streams; each rank
    parks its own heads of the victim's blocks and writes them back."""
    with _port(W.serve_cfg("flash"), **W.TIGHT) as eng:
        hs = [eng.submit(W.serve_prompt(4, s), max_new_tokens=20,
                         eos_id=None, seed=s) for s in (0, 1)]
        want = [h.result(timeout=120) for h in hs]
    got = world.case("preempt-swap")
    assert got["streams"] == want
    assert got["preemptions"] >= 1 and got["swapped"] >= 1
    assert got["swap_ins"] >= 1


def test_speculative_streams_equal_meshless_plain(world):
    """Speculation at k=2 (a 1-layer draft, also over 'model') on the
    fused route gives the plain meshless engine's streams, in fewer
    steps than tokens."""
    with _port(W.serve_cfg("flash"), slots=2, max_len=32, block_size=8,
               paged_attention="fused") as eng:
        ps = [W.serve_prompt(5, seed=70), W.serve_prompt(9, seed=71)]
        want = [eng.generate(ps[0], max_new_tokens=8, timeout=120),
                eng.generate(ps[1], max_new_tokens=8, timeout=120,
                             **W.SAMPLED)]
    got = world.case("speculative")
    assert got["streams"] == want
    assert got["verify_steps"] < 16


def test_page_export_and_import_equal_meshless(world):
    """A mesh engine's exported pages hold every head (gathered over
    'model'): within 1e-6 of the meshless engine's (fp32; the sharded
    sums reassociate); a mesh engine that imports them resumes the stream
    as the meshless one does."""
    p = W.serve_prompt(11, seed=80)
    with _port(W.serve_cfg("flash"), slots=2, max_len=32,
               block_size=8) as eng:
        h = eng.submit(p, max_new_tokens=1, capture_pages=True)
        first = h.result(timeout=120)
        entry = eng.take_captured_pages(h)
    with _port(W.serve_cfg("flash"), slots=2, max_len=32,
               block_size=8) as eng:
        key = eng.import_pages(entry)
        resumed = eng.submit(p, max_new_tokens=6, swap_key=key,
                             resume_tokens=first,
                             resume_step=1).result(timeout=120)
    got = world.case("migrate")
    assert got["first"] == first
    assert len(got["pages"]) == len(entry.payload)
    for mine, want in zip(got["pages"], entry.payload):
        assert set(mine) == set(want)
        for name in want:
            assert mine[name].shape == tuple(want[name].shape)
            np.testing.assert_allclose(mine[name], want[name].numpy(),
                                       atol=1e-6)
    assert got["resumed"] == resumed and got["swap_ins"] == 1


def test_inference_engine_batches_equal_direct_mesh_calls(world):
    """``InferenceEngine`` over ``CausalLMAdapter(mesh=)`` at {model: 2}
    through a registry deployment: each request's rows are bit for bit
    the mesh's direct call on the padded bucket batch, and within 1e-5
    of the meshless logits."""
    got = world.case("inference")
    params = tbert.params_from_numpy(W.serve_params(), device="cpu")
    fwd = tbert.make_infer_last_logits(W.serve_cfg("flash"))
    for x, out, direct in zip(got["xs"], got["outs"], got["direct"]):
        assert out.shape == (len(x), 50) and out.dtype == np.float32
        assert np.array_equal(out, direct)
        want = fwd(params, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(out, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_registry_realigns_default_ladder_to_data_axis(world):
    """The reference's ``test_default_buckets_realign_to_mesh`` on the
    port: the registry's (1, 2, 4, ...) ladder on an 8-way 'data' mesh
    gives way to multiples of 8 covering 32, and a 3-row request comes
    back as 3 rows of the meshless logits."""
    got = world.case("inference")
    assert all(b % 8 == 0 for b in got["d8_buckets"])
    assert got["d8_buckets"][-1] >= 32
    params = tbert.params_from_numpy(W.serve_params(), device="cpu")
    want = tbert.make_infer_last_logits(W.serve_cfg("flash"))(
        params, torch.ones((3, 6), dtype=torch.int32)).numpy()
    assert got["d8_out"].shape == (3, 50)
    np.testing.assert_allclose(got["d8_out"], want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_follower_submit_names_the_driver(world):
    got = world.case("follower-submit")
    assert "rank 0" in got["follower"] and "driver" in got["follower"]
    with _port(slots=2, max_len=32, block_size=8) as eng:
        want = eng.generate(W.serve_prompt(4), max_new_tokens=2,
                            timeout=120)
    assert got["driver_stream"] == want


def test_lost_follower_fails_the_stream_typed_without_hanging(world):
    """Rank 1 dies (SIGKILL) after its third decode plan: the driver's
    next collective or plan raises, the stream fails with
    ``MeshBrokenError`` within a minute (the plan group's timeout is ten:
    a dead process closes its sockets), the engine stops, and later
    submits are rejected."""
    got = world.case("lost-rank")
    assert got["raised"] is not None
    assert got["raised"][0] == "MeshBrokenError"
    assert got["seconds"] < 60.0
    assert W.KILL_AFTER <= got["tokens"] < 40
    assert got["stopped"] and got["after"] == "RejectedError"


def test_world_imports_no_jax(world):
    assert world.results()["_jax_imported"] == []


def test_uneven_heads_are_refused_by_every_sharded_factory():
    """A model whose heads do not split over 'model' is refused by the
    sharded factories and caches, the draft's too (a mesh of three
    ranks, built without a process group: no collective runs)."""
    from deeplearning4j_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(np.arange(3), ("model",))
    dcfg = tbert.TransformerConfig(dtype=torch.float32, causal=True,
                                   **W.DRAFT)
    for make in (lambda: tbert.make_draft_step(dcfg, mesh),
                 lambda: tbert.make_draft_prefill(dcfg, mesh),
                 lambda: tbert.init_draft_kv_cache(dcfg, 2, 16, device="cpu",
                                                   mesh=mesh),
                 lambda: tbert.make_paged_prefill(dcfg, 8, mesh),
                 lambda: tbert.make_verify_step(dcfg, 8, 2, mesh),
                 lambda: tbert.init_kv_cache(dcfg, 2, 16, block_size=8,
                                             device="cpu", mesh=mesh)):
        with pytest.raises(ValueError, match="heads"):
            make()


# 50 tokens split over 2 ranks evenly and over 4 after padding to 52
VIRTUAL = dict(vocab_size=50, hidden=32, layers=2, heads=4, mlp_dim=64,
               max_seq=32)


@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("ranks", [2, 4])
def test_virtual_rank_loop_matches_unsharded_steps(ranks, kv):
    """The per-rank bodies of the paged prefill and the fused decode step
    (each rank its ``place_params`` shards and its heads of the pool)
    driven for ``ranks`` virtual 'model' ranks in one process
    (``drive_ranks``, the partial sums in rank order): the prefill's
    tokens equal the unsharded step's, the decode logits within 1e-5 of
    the largest |logit| (fp32; the sums reassociate), and each rank's
    pool holds its heads of the unsharded pool's values (int8 values
    within one quantization step). Over 4 ranks the vocabulary is padded
    to split evenly, and the logits come back cut to it."""
    from deeplearning4j_tpu_torch.parallel.mesh import Mesh

    cfg = tbert.TransformerConfig(dtype=torch.float32, causal=True,
                                  attention_impl="flash", remat=False,
                                  **VIRTUAL)
    params = tbert.params_from_numpy(W.np_params(VIRTUAL, 4), device="cpu")
    meshes = [None] + [Mesh(np.arange(ranks), ("model",), rank=r)
                       for r in range(ranks)]
    ps = [params if m is None else tbert.place_params(params, cfg, m)
          for m in meshes]
    assert {p["tok_emb"].shape[0] * ranks for p in ps[1:]} == {
        -(-50 // ranks) * ranks}
    caches = [tbert.init_kv_cache(cfg, 4, 32, block_size=8, kv_dtype=kv,
                                  device="cpu", mesh=m) for m in meshes]
    pre = [tbert.make_paged_prefill(cfg, 8, m, kv_dtype=kv) for m in meshes]
    dec = [tbert.make_paged_decode_logits(cfg, 8, m, kv_dtype=kv,
                                          paged_attention="fused")
           for m in meshes]

    def both(steps, *args):
        whole = steps[0](ps[0], caches[0], *args)
        with torch.no_grad():
            parts = tbert.drive_ranks([f.body(p, c, *args) for f, p, c in
                                       zip(steps[1:], ps[1:], caches[1:])])
        return whole, parts

    tables = np.zeros((4, 4), np.int32)
    lengths = np.zeros(4, np.int64)
    tokens = np.zeros(4, np.int64)
    rng = np.random.default_rng(9)
    for i, n in enumerate((5, 12)):
        tables[i, :2] = (2 * i + 1, 2 * i + 2)
        padded = np.zeros((1, 16), np.int32)
        padded[0, :n] = rng.integers(0, 50, n)
        row = np.zeros(2, np.int32)
        row[:-(-n // 8)] = tables[i, :-(-n // 8)]
        (_, t), parts = both(pre, padded, row, n, np.array([3, i], np.uint32),
                             0.8, 5, 0)
        assert all(int(r[1]) == int(t) for r in parts)
        tokens[i], lengths[i] = int(t), n
    zero = np.zeros(4, np.int64)
    whole, parts = both(dec, tables, lengths, tokens, zero, zero)
    lim = 1e-5 * float(whole.abs().max())
    for got in parts:
        assert got.shape == whole.shape
        assert float((got - whole).abs().max()) <= lim
    h = cfg.heads // ranks
    for r, c in enumerate(caches[1:]):
        for lw, lr in zip(caches[0]["layers"], c["layers"]):
            assert lr["k"].shape[2] == h
            for name in lw:
                a = lw[name][:, :, r * h:(r + 1) * h].float()
                b = lr[name].float()
                tol = 1.0 if lw[name].dtype == torch.int8 else 1e-5
                assert float((a - b).abs().max()) <= tol, name


def test_generation_engine_refuses_a_context_axis():
    """Serving shards heads over 'model' and replicates 'data'; a mesh
    that splits 'context' is refused before anything is built."""
    from deeplearning4j_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(np.arange(2).reshape(1, 2), ("model", "context"))
    with pytest.raises(ValueError, match="context"):
        _port(mesh=mesh, slots=2, max_len=32)
