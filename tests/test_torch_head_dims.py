"""Head dims, the paged kernel's split plan and the fused AdamW's leaf table
of the PyTorch port (deeplearning4j_tpu_torch), on the CPU.

- The attention kernels take every head dim from 1 up, as the JAX
  package's packed route does (it asserts only that the packed width
  divides by the heads): widths past 256 (the card's chunked kernels) too,
  against its packed kernel, forward and backward at 320, and paged decode
  at 1280 against its paged kernel, all in interpret mode; only a head
  dim below 1 refuses. The port's flash route at the reference's TINY
  widths (head dim 8) and at head dim 48 gives the JAX package's loss and
  gradients.
- The paged kernel's split plan is a pure function of the table's width
  and the block size.
- ``fused_adamw``'s leaf table rebuilds when the tree or a leaf changes,
  and only then (its host logic runs on CPU tensors).

The kernels themselves are held against these plain versions on the card
by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import bert as jbert
from deeplearning4j_tpu.ops.pallas_kernels import (
    _mha_packed_forward, mha_attention_packed as jax_mha_packed,
    paged_decode_attention as jax_paged_decode)
from deeplearning4j_tpu_torch.models import bert as tbert
from deeplearning4j_tpu_torch.ops import attention_kernels as ak
from deeplearning4j_tpu_torch.ops import pallas_updaters as updaters


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The torch side of these tests is small; one intra-op thread keeps it
    from competing for every core with the other test workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------- head dims


@pytest.mark.parametrize("d", [1, 8, 16, 24, 48, 64, 96, 100, 128, 160,
                               256, 257, 264, 512])
def test_predicate_takes_what_the_reference_packed_route_takes(d):
    """Every head dim the reference's packed forward runs, the port's
    kernels take (past 256 in 256-wide chunks on the card, within one
    CTA's shared memory); its result there is the port's plain
    version's."""
    heads = 2
    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal((1, 8, heads * d)).astype(np.float32)
               for _ in range(3))
    ref_o, ref_lse = _mha_packed_forward(
        *(jnp.asarray(x, jnp.float32) for x in (q, k, v)), heads,
        causal=True, scale=None, interpret=True, p_dtype=jnp.float32)
    assert ak.kernel_head_dim_ok(d)
    o, lse = ak.mha_packed_forward(*(torch.from_numpy(x) for x in (q, k, v)),
                                   heads, True)
    # fp32 both sides, summation order aside
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("d", [0, -1, -64])
def test_predicate_refuses_past_the_limit(d):
    """Only a head dim below 1 refuses, at the default scale as at a given
    one; the error names the bound."""
    assert not ak.kernel_head_dim_ok(d)
    for scale in (None, 1.0):
        with pytest.raises(ValueError, match="head_dim >= 1"):
            ak._scale("mha_packed_fwd", d, scale)


def _zero_width_calls():
    q, lse = torch.zeros(1, 8, 0), torch.zeros(1, 2, 8)
    q3, vec = torch.zeros(2, 8, 0), torch.zeros(2, 1, 8)
    pool = torch.zeros(3, 4, 1, 0)
    tables = torch.zeros(2, 1, dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    return {
        "mha_packed_forward": lambda: ak.mha_packed_forward(q, q, q, 2),
        "mha_packed_backward": lambda: ak.mha_packed_backward(
            q, q, q, q, lse, 2),
        "mha_attention_packed": lambda: ak.mha_attention_packed(q, q, q, 2),
        "flash_forward": lambda: ak.flash_forward(q3, q3, q3),
        "flash_bwd_dq": lambda: ak.flash_bwd_dq(q3, q3, q3, q3, vec, vec),
        "flash_bwd_dkv": lambda: ak.flash_bwd_dkv(q3, q3, q3, q3, vec, vec),
        "flash_attention": lambda: ak.flash_attention(q3, q3, q3),
        "paged_decode_attention": lambda: ak.paged_decode_attention(
            torch.zeros(2, 1, 0), pool, pool, tables, pos, block_size=4),
    }


@pytest.mark.parametrize("name", sorted(_zero_width_calls()))
def test_wrapper_refuses_zero_width_head_at_default_scale(name):
    """Every attention wrapper called without a scale refuses a zero-width
    head with the bound named, before it takes 1/sqrt(d)."""
    with pytest.raises(ValueError, match="head_dim >= 1"):
        _zero_width_calls()[name]()


def _packed_vjp_inputs(seed, t, heads, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, t, heads * d)).astype(np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("d", [8, 48, 320])
@pytest.mark.parametrize("causal", [True, False])
def test_packed_forward_and_backward_at_head_dim(d, causal):
    """The packed forward and backward at head dims the padded kernels run
    (8, 48) and one the chunked kernels run (320), against the JAX
    package's custom-VJP kernel."""
    heads = 4 if d == 8 else 2
    q, k, v, g = _packed_vjp_inputs(60 + d, 24, heads, d)

    def f(q_, k_, v_):
        return jax_mha_packed(q_, k_, v_, heads, causal, None, True,
                              jnp.float32)
    ref_o, vjp = jax.vjp(f, *(jnp.asarray(x, jnp.float32)
                              for x in (q, k, v)))
    ref = vjp(jnp.asarray(g, jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = ak.mha_attention_packed(tq, tk, tv, heads, causal)
    grads = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(g))
    # fp32 both sides; the gradients sum T products of O(1) terms in
    # another order: 2e-5
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(ref_o),
                               rtol=1e-5, atol=1e-5)
    for name, a, b in zip("qkv", grads, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=2e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_paged_decode_wide_head_matches_jax(quantized):
    """Paged decode at head dim 1280 (two 1024-wide chunks on the card)
    against the JAX package's paged kernel in interpret mode: two splits'
    worth of positions, a dead slot on the scratch block."""
    from deeplearning4j_tpu_torch.models import quantize_kv
    rng = np.random.default_rng(1280)
    S, H, D, B, nbmax = 3, 1, 1280, 16, 6
    NB = S * nbmax + 1
    q = rng.standard_normal((S, H, D)).astype(np.float32)
    kf = rng.standard_normal((NB, B, H, D)).astype(np.float32)
    vf = rng.standard_normal((NB, B, H, D)).astype(np.float32)
    tables = np.zeros((S, nbmax), np.int32)
    tables[0] = np.arange(1, 1 + nbmax)
    tables[1, :3] = [9, 11, 13]
    pos = np.array([nbmax * B - 1, 40, 0], np.int32)   # slot 2: dead
    scales = {}
    if quantized:
        kq, ks = quantize_kv(torch.from_numpy(kf))
        vq, vs = quantize_kv(torch.from_numpy(vf))
        kp, vp = kq.numpy(), vq.numpy()
        scales = dict(k_scale=ks.numpy(), v_scale=vs.numpy())
    else:
        kp, vp = kf, vf
    ref = jax_paged_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(pos), block_size=B,
        interpret=True, **{n: jnp.asarray(a) for n, a in scales.items()})
    got = ak.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(pos), block_size=B,
        **{n: torch.from_numpy(a) for n, a in scales.items()})
    # fp32 both sides; the softmax sums in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# tests/test_models.py's TINY (head dim 32 / 4 = 8), and a head dim of 48
TINY = dict(vocab_size=64, hidden=32, layers=2, heads=4, mlp_dim=64,
            max_seq=32)
WIDE = dict(TINY, hidden=96, heads=2)


@pytest.mark.parametrize("widths", [TINY, WIDE], ids=["d8", "d48"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_loss_and_grads_match_jax(widths, causal):
    """``attention_impl="flash"`` end to end: loss and every gradient."""
    jcfg = jbert.TransformerConfig(dtype=jnp.float32, causal=causal,
                                   remat=False, attention_impl="flash",
                                   **widths)
    tcfg = tbert.TransformerConfig(dtype=torch.float32, causal=causal,
                                   remat=False, attention_impl="flash",
                                   **widths)
    assert tcfg.head_dim == widths["hidden"] // widths["heads"]
    np_params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        jbert.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, 64, (4, 16)).astype(np.int32),
             "targets": rng.integers(0, 64, (4, 16)).astype(np.int32),
             "weights": (rng.random((4, 16)) > 0.3).astype(np.float32)}
    jloss, jgrads = jax.value_and_grad(jbert.lm_loss)(
        jax.tree_util.tree_map(jnp.asarray, np_params),
        {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    tp = tbert.params_from_numpy(np_params, device="cpu")
    leaves = [x.requires_grad_() for x in tbert._leaves(tp)]
    tloss = tbert.lm_loss(tp, {k: torch.from_numpy(v)
                               for k, v in batch.items()}, tcfg)
    tgrads = torch.autograd.grad(tloss, leaves)
    # fp32 both sides (the packed kernel's plain version against its
    # Pallas kernel); sums reassociate: 1e-6 relative on the loss, 1e-5 of
    # each leaf's largest gradient
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-6)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(tgrads)
    for t, j in zip(tgrads, jleaves):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=1e-5 * max(np.abs(j).max(), 1e-6))


# ------------------------------------------------------ paged split plan


@pytest.mark.parametrize("nbmax,block,per,n", [
    (32, 16, 4, 8),      # the serving shape: 512 positions, 8 splits of 64
    (4, 16, 4, 1),       # one split: no merge launch
    (5, 16, 4, 2),       # a ragged last split
    (32, 4, 16, 2),
    (8, 64, 1, 8),       # block 64: one block a split
    (3, 128, 1, 3),      # blocks longer than a split stay whole
    (100, 1, 64, 2),
    (0, 16, 4, 1),       # an empty table still has its one split
])
def test_paged_plan(nbmax, block, per, n):
    assert ak.paged_decode_plan(nbmax, block) == (per, n)
    # the splits cover the table, and the last one is not empty
    assert per * n >= nbmax and (nbmax == 0 or per * (n - 1) < nbmax)
    assert per * block >= min(ak.PAGED_SPLIT_POSITIONS, block)


def test_paged_plan_reads_no_positions():
    """The plan is the table's width and the block size alone: no argument
    for pos, so the wrapper syncs nothing from the card."""
    import inspect
    assert list(inspect.signature(ak.paged_decode_plan).parameters) == [
        "nbmax", "block_size"]
    with pytest.raises(ValueError):
        ak.paged_decode_plan(4, 0)


# -------------------------------------------------- fused AdamW leaf table


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.standard_normal((8, 4)).astype(
                np.float32)),
            "b": torch.zeros(4, dtype=torch.bfloat16),
            "e": torch.ones(3, 5)}


def _counting(monkeypatch):
    builds = []
    real = updaters._LeafTable._build

    def build(self, ps, ms, vs):
        builds.append(len(ps))
        return real(self, ps, ms, vs)
    monkeypatch.setattr(updaters._LeafTable, "_build", build)
    return builds


def _rows(table, params, state, grads):
    return table.rows(updaters.tree_leaves(params), updaters.tree_leaves(
        grads), state["mu"], state["nu"]).copy()


def test_leaf_table_rows(monkeypatch):
    builds = _counting(monkeypatch)
    params = _tree(0)
    state = updaters.fused_adamw(1e-3).init(params)
    grads = {k: torch.ones_like(p) for k, p in params.items()}
    rows = _rows(updaters._LeafTable(), params, state, grads)
    ps = updaters.tree_leaves(params)
    gs = updaters.tree_leaves(grads)
    assert builds == [3]
    # p, g, m, v addresses, numel, dtype codes one per byte
    np.testing.assert_array_equal(rows[:, 0], [p.data_ptr() for p in ps])
    np.testing.assert_array_equal(rows[:, 1], [g.data_ptr() for g in gs])
    np.testing.assert_array_equal(rows[:, 2],
                                  [m.data_ptr() for m in state["mu"]])
    np.testing.assert_array_equal(rows[:, 3],
                                  [v.data_ptr() for v in state["nu"]])
    np.testing.assert_array_equal(rows[:, 4], [p.numel() for p in ps])
    code = 1 | 1 << 8 | 1 << 16 | 1 << 24     # "b": bf16 throughout
    np.testing.assert_array_equal(rows[:, 5], [code, 0, 0])


@pytest.mark.parametrize("change", ["new grads", "new tree", "leaf replaced",
                                    "leaf re-allocated", "moment replaced"])
def test_leaf_table_rebuilds_only_on_change(monkeypatch, change):
    builds = _counting(monkeypatch)
    params = _tree(1)
    state = updaters.fused_adamw(1e-3).init(params)
    grads = {k: torch.ones_like(p) for k, p in params.items()}
    table = updaters._LeafTable()
    _rows(table, params, state, grads)
    _rows(table, params, state, grads)
    assert len(builds) == 1          # the same tree: no second build
    if change == "new tree":
        params = _tree(2)
        state = updaters.fused_adamw(1e-3).init(params)
    elif change == "leaf replaced":
        params["w"] = params["w"].clone()
    elif change == "leaf re-allocated":
        params["w"].data = torch.zeros(8, 4)   # the same tensor, new storage
    elif change == "moment replaced":
        state["mu"][0] = torch.zeros_like(state["mu"][0])
    grads = {k: torch.ones_like(p) for k, p in params.items()}
    rows = _rows(table, params, state, grads)
    assert len(builds) == (1 if change == "new grads" else 2)
    np.testing.assert_array_equal(
        rows[:, 0], [p.data_ptr() for p in updaters.tree_leaves(params)])
    np.testing.assert_array_equal(
        rows[:, 1], [g.data_ptr() for g in updaters.tree_leaves(grads)])
    np.testing.assert_array_equal(
        rows[:, 2], [m.data_ptr() for m in state["mu"]])


@pytest.mark.parametrize("bad", ["shape", "dtype", "count"])
def test_leaf_table_checks_every_steps_grads(bad):
    """p, m and v are checked once per tree, the gradients on every call
    where their shapes or dtypes change."""
    params = _tree(3)
    state = updaters.fused_adamw(1e-3).init(params)
    table = updaters._LeafTable()
    grads = {k: torch.ones_like(p) for k, p in params.items()}
    _rows(table, params, state, grads)
    if bad == "shape":
        grads["w"] = torch.ones(4, 8)
        err, match = ValueError, "shapes differ"
    elif bad == "dtype":
        grads["w"] = torch.ones(8, 4, dtype=torch.float16)
        err, match = TypeError, "float32 or bfloat16"
    else:
        grads.pop("w")
        err, match = ValueError, "leaves"
    with pytest.raises(err, match=match):
        _rows(table, params, state, grads)
