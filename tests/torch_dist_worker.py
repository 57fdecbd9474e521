"""One rank of the port's distributed CPU tests (gloo, a ``file://``
store), and the helpers the test files use to start a world of them.

Run as ``python tests/torch_dist_worker.py SUITE RANK WORLD STORE OUT``:
the rank joins through ``multihost.initialize`` (the ``multihost`` suite
through its environment variables), runs every case of ``SUITE`` in
order — each rank the same cases, so the collectives line up — and rank
0 pickles ``{case: result}`` to ``OUT/SUITE.pkl``; each rank logs its
cases and any traceback to ``OUT/SUITE.rankR.log``. A case returns numpy
arrays and plain values (None on ranks outside the case's mesh).

This module imports torch and the port, never ``jax``: the test files
import it for the seeded inputs and compute the JAX package's side
themselves.
"""
from __future__ import annotations

import faulthandler
import os
import pickle
import signal
import subprocess
import sys
import threading
import time
import traceback

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import torch.distributed as dist  # noqa: E402

from deeplearning4j_tpu_torch.models import bert as tbert  # noqa: E402
from deeplearning4j_tpu_torch.ops.attention_kernels import (  # noqa: E402
    higher_order_attention)
from deeplearning4j_tpu_torch.parallel import (  # noqa: E402
    multihost, sequence_parallel as sp)
from deeplearning4j_tpu_torch.parallel.mesh import (  # noqa: E402
    P, NamedSharding, make_mesh, shard_batch, tree_shardings)

# ---------------------------------------------------------------- inputs


def attn_inputs(seed, shape, scale=1.0, n=3):
    """``n`` float32 arrays of ``shape`` drawn from numpy seed ``seed``."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * scale).astype(np.float32)
            for _ in range(n)]


# tests/test_models.py's TINY, and the configurations of the mesh cases
TINY = dict(vocab_size=64, hidden=32, layers=2, heads=4, mlp_dim=64,
            max_seq=32, remat=False)
GOLDEN = dict(vocab_size=128, hidden=32, layers=2, heads=4, mlp_dim=64,
              max_seq=32, remat=False)
GOLDEN_STEPS, GOLDEN_B, GOLDEN_T = 50, 4, 32
LR = 1e-3

# (case id, mesh shape, attention_impl, causal)
TRAIN_CASES = [
    ("data2-full", {"data": 2}, "full", False),
    ("model2-full", {"model": 2}, "full", False),
    ("context2-ring-causal", {"context": 2}, "ring", True),
    ("context2-ulysses", {"context": 2}, "ulysses", False),
    ("context2-full-causal", {"context": 2}, "full", True),
    ("model2-context2-ring", {"model": 2, "context": 2}, "ring", False),
    ("data2-model2-flash", {"data": 2, "model": 2}, "flash", True),
    ("data2-context2-flash", {"data": 2, "context": 2}, "flash", True),
]


def np_params(cfg: dict, seed: int):
    """A parameter tree in the JAX package's names and shapes, every leaf
    (biases and layernorms too) drawn from numpy seed ``seed``."""
    rng = np.random.default_rng(seed)
    H, M, V = cfg["hidden"], cfg["mlp_dim"], cfg["vocab_size"]

    def w(*shape, scale=0.02, base=0.0):
        return (base + rng.standard_normal(shape) * scale).astype(np.float32)

    def ln():
        return {"scale": w(H, scale=0.1, base=1.0), "bias": w(H)}

    return {"tok_emb": w(V, H), "pos_emb": w(cfg["max_seq"], H),
            "ln_f": ln(), "lm_head": w(H, V),
            "blocks": [{"ln1": ln(), "qkv": {"kernel": w(H, 3 * H),
                                             "bias": w(3 * H)},
                        "attn_out": {"kernel": w(H, H), "bias": w(H)},
                        "ln2": ln(), "mlp_in": {"kernel": w(H, M),
                                                "bias": w(M)},
                        "mlp_out": {"kernel": w(M, H), "bias": w(H)}}
                       for _ in range(cfg["layers"])]}


def np_batch(vocab: int, B: int, T: int, seed: int):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, T)).astype(np.int32),
            "targets": rng.integers(0, vocab, (B, T)).astype(np.int32),
            # a masked-LM-like weight pattern: some positions count 0
            "weights": (rng.random((B, T)) > 0.3).astype(np.float32)}


def golden_batches():
    """tests/test_sharded_goldens.py's copy task: 50 (tokens, targets)."""
    rng = np.random.default_rng(123)
    out = []
    for _ in range(GOLDEN_STEPS):
        tokens = rng.integers(0, 128, (GOLDEN_B, GOLDEN_T)).astype(np.int32)
        out.append((tokens, tokens.copy()))
    return out


def _t(*xs, grad=False):
    out = [torch.from_numpy(np.array(x, copy=True)) for x in xs]
    if grad:
        out = [x.requires_grad_() for x in out]
    return out


def _np(*xs):
    return [x.detach().numpy() for x in xs]


def _flat_leaves(tree):
    return [x.detach().numpy() for x in tbert._leaves(tree)]


def _like(tree, leaves):
    """``tree``'s structure holding ``leaves`` (in ``_leaves`` order)."""
    it = iter(leaves)

    def rebuild(t):
        if isinstance(t, dict):
            return {k: rebuild(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [rebuild(x) for x in t]
        return next(it)

    return rebuild(tree)


# ------------------------------------------------------- suite: parallel

FWD_CASES = [(impl, causal, n) for impl in ("ring", "ring_flash", "ulysses")
             for causal in (False, True) for n in (2, 4)]
GRAD_CASES = [("ring_flash", causal, n) for causal in (False, True)
              for n in (2, 4)] + [("zigzag", True, n) for n in (2, 4)]


def fwd_case(impl, causal, n):
    mesh = make_mesh({"context": n})
    if not mesh.contains_rank():
        return None
    q, k, v = _t(*attn_inputs(0, (2, 8, 32, 16)))
    out = sp.ring_self_attention(mesh, q, k, v, causal=causal, impl=impl)
    return {"out": out.numpy()}


def grad_case(impl, causal, n):
    mesh = make_mesh({"context": n})
    if not mesh.contains_rank():
        return None
    q, k, v = _t(*attn_inputs(7, (2, 3, 64, 8), 0.3), grad=True)
    if impl == "zigzag":
        out = sp.zigzag_ring_self_attention(mesh, q, k, v)
    else:
        out = sp.ring_self_attention(mesh, q, k, v, causal=causal,
                                     impl=impl)
    grads = torch.autograd.grad((out ** 2).sum(), (q, k, v))
    return dict(zip(("out", "dq", "dk", "dv"), _np(out, *grads)))


def ulysses_kernel_case(causal):
    """Ulysses' local attention through the kernel route (its plain
    version on the CPU) and through the einsum path, forward and grads."""
    mesh = make_mesh({"context": 4})
    group = mesh.group("context")
    res = {}
    for use_kernel in (True, False):
        q, k, v = _t(*attn_inputs(9, (1, 4, 32, 8), 0.3), grad=True)
        out = sp._ring_self(q, k, v, group, lambda a, b, c: (
            sp.ulysses_attention(a, b, c, group, causal, use_kernel)))
        grads = torch.autograd.grad((out ** 2).sum(), (q, k, v))
        res[use_kernel] = _np(out, *grads)
    return res


def off_envelope_case():
    mesh = make_mesh({"context": 2})
    if not mesh.contains_rank():
        return None
    group = mesh.group("context")
    q, = _t(*attn_inputs(2, (1, 2, 36, 8), n=1))
    ql = sp._own_block(q, group)
    try:
        sp.ulysses_attention(ql, ql, ql, group, False, True)
    except ValueError as e:
        return {"raised": str(e)}
    return {"raised": None}


def _double_grad(loss_fn):
    s = torch.tensor(1.0, requires_grad=True)
    g, = torch.autograd.grad(loss_fn(s), s, create_graph=True)
    h, = torch.autograd.grad(g, s)
    return float(h)


def higher_order_case(kind):
    mesh = make_mesh({"context": 2})
    if not mesh.contains_rank():
        return None
    if kind == "ring_flash":
        q, = _t(*attn_inputs(5, (1, 2, 16, 8), 0.3, n=1))

        def loss(s):
            return (sp.ring_self_attention(mesh, q * s, q, q, causal=True,
                                           impl="ring_flash") ** 2).sum()
    else:
        q, = _t(*attn_inputs(22, (1, 2, 16, 8), 0.3, n=1))

        def loss(s):
            return (sp.zigzag_ring_self_attention(mesh, q * s, q, q)
                    ** 2).sum()
    with higher_order_attention():
        h = _double_grad(loss)
    res = {"h": h}
    if kind == "ring_flash":
        try:
            _double_grad(loss)
            res["outside"] = None
        except RuntimeError as e:
            res["outside"] = str(e)
    return res


def loop_case(kind, causal):
    """The distributed ring (4 ranks) against :func:`ring_flash_loop` /
    :func:`zigzag_ring_flash_loop` over 4 virtual ranks, forward and
    grads, bit for bit."""
    mesh = make_mesh({"context": 4})
    group = mesh.group("context")
    q, k, v, do = _t(*attn_inputs(31, (2, 3, 64, 8), 0.5, n=4))
    ql, kl, vl = (sp._own_block(x, group).requires_grad_()
                  for x in (q, k, v))
    if kind == "zigzag":
        out = sp.zigzag_ring_flash_attention(ql, kl, vl, group)
    else:
        out = sp.ring_flash_attention(ql, kl, vl, group, causal)
    grads = torch.autograd.grad(out, (ql, kl, vl), sp._own_block(do, group))
    dist_all = [sp._all_gather_seq(x.detach(), group)
                for x in (out, *grads)]
    if dist.get_rank() != 0:
        return None
    if kind == "zigzag":
        lo, lg = sp.zigzag_ring_flash_loop(q, k, v, 4, do)
    else:
        lo, lg = sp.ring_flash_loop(q, k, v, 4, causal, do)
    return {"equal": [bool(torch.equal(a, b))
                      for a, b in zip(dist_all, (lo, *lg))],
            "max_diff": max(float((a - b).abs().max())
                            for a, b in zip(dist_all, (lo, *lg)))}


def mesh_case():
    world = dist.get_world_size()
    m = make_mesh({"data": 2, "model": 2})
    res = {"shape": dict(m.shape), "axis_names": m.axis_names,
           "default": dict(make_mesh().shape), "world": world}
    try:
        make_mesh({"data": 2 * world})
        res["too_big"] = None
    except ValueError as e:
        res["too_big"] = str(e)
    cut = make_mesh({"data": 2})
    flags = [None] * world
    dist.all_gather_object(flags, cut.contains_rank())
    res["cut_devices"] = cut.devices.tolist()
    res["cut_contains"] = flags
    coords = [None] * world
    dist.all_gather_object(coords, (m.axis_index("data"),
                                    m.axis_index("model")))
    res["coords"] = coords
    return res


def placement_case():
    mesh = make_mesh({"data": 2, "model": 2})
    x = torch.arange(16 * 6, dtype=torch.float32).reshape(16, 6)
    rows = shard_batch(mesh, {"x": x})["x"]
    sh = tree_shardings(mesh, {"w": P("model", "context"), "b": P()})
    w = sh["w"].shard(x)
    blocks = [None] * dist.get_world_size()
    dist.all_gather_object(blocks, (rows.numpy(), w.numpy()))
    odd = torch.arange(6 * 5, dtype=torch.float32).reshape(6, 5)
    odd_sh = NamedSharding(mesh, P("data", None))
    return {"spec": tuple(sh["w"].spec), "whole": tuple(sh["b"].spec),
            "blocks": blocks,
            "round_trip": bool(torch.equal(sh["w"].gather(w), x)),
            "odd_round_trip": bool(torch.equal(
                odd_sh.gather(odd_sh.shard(odd)), odd)),
            "batch_round_trip": bool(torch.equal(NamedSharding(
                mesh, P("data", None)).gather(rows), x))}


def parallel_suite():
    cases = [(f"fwd-{i}-{c}-{n}", (lambda i=i, c=c, n=n: fwd_case(i, c, n)))
             for i, c, n in FWD_CASES]
    cases += [(f"grad-{i}-{c}-{n}", (lambda i=i, c=c, n=n:
                                     grad_case(i, c, n)))
              for i, c, n in GRAD_CASES]
    cases += [(f"ulysses-kernel-{c}", (lambda c=c: ulysses_kernel_case(c)))
              for c in (False, True)]
    cases += [("off-envelope", off_envelope_case)]
    cases += [(f"higher-order-{k}", (lambda k=k: higher_order_case(k)))
              for k in ("ring_flash", "zigzag")]
    cases += [(f"loop-{k}-{c}", (lambda k=k, c=c: loop_case(k, c)))
              for k, c in (("ring", False), ("ring", True),
                           ("zigzag", True))]
    cases += [("mesh", mesh_case), ("placement", placement_case)]
    return cases


# ------------------------------------------------------ suite: multihost


def multihost_suite():
    def info():
        row = {"process_index": multihost.process_index(),
               "global": multihost.global_device_count(),
               "local": multihost.local_device_count(),
               "coordinator": multihost.is_coordinator(),
               "barrier": multihost.barrier("test")}
        rows = [None] * dist.get_world_size()
        dist.all_gather_object(rows, row)
        return rows
    return [("info", info)]


# ------------------------------------------------------ suite: mesh train


def _tcfg(cfg, impl, causal):
    return tbert.TransformerConfig(dtype=torch.float32, attention_impl=impl,
                                   causal=causal, **cfg)


def _tree(np_tree):
    return tbert.params_from_numpy(np_tree, device="cpu")


def train_case(shape, impl, causal):
    """Loss and gradients of ``lm_loss`` on the mesh (gathered whole),
    then one ``make_train_step(mesh=)`` step: its loss and the params."""
    mesh = make_mesh(shape)
    if not mesh.contains_rank():
        return None
    cfg = _tcfg(TINY, impl, causal)
    params = np_params(TINY, 0)
    batch = {k: torch.from_numpy(v)
             for k, v in np_batch(TINY["vocab_size"], 4, 16, 1).items()}
    placed = tbert.place_params(_tree(params), cfg, mesh)
    tree, xs = tbert.grad_aliases(placed)
    loss = tbert.lm_loss(tree, tbert.local_batch(mesh, batch), cfg, mesh)
    grads = tbert._sum_grads(torch.autograd.grad(loss, xs), mesh)
    whole_grads = _flat_leaves(tbert.gather_params(_like(placed, grads), cfg,
                                                   mesh))
    init, step = tbert.make_train_step(cfg, mesh, learning_rate=LR)
    state = init(placed)
    placed, state, step_loss = step(placed, state, batch)
    whole = _flat_leaves(tbert.gather_params(placed, cfg, mesh))
    return {"loss": float(loss.detach()), "grads": whole_grads,
            "step_loss": float(step_loss), "params": whole}


def infer_case():
    """``make_infer_last_logits(cfg, mesh)`` on a (data, context) mesh and
    per-rank ``forward`` blocks against the meshless forward."""
    mesh = make_mesh({"data": 2, "model": 2, "context": 2})
    cfg = _tcfg(TINY, "ring", True)
    params = _tree(np_params(TINY, 3))
    tokens = torch.from_numpy(np_batch(TINY["vocab_size"], 4, 16,
                                       4)["tokens"])
    placed = tbert.place_params(params, cfg, mesh)
    last = tbert.make_infer_last_logits(cfg, mesh)(placed, tokens)
    block = tbert.forward(placed, tbert.local_batch(
        mesh, {"t": tokens})["t"], cfg, mesh)
    return {"last": last.numpy(), "block": block.numpy(),
            "coord": (mesh.axis_index("data"), mesh.axis_index("context"))}


def refusal_case():
    """_packed_mesh_spec / _use_packed_kernel on the reference test's
    meshes (tests/test_models.py)."""
    cfg = _tcfg(TINY, "flash", False)
    res = {"dc": tbert._packed_mesh_spec(
               cfg, make_mesh({"data": 2, "context": 2}), 4),
           "m8": tbert._packed_mesh_spec(cfg, make_mesh({"model": 8}), 8),
           "d8": tbert._packed_mesh_spec(cfg, make_mesh({"data": 8}), 4)}
    dm = make_mesh({"data": 2, "model": 2})
    spec, heads = tbert._packed_mesh_spec(cfg, dm, 4)
    res.update(dm_spec=tuple(spec), dm_heads=heads,
               use_dm=tbert._use_packed_kernel(cfg, dm, 4, 16),
               use_d8=tbert._use_packed_kernel(cfg, make_mesh({"data": 8}),
                                               4, 16),
               use_dmc1=tbert._use_packed_kernel(
                   cfg, make_mesh({"data": 4, "model": 2, "context": 1}),
                   4, 16))
    return res


def golden_case():
    """tests/test_sharded_goldens.py's 2x2x2 ring trajectory: 50 steps."""
    mesh = make_mesh({"data": 2, "model": 2, "context": 2})
    cfg = _tcfg(GOLDEN, "ring", False)
    params = tbert.place_params(_tree(np_params(GOLDEN, 0)), cfg, mesh)
    init, step = tbert.make_train_step(cfg, mesh, learning_rate=LR)
    state = init(params)
    losses = []
    weights = torch.ones((GOLDEN_B, GOLDEN_T), dtype=torch.float32)
    for tokens, targets in golden_batches():
        params, state, loss = step(params, state, {
            "tokens": torch.from_numpy(tokens),
            "targets": torch.from_numpy(targets), "weights": weights})
        losses.append(float(loss))
    flat = np.concatenate([x.ravel() for x in _flat_leaves(
        tbert.gather_params(params, cfg, mesh))])
    return {"losses": np.asarray(losses), "params": flat}


def train_suite():
    cases = [(f"train-{cid}", (lambda s=s, i=i, c=c: train_case(s, i, c)))
             for cid, s, i, c in TRAIN_CASES]
    cases += [("infer", infer_case), ("refusal", refusal_case),
              ("golden", golden_case)]
    return cases


# ---------------------------------------------------- suite: mesh serving

# tests/test_generation.py's CFG (fp32, einsum attention), its prompts and
# sampling knobs; the port-only cases run the packed route
SERVE = dict(vocab_size=50, hidden=32, layers=2, heads=2, mlp_dim=64,
             max_seq=64)
DRAFT = dict(vocab_size=50, hidden=16, layers=1, heads=2, mlp_dim=32,
             max_seq=64)
SAMPLED = dict(temperature=0.8, top_k=5, seed=3)
# (case id, mesh shape, engine keyword arguments)
SERVE_CASES = [
    ("contiguous", {"data": 4, "model": 2}, dict(paged=False)),
    ("paged-gather", {"data": 4, "model": 2}, dict(block_size=8)),
    ("fused-float32", {"data": 4, "model": 2},
     dict(block_size=8, paged_attention="fused", kv_dtype="float32")),
    ("fused-int8", {"data": 4, "model": 2},
     dict(block_size=8, paged_attention="fused", kv_dtype="int8")),
]
TIGHT = dict(slots=2, max_len=32, block_size=8, num_blocks=5,
             allocate="on_demand", queue_capacity=8,
             swap_threshold_blocks=0, swap_capacity_blocks=64)
# the follower of the lost-rank case dies after this many decode plans
KILL_AFTER = 3
# set on every rank by the last case: rank 1 is gone, so the world ends
# without its closing barrier
WORLD_BROKEN = False


def serve_prompt(n, seed=0):
    """tests/test_generation.py's ``prompt``."""
    return np.random.default_rng(seed).integers(
        1, SERVE["vocab_size"], n).astype(np.int32)


def serve_cfg(impl="full", **over):
    return tbert.TransformerConfig(dtype=torch.float32, causal=True,
                                   attention_impl=impl, remat=False,
                                   **dict(SERVE, **over))


def serve_params():
    return np_params(SERVE, 11)


def draft_params():
    return np_params(DRAFT, 12)


def _engine(mesh, cfg=None, params=None, **kw):
    from deeplearning4j_tpu_torch.serving import GenerationEngine

    return GenerationEngine(_tree(serve_params() if params is None
                                  else params),
                            serve_cfg() if cfg is None else cfg, mesh=mesh,
                            device="cpu", **kw)


def jax_mesh_case(shape, kw):
    """Greedy and sampled streams of one prompt (the reference's mesh
    tests), then the same prompt again: the second stream reuses the
    engine."""
    mesh = make_mesh(shape)
    if not mesh.contains_rank():
        return None
    with _engine(mesh, slots=2, max_len=32, **kw) as eng:
        if not eng.is_driver:
            return None
        p = serve_prompt(6, seed=21)
        return {"greedy": eng.generate(p, max_new_tokens=6, timeout=120),
                "sampled": eng.generate(p, max_new_tokens=6, timeout=120,
                                        **SAMPLED),
                "plans": eng.plan_stats()["plans"]}


def fused_refusal_case():
    mesh = make_mesh({"data": 1, "model": 8})
    try:
        tbert.make_paged_decode_step(serve_cfg(), 8, mesh=mesh,
                                     paged_attention="fused")
    except ValueError as e:
        return {"raised": str(e)}
    return {"raised": None}


def prefix_cow_case():
    """Three streams on a 10-token prefix (its tail block copied on
    write), greedy and sampled."""
    mesh = make_mesh({"model": 2})
    if not mesh.contains_rank():
        return None
    with _engine(mesh, serve_cfg("flash"), slots=4, max_len=32,
                 block_size=8) as eng:
        if not eng.is_driver:
            return None
        pid = eng.register_prefix(serve_prompt(10, seed=40))
        hs = [eng.submit(serve_prompt(3, seed=60 + i), prefix_id=pid,
                         max_new_tokens=5, **(SAMPLED if i else {}))
              for i in range(3)]
        return {"streams": [h.result(timeout=120) for h in hs],
                "cow": int(eng.metrics.kv_cow_copies_total.value)}


def preempt_swap_case():
    """Two streams on a 5-block on-demand pool: one is preempted and
    swapped to host (each rank its own heads), then swapped back."""
    mesh = make_mesh({"model": 2})
    if not mesh.contains_rank():
        return None
    with _engine(mesh, serve_cfg("flash"), **TIGHT) as eng:
        if not eng.is_driver:
            return None
        hs = [eng.submit(serve_prompt(4, s), max_new_tokens=20, eos_id=None,
                         seed=s) for s in (0, 1)]
        m = eng.metrics
        return {"streams": [h.result(timeout=120) for h in hs],
                "preemptions": int(m.preemptions_total.value),
                "swapped": int(m.kv_swapped_blocks.value),
                "swap_ins": sum(h._req.x.swap_ins for h in hs)}


def speculative_case():
    from deeplearning4j_tpu_torch.serving import SpecConfig

    mesh = make_mesh({"model": 2})
    if not mesh.contains_rank():
        return None
    dcfg = tbert.TransformerConfig(dtype=torch.float32, causal=True,
                                   attention_impl="full", remat=False,
                                   **DRAFT)
    spec = SpecConfig(draft_params=_tree(draft_params()), draft_cfg=dcfg,
                      k=2)
    with _engine(mesh, serve_cfg("flash"), slots=2, max_len=32,
                 block_size=8, paged_attention="fused",
                 speculative=spec) as eng:
        if not eng.is_driver:
            return None
        ps = [serve_prompt(5, seed=70), serve_prompt(9, seed=71)]
        out = [eng.generate(ps[0], max_new_tokens=8, timeout=120),
               eng.generate(ps[1], max_new_tokens=8, timeout=120,
                            **SAMPLED)]
        return {"streams": out,
                "verify_steps": int(eng.metrics.decode_steps_total.value)}


def migrate_case():
    """A prefill engine exports a stream's pages (gathered over 'model':
    every head); a decode engine imports them and resumes the stream."""
    mesh = make_mesh({"model": 2})
    if not mesh.contains_rank():
        return None
    p = serve_prompt(11, seed=80)
    res = {}
    with _engine(mesh, serve_cfg("flash"), slots=2, max_len=32,
                 block_size=8) as eng:
        if eng.is_driver:
            h = eng.submit(p, max_new_tokens=1, capture_pages=True)
            first = h.result(timeout=120)
            entry = eng.take_captured_pages(h)
            res.update(first=first, pages=[{k: v.numpy() for k, v in
                                            layer.items()}
                                           for layer in entry.payload])
    with _engine(mesh, serve_cfg("flash"), slots=2, max_len=32,
                 block_size=8) as eng:
        if not eng.is_driver:
            return None
        key = eng.import_pages(entry)
        h = eng.submit(p, max_new_tokens=6, swap_key=key,
                       resume_tokens=first, resume_step=1)
        res.update(resumed=h.result(timeout=120), swap_ins=h._req.x.swap_ins)
    return res


def inference_case():
    """``InferenceEngine`` over ``CausalLMAdapter(mesh=)`` through a
    registry deployment at {model: 2}: each batch against a direct call of
    the mesh's ``make_infer_last_logits`` on the padded batch; then the
    registry's default ladder on {data: 8}."""
    from deeplearning4j_tpu_torch.serving import (
        CausalLMAdapter, ModelRegistry)

    res = {}
    cfg = serve_cfg("flash")
    params = _tree(serve_params())
    rng = np.random.default_rng(5)
    xs = [rng.integers(1, 50, (n, 12)).astype(np.int32) for n in (1, 3, 2)]
    mesh = make_mesh({"model": 2})
    if mesh.contains_rank():
        reg = ModelRegistry(default_buckets=(1, 2, 4))
        reg.deploy("lm", CausalLMAdapter(params, cfg, mesh, device="cpu"))
        outs = []
        with reg.engine("lm", mesh=mesh, max_wait_ms=0) as eng:
            if eng.is_driver:
                outs = [eng.output(x) for x in xs]
        fwd = tbert.make_infer_last_logits(cfg, mesh)
        placed = tbert.place_params(params, cfg, mesh)
        direct = []
        for x in xs:
            b = 1 if len(x) == 1 else (2 if len(x) == 2 else 4)
            pad = np.zeros((b, 12), np.int32)
            pad[:len(x)] = x
            direct.append(fwd(placed, torch.from_numpy(pad)).numpy()[
                :len(x)])
        reg.shutdown()
        if mesh.axis_index("model") == 0:
            res.update(outs=outs, direct=direct, xs=xs)
    d8 = make_mesh({"data": 8})
    reg = ModelRegistry()
    reg.deploy("lm", CausalLMAdapter(params, cfg, d8, device="cpu"))
    with reg.engine("lm", mesh=d8, max_wait_ms=0) as eng:
        if eng.is_driver:
            res.update(d8_buckets=eng.buckets,
                       d8_out=eng.output(np.ones((3, 6), np.int32)))
    reg.shutdown()
    return res if dist.get_rank() == 0 else None


def follower_submit_case():
    mesh = make_mesh({"model": 2})
    if not mesh.contains_rank():
        return None
    with _engine(mesh, slots=2, max_len=32, block_size=8) as eng:
        if eng.is_driver:
            out = eng.generate(serve_prompt(4), max_new_tokens=2,
                               timeout=120)
            msgs = [None]
        else:
            out = None
            try:
                eng.submit(serve_prompt(4))
                msgs = [None]
            except ValueError as e:
                msgs = [str(e)]
    gathered = [None, None]
    dist.all_gather_object(gathered, msgs, group=mesh.group("model"))
    return {"follower": gathered[1][0], "driver_stream": out} \
        if dist.get_rank() == 0 else None


def lost_rank_case():
    """Rank 1, the follower, kills itself after ``KILL_AFTER`` decode
    plans; the driver must fail its stream typed and stop, with no hang.
    The last case of the suite: the world has a dead rank after it."""
    import os
    import signal

    global WORLD_BROKEN
    WORLD_BROKEN = True
    mesh = make_mesh({"model": 2})
    if not mesh.contains_rank():
        return None
    eng = _engine(mesh, slots=2, max_len=64, block_size=8)
    if not eng.is_driver:
        seen = [0]
        follow = eng._follow

        def dying(plan):
            if plan.get("point") == "generation.decode_step":
                seen[0] += 1
                if seen[0] > KILL_AFTER:
                    os.kill(os.getpid(), signal.SIGKILL)
            follow(plan)

        eng._plan._handler = dying
        eng._plan._done.wait()
        return None
    t0 = time.perf_counter()
    h = eng.submit(serve_prompt(6), max_new_tokens=40, eos_id=None)
    try:
        h.result(timeout=240)
        raised = None
    except Exception as e:
        raised = (type(e).__name__, str(e)[:300])
    dt = time.perf_counter() - t0
    res = {"raised": raised, "seconds": dt,
           "tokens": len(h.tokens_so_far()), "stopped": eng._stop.is_set()}
    try:
        eng.submit(serve_prompt(4))
        res["after"] = None
    except Exception as e:
        res["after"] = type(e).__name__
    eng.shutdown()
    return res


def serving_suite():
    cases = [(cid, (lambda s=s, kw=kw: jax_mesh_case(s, kw)))
             for cid, s, kw in SERVE_CASES]
    cases += [("fused-refusal", fused_refusal_case),
              ("prefix-cow", prefix_cow_case),
              ("preempt-swap", preempt_swap_case),
              ("speculative", speculative_case),
              ("migrate", migrate_case),
              ("inference", inference_case),
              ("follower-submit", follower_submit_case),
              ("lost-rank", lost_rank_case)]
    return cases


# ------------------------------------------------------- suite: plan link

# the link's timeout in the plan-link case: a beat every 0.25 s
LINK_TIMEOUT_S = 2.0


class _HeldLock:
    """A plan link's lock that holds the link's heartbeat thread at its
    acquire until :attr:`gate` opens; :attr:`waiting` says the beat got
    there (past its wait, about to take the lock)."""

    def __init__(self, link):
        self._lock = threading.RLock()
        self._link = link
        self.waiting = threading.Event()
        self.gate = threading.Event()

    def acquire(self, blocking=True, timeout=-1):
        if threading.current_thread() is self._link._thread \
                and not self.gate.is_set():
            self.waiting.set()
            self.gate.wait()
        return self._lock.acquire(blocking, timeout)

    def release(self):
        self._lock.release()

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.release()


class _Endpoint:
    """A plan endpoint that records the plans it is handed."""

    def __init__(self):
        self.plans = []

    def _deliver(self, plan):
        self.plans.append(plan.get("op"))
        return True

    def _broken(self, exc):
        pass


def close_after_beat_case():
    """The last endpoint of a 2-rank link closes while the driver's beat
    is held at the link's lock, past its wait; the lock opens once the
    close went out. Returns both ranks' records: the driver's close
    seconds and whether its beat thread ended; the follower's delivered
    plans and what, if anything, reached it after the close (one more
    receive on the link's group, which times out when nothing comes)."""
    from deeplearning4j_tpu_torch.serving import sharded

    link = sharded._Link((0, 1), LINK_TIMEOUT_S)
    ep = _Endpoint()
    if link.is_driver:
        held = link.lock = _HeldLock(link)
        send = link.send

        def send_then_open(tag, plan):
            out = send(tag, plan)
            if plan.get("op") == "close":
                held.gate.set()
            return out

        link.send = send_then_open
        tag = link.attach(ep)
        assert held.waiting.wait(timeout=30), "the beat never came"
        t0 = time.perf_counter()
        link.detach(tag)
        row = {"close_s": time.perf_counter() - t0,
               "beat_alive": link._thread.is_alive()}
    else:
        link.attach(ep)
        link._thread.join(timeout=60)
        row = {"dispatcher_alive": link._thread.is_alive(),
               "plans": list(ep.plans)}
        try:
            _tag, plan = sharded._broadcast(link.group)
            row["after_close"] = plan.get("op")
        except Exception:   # the group's timeout: nothing came
            row["after_close"] = None
    rows = [None] * dist.get_world_size()
    dist.all_gather_object(rows, row)
    return rows


def close_after_follower_left_case():
    """The follower closes its last endpoint and its process ends at
    once; the driver closes its own 0.5 s later (a driver still finishing
    its engine's shutdown). The follower's close waits for the driver's:
    a follower gone before the close leaves the driver's close broadcast
    waiting out the group's timeout. The follower's process ends in this
    case, so it is its suite's only one. Returns the driver's close
    seconds and the link's error, if any."""
    from deeplearning4j_tpu_torch.serving import sharded

    global WORLD_BROKEN
    WORLD_BROKEN = True
    link = sharded._Link((0, 1), LINK_TIMEOUT_S)
    tag = link.attach(_Endpoint())
    dist.barrier()
    if not link.is_driver:
        link.detach(tag)
        os._exit(0)
    time.sleep(0.5)
    t0 = time.perf_counter()
    link.detach(tag)
    return {"close_s": time.perf_counter() - t0,
            "link_error": None if link.error is None else repr(link.error)}


def planlink_suite():
    return [("close-after-beat", close_after_beat_case)]


def planleave_suite():
    return [("close-after-follower-left", close_after_follower_left_case)]


# ---------------------------------------------------- data parallelism
# ParallelWrapper over a data axis of every rank (tests/
# test_torch_data_parallel.py): the same global batches on every rank.


def _dp_result(net, losses):
    """The rank's losses, flat params and layer state, and whether every
    rank holds the same params (one update applied everywhere)."""
    from deeplearning4j_tpu_torch.train.updaters import tree_leaves
    flat = net.params().toNumpy()
    flats = [None] * dist.get_world_size()
    dist.all_gather_object(flats, flat)
    return {"losses": losses, "params": flat,
            "state": [t.numpy() for t in tree_leaves(net._state)],
            "iterations": net.getIterationCount(), "epochs": net.getEpochCount(),
            "ranks_equal": all(np.array_equal(f, flat) for f in flats)}


def dp_mln_case():
    """tests/torch_graph_cases.py's dp_net through ParallelWrapper."""
    import torch_graph_cases as GC
    from deeplearning4j_tpu_torch import nd
    import deeplearning4j_tpu_torch.nn as pnn
    import deeplearning4j_tpu_torch.train as ptrain
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.parallel.data_parallel import ParallelWrapper
    with nd.enableX64(True):
        net = pnn.MultiLayerNetwork(GC.dp_net(pnn, ptrain), device="cpu").init()
        pw = ParallelWrapper.Builder(net).workers(dist.get_world_size()).build()
        losses = []
        for x, y in GC.dp_batches():
            pw.fit(DataSet(x, y))
            losses.append(net.score())
        return _dp_result(net, losses)


def dp_graph_case():
    """The multi-input graph (masks, dropout, a DropoutLayer,
    BatchNormalization) through ParallelWrapper, and the same graph's
    plain fit on the cyclic-padded global batches in this process."""
    import torch_graph_cases as GC
    from deeplearning4j_tpu_torch import nd
    import deeplearning4j_tpu_torch.nn as pnn
    import deeplearning4j_tpu_torch.train as ptrain
    from deeplearning4j_tpu_torch.data import MultiDataSet
    from deeplearning4j_tpu_torch.parallel.data_parallel import ParallelWrapper
    n = dist.get_world_size()
    with nd.enableX64(True):
        net = pnn.ComputationGraph(GC.multi_io(pnn, ptrain), device="cpu").init()
        plain = net.clone()
        pw = ParallelWrapper(net)
        losses, plain_losses = [], []
        for s, b in enumerate((6, 5)):
            feats, labels, m2 = GC.multi_io_data(seed=s, batch=b)
            pw.fit(MultiDataSet(feats, labels, [None, m2], None))
            losses.append(net.score())
            idx = np.resize(np.arange(b), b + (-b) % n)
            plain.fit(MultiDataSet([f[idx] for f in feats], [y[idx] for y in labels],
                                   [None, m2[idx]], None))
            plain_losses.append(plain.score())
        out = _dp_result(net, losses)
        out.update(plain_losses=plain_losses, plain_params=plain.params().toNumpy())
        return out


def dp_infer_case():
    """ParallelInference.output of 5 rows (padded to the n*2^k ladder), the
    network's own output, and the same rows through ``engine()`` (every
    rank builds it; the driver submits, the other rank follows its
    batches)."""
    import torch_graph_cases as GC
    import deeplearning4j_tpu_torch.nn as pnn
    import deeplearning4j_tpu_torch.train as ptrain
    from deeplearning4j_tpu_torch.parallel.data_parallel import ParallelInference
    net = pnn.MultiLayerNetwork(GC.dp_net(pnn, ptrain), device="cpu").init()
    x = GC.dp_batches(seed=3, sizes=(5,))[0][0]
    pi = ParallelInference.Builder(net).workers(dist.get_world_size()).build()
    with pi.engine(max_wait_ms=0) as eng:
        served = np.asarray(eng.output(x)) if eng.is_driver else None
        buckets = eng.buckets
    return {"parallel": pi.output(x).toNumpy(), "plain": net.output(x).toNumpy(),
            "bucket": pi._bucket(5), "engine": served, "engine_buckets": buckets}


def dataparallel_suite():
    return [("mln", dp_mln_case), ("graph", dp_graph_case),
            ("inference", dp_infer_case)]


# ------------------------------------------------ sharded checkpoints
# util/sharded_checkpoint.py over a 2-rank 'model' mesh (tests/
# test_torch_profiler_util.py): the world's directory holds the
# checkpoints (``OUT_DIR``, set by ``main``).

OUT_DIR = None
CKPT_STEPS, CKPT_STOP = 6, 3


def checkpoint_case():
    """``make_train_step(cfg, mesh)`` (TINY, fp32, a 2-rank 'model' mesh)
    for 6 steps without a break, against ``train_with_checkpointing``
    stopped by a SIGTERM during step 3 (``GracefulShutdown``; saves every
    2 steps, keeping 2, and the forced save at 3), then a fresh manager's
    restore of the latest step into new state and the run's last 3 steps.
    Returns the losses of both runs, whether every rank's params and
    optimizer state are bit-equal at the end, the kept steps and the
    restored step."""
    import signal as _signal

    from deeplearning4j_tpu_torch.util.sharded_checkpoint import (
        GracefulShutdown, ShardedCheckpointManager, train_with_checkpointing)
    from deeplearning4j_tpu_torch.train.updaters import tree_leaves
    mesh = make_mesh({"model": 2})
    cfg = _tcfg(TINY, "full", False)
    init, step = tbert.make_train_step(cfg, mesh, learning_rate=LR)
    batches = [np_batch(TINY["vocab_size"], 4, 16, 10 + s) for s in range(CKPT_STEPS)]

    def batch_fn(s):
        return {k: torch.from_numpy(v) for k, v in batches[s].items()}

    def fresh():
        p = tbert.place_params(_tree(np_params(TINY, 0)), cfg, mesh)
        return p, init(p)

    params, state = fresh()
    whole = []
    for s in range(CKPT_STEPS):
        params, state, loss = step(params, state, batch_fn(s))
        whole.append(float(loss))

    class Preempt:
        def iterationDone(self, model, it, ep):
            if it == CKPT_STOP - 1:
                _signal.raise_signal(_signal.SIGTERM)

    path = os.path.join(OUT_DIR, "ckpt")
    mgr = ShardedCheckpointManager(path, keep_last=2, save_interval_steps=2, mesh=mesh)
    p, st = fresh()
    with GracefulShutdown() as stop:
        p, st, done, first = train_with_checkpointing(
            step, p, st, batch_fn, CKPT_STEPS, mgr, shutdown=stop, listeners=[Preempt()])
    mgr2 = ShardedCheckpointManager(path, keep_last=2, save_interval_steps=2, mesh=mesh)
    like_p, like_st = fresh()
    p, st, at, meta = mgr2.restore(like_p, like_st)
    p, st, _, second = train_with_checkpointing(step, p, st, batch_fn, CKPT_STEPS, mgr2,
                                                start_step=at)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(p), tree_leaves(params))) \
        and all((torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)
                for a, b in zip(tree_leaves(st), tree_leaves(state)))
    flags = [None] * dist.get_world_size()
    dist.all_gather_object(flags, same)
    return {"whole": whole, "first": first, "second": second, "stopped_at": done,
            "restored": at, "meta": meta, "steps": mgr2.all_steps(), "bit_equal": flags}


def checkpoint_suite():
    return [("resume", checkpoint_case)]


SUITES = {"parallel": parallel_suite, "multihost": multihost_suite,
          "train": train_suite, "serving": serving_suite,
          "planlink": planlink_suite, "planleave": planleave_suite,
          "dataparallel": dataparallel_suite,
          "checkpoint": checkpoint_suite}


# ---------------------------------------------------------------- worker


def main(argv) -> int:
    suite, rank, world, store, out = argv[1], int(argv[2]), int(argv[3]), \
        argv[4], argv[5]
    torch.set_num_threads(1)
    # a world that times out asks every live rank for its threads' stacks
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    # crash dumps (a rank whose mesh broke) go to the world's directory
    from deeplearning4j_tpu_torch.util.crash_reporting import (
        crashDumpOutputDirectory)
    crashDumpOutputDirectory(out)
    if suite == "multihost":
        os.environ.update(COORDINATOR_ADDRESS=f"file://{store}",
                          NUM_PROCESSES=str(world), PROCESS_ID=str(rank))
        joined = multihost.initialize(device="cpu")
    else:
        joined = multihost.initialize(f"file://{store}", world, rank,
                                      device="cpu")
    results = {"_joined": joined}
    global OUT_DIR
    OUT_DIR = out
    with open(os.path.join(out, f"{suite}.rank{rank}.log"), "w") as log:
        for name, fn in SUITES[suite]():
            t0 = time.perf_counter()
            try:
                res = fn()
            except Exception:   # recorded; the test reports it
                res = {"error": traceback.format_exc()}
                log.write(res["error"])
            log.write(f"{name}: {time.perf_counter() - t0:.2f} s\n")
            log.flush()
            results[name] = res
    results["_jax_imported"] = sorted(m for m in sys.modules
                                      if m == "jax" or m.startswith("jax."))
    if rank == 0:
        tmp = os.path.join(out, f"{suite}.pkl.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(results, f)
        os.replace(tmp, os.path.join(out, f"{suite}.pkl"))
    if WORLD_BROKEN:
        # a rank of the world is gone: no barrier can complete, and the
        # process groups' teardown would wait on it
        os._exit(0)
    dist.barrier()
    dist.destroy_process_group()
    return 0


# ----------------------------------------------------- the tests' launcher


class World:
    """``world`` worker processes of ``suite`` started at once; each keeps
    one CPU thread. :meth:`results` waits for them (every wait bounded
    by ``timeout`` seconds from the start; on expiry every process is
    killed and the call raises) and returns rank 0's results."""

    def __init__(self, suite: str, world: int, tmpdir, timeout: float,
                 killed=()):
        self.suite, self.dir = suite, str(tmpdir)
        self.killed = set(killed)   # ranks a case kills (SIGKILL)
        self.deadline = time.monotonic() + timeout
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        store = os.path.join(self.dir, f"{suite}.store")
        self.procs = []
        for r in range(world):
            with open(os.path.join(self.dir, f"{suite}.rank{r}.err"),
                      "w") as err:
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), suite,
                     str(r), str(world), store, self.dir], cwd=REPO,
                    env=env, stdout=subprocess.DEVNULL, stderr=err))
        self._results = None

    def _logs(self) -> str:
        out = []
        for r in range(len(self.procs)):
            for ext in ("log", "err"):
                path = os.path.join(self.dir, f"{self.suite}.rank{r}.{ext}")
                if os.path.exists(path):
                    with open(path) as f:
                        text = f.read()[-(3000 if ext == "log" else 8000):]
                    if text.strip():
                        out.append(f"--- rank {r} {ext}\n{text}")
        return "\n".join(out)

    def results(self) -> dict:
        if self._results is not None:
            return self._results
        try:
            for p in self.procs:
                p.wait(timeout=max(0.1, self.deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            # the live ranks' stacks into their err logs, then kill them
            for p in self.procs:
                if p.poll() is None:
                    p.send_signal(signal.SIGUSR1)
            time.sleep(2.0)
            self.close()
            raise RuntimeError(f"{self.suite} world timed out\n"
                               + self._logs())
        codes = [p.returncode for p in self.procs]
        path = os.path.join(self.dir, f"{self.suite}.pkl")
        if any(c and not (r in self.killed and c == -9)
               for r, c in enumerate(codes)) or not os.path.exists(path):
            raise RuntimeError(f"{self.suite} world exited {codes}\n"
                               + self._logs())
        with open(path, "rb") as f:
            self._results = pickle.load(f)
        return self._results

    def case(self, name: str):
        res = self.results()[name]
        if isinstance(res, dict) and "error" in res:
            raise AssertionError(f"case {name} failed in the worker:\n"
                                 + res["error"])
        return res

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait(timeout=30)


if __name__ == "__main__":
    sys.exit(main(sys.argv))
