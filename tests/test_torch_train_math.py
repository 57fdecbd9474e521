"""The port's training math (``deeplearning4j_tpu_torch/train``) against
the JAX package's on the CPU:

- each of the 11 updaters, with a float learning rate and with a
  schedule, over 10 steps of seeded gradients on a small parameter tree
  (a list of dicts, one of them empty and one nested, as networks hold
  them): the updates and the params within 1e-6 of the largest |value|
  of the reference's, and the state's leaves in optax's tree order
  (equal count leaves, equal dtypes, values within 1e-6) every step;
- every schedule's value at steps 0..40 within 1.2e-7 relative (one
  float32 ulp: Step, Poly and WarmupLinearDecay compute in float32, as
  the reference's int32 count promotes them; the others in doubles);
- every loss, with and without a mask, and its gradient with respect
  to the predictions: within 1e-6 relative (1e-5 for the gradients);
- every activation and its gradient, within 1e-6 (gradients 1e-5);
- the three regularizations' penalties and gradients.
The port's 64-bit switch is on, as the suite runs the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeplearning4j_tpu.train import activations as jact
from deeplearning4j_tpu.train import losses as jloss
from deeplearning4j_tpu.train import regularization as jreg
from deeplearning4j_tpu.train import schedules as jsched
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu_torch import nd
from deeplearning4j_tpu_torch.train import activations as pact
from deeplearning4j_tpu_torch.train import losses as ploss
from deeplearning4j_tpu_torch.train import regularization as preg
from deeplearning4j_tpu_torch.train import schedules as psched
from deeplearning4j_tpu_torch.train import updaters as pupd
from deeplearning4j_tpu_torch.train.updaters import tree_leaves, tree_map

STEPS = 10
UPD_REL = 1e-6


@pytest.fixture(autouse=True)
def _x64():
    with nd.enableX64(True):
        yield


def close(got, want, rel, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rel * scale, f"{what}: max |err| {err:.3e} > {rel} x {scale:.3e}"


def _tree(rng, scale=1.0):
    return [{"W": (rng.standard_normal((4, 3)) * scale).astype(np.float32),
             "b": (rng.standard_normal(3) * scale).astype(np.float32)},
            {},
            {"fwd": {"RW": (rng.standard_normal((2, 2)) * scale).astype(np.float32)},
             "bwd": {"RW": (rng.standard_normal((2, 2)) * scale).astype(np.float32)}}]


def _updater(name, schedule):
    lr = {}
    if schedule and name not in ("AdaDelta", "NoOp"):
        lr = {"lr": dict(initialValue=0.05, gamma=0.8)}
    elif name not in ("AdaDelta", "NoOp"):
        lr = {"lr": 0.05}
    def make(mod, sched_mod):
        kw = dict(lr)
        if isinstance(kw.get("lr"), dict):
            kw["lr"] = sched_mod.ExponentialSchedule(**kw["lr"])
        return getattr(mod, name)(**kw)
    return make(jupd, jsched), make(pupd, psched)


UPDATERS = sorted(jupd._ALL)


@pytest.mark.parametrize("schedule", [False, True], ids=["float_lr", "schedule"])
@pytest.mark.parametrize("name", UPDATERS)
def test_updater_ten_steps_against_optax(name, schedule):
    ju, pu = _updater(name, schedule)
    assert pu.to_dict() == ju.to_dict()
    assert pupd.from_dict(ju.to_dict()) == pu
    rng = np.random.default_rng(4)
    params = _tree(rng)
    jtx, ptx = ju.to_optax(), pu.to_transform()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    pp = tree_map(torch.tensor, params)
    js, ps = jtx.init(jp), ptx.init(pp)
    for step in range(STEPS):
        g = _tree(rng, scale=0.5)
        ju_, js = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        pu_, ps = ptx.update(tree_map(torch.tensor, g), ps, pp)
        jp = optax.apply_updates(jp, ju_)
        pp = pupd.apply_updates(pp, pu_)
        for a, b in zip(tree_leaves(pu_), jax.tree_util.tree_leaves(ju_)):
            close(a.numpy(), b, UPD_REL, f"{name} step {step} update")
        for a, b in zip(tree_leaves(pp), jax.tree_util.tree_leaves(jp)):
            close(a.numpy(), b, UPD_REL, f"{name} step {step} params")
        sl, jl = tree_leaves(ps), jax.tree_util.tree_leaves(js)
        assert len(sl) == len(jl), f"{name}: {len(sl)} state leaves, optax {len(jl)}"
        for i, (a, b) in enumerate(zip(sl, jl)):
            b = np.asarray(b)
            assert a.numpy().dtype == b.dtype, (name, i, a.dtype, b.dtype)
            if b.dtype.kind == "i":
                np.testing.assert_array_equal(a.numpy(), b)
            else:
                close(a.numpy(), b, UPD_REL, f"{name} step {step} state leaf {i}")


def test_tree_unflatten_inverts_leaves():
    rng = np.random.default_rng(0)
    tree = tree_map(torch.tensor, _tree(rng))
    state = pupd.Adam(0.1).to_transform().init(tree)
    leaves = tree_leaves(state)
    back = pupd.tree_unflatten(state, [l + 1 for l in leaves])
    assert type(back[0]) is type(state[0])
    for a, b in zip(tree_leaves(back), leaves):
        assert torch.equal(a, b + 1)
    with pytest.raises(ValueError, match="more leaves"):
        pupd.tree_unflatten(state, leaves + [leaves[0]])


SCHEDULES = [
    ("FixedSchedule", dict(value=0.3)),
    ("StepSchedule", dict(initialValue=0.2, decayRate=0.7, step=4)),
    ("ExponentialSchedule", dict(initialValue=0.1, gamma=0.93)),
    ("InverseSchedule", dict(initialValue=0.1, gamma=0.2, power=1.5)),
    ("PolySchedule", dict(initialValue=0.1, power=2.0, maxIter=30)),
    ("SigmoidSchedule", dict(initialValue=0.1, gamma=0.5, stepSize=12)),
    ("MapSchedule", dict(values={0: 0.1, 5: 0.05, 17: 0.01})),
    ("WarmupLinearDecaySchedule", dict(peakValue=1e-3, warmupSteps=7, totalSteps=30)),
    ("ExponentialSchedule", dict(initialValue=0.1, gamma=0.9, scheduleType="EPOCH")),
]


@pytest.mark.parametrize("name,kw", SCHEDULES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(SCHEDULES)])
def test_schedule_values(name, kw):
    j = getattr(jsched, name)(**kw)
    p = getattr(psched, name)(**kw)
    assert p.to_dict() == j.to_dict()
    jf, pf = j.to_fn(iterations_per_epoch=3), p.to_fn(iterations_per_epoch=3)
    for t in range(41):
        want = float(np.asarray(jf(jnp.asarray(t, jnp.int32))))
        assert float(pf(t)) == pytest.approx(want, rel=1.2e-7, abs=1e-15), (name, t)
    assert psched.from_dict(j.to_dict()) == p


LOSSES = sorted(jloss._LOSSES)


def _loss_inputs(name, rng, shape):
    if name == "SPARSE_MCXENT":
        labels = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
        preds = rng.standard_normal(shape).astype(np.float32)
    elif name in ("MCXENT", "NEGATIVELOGLIKELIHOOD", "KL_DIVERGENCE"):
        labels = np.eye(shape[-1], dtype=np.float32)[rng.integers(0, shape[-1], shape[:-1])]
        logits = rng.standard_normal(shape)
        preds = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    elif name in ("XENT", "RECONSTRUCTION_CROSSENTROPY"):
        labels = (rng.random(shape) > 0.5).astype(np.float32)
        preds = rng.uniform(0.05, 0.95, shape).astype(np.float32)
    elif name in ("HINGE", "SQUARED_HINGE"):
        labels = np.where(rng.random(shape) > 0.5, 1.0, -1.0).astype(np.float32)
        preds = rng.standard_normal(shape).astype(np.float32)
    elif name == "POISSON":
        labels = rng.poisson(2.0, shape).astype(np.float32)
        preds = rng.uniform(0.5, 3.0, shape).astype(np.float32)
    else:
        labels = rng.standard_normal(shape).astype(np.float32)
        preds = rng.standard_normal(shape).astype(np.float32)
    return labels, preds


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("name", LOSSES)
def test_loss_and_gradient(name, masked):
    rng = np.random.default_rng(6)
    shape = (3, 5, 4)
    labels, preds = _loss_inputs(name, rng, shape)
    mask = (rng.random(shape[:2]) > 0.3).astype(np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    jv, jg = jax.value_and_grad(lambda p: jloss.get(name)(jnp.asarray(labels), p, jm))(
        jnp.asarray(preds))
    pt = torch.tensor(preds, requires_grad=True)
    pv = ploss.get(name)(torch.tensor(labels), pt,
                         None if mask is None else torch.tensor(mask))
    (pg,) = torch.autograd.grad(pv, pt)
    close(pv.detach().numpy(), jv, 1e-6, f"{name} loss")
    close(pg.numpy(), jg, 1e-5, f"{name} gradient")


def test_loss_aliases_and_refusal():
    for alias in ("KLD", "MAE", "MAPE", "MSLE", "mse"):
        assert ploss.get(alias).__name__ == jloss.get(alias).__name__
    assert ploss.names() == jloss.names()
    with pytest.raises(ValueError, match="unknown loss"):
        ploss.get("NOPE")


@pytest.mark.parametrize("name", jact.names())
def test_activation_and_gradient(name):
    x = np.linspace(-4.0, 4.0, 48).astype(np.float32).reshape(4, 12) + 0.013
    jv, vjp = jax.vjp(jact.get(name), jnp.asarray(x))
    ct = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
    (jg,) = vjp(jnp.asarray(ct))
    xt = torch.tensor(x, requires_grad=True)
    pv = pact.get(name)(xt)
    (pg,) = torch.autograd.grad(pv, xt, torch.tensor(ct))
    close(pv.detach().numpy(), jv, 1e-6, f"{name}")
    close(pg.numpy(), jg, 1e-5, f"{name} gradient")


def test_activation_names_and_refusal():
    assert pact.names() == jact.names()
    with pytest.raises(ValueError, match="unknown activation"):
        pact.get("NOPE")


@pytest.mark.parametrize("name,kw", [("L1", dict(l1=0.01)), ("L2", dict(l2=0.02)),
                                     ("WeightDecay", dict(coeff=0.03))])
def test_regularization(name, kw):
    w = np.random.default_rng(2).standard_normal((5, 4)).astype(np.float32)
    j, p = getattr(jreg, name)(**kw), getattr(preg, name)(**kw)
    assert p.to_dict() == j.to_dict() and preg.from_dict(j.to_dict()) == p
    jv, jg = jax.value_and_grad(j.penalty)(jnp.asarray(w))
    wt = torch.tensor(w, requires_grad=True)
    pv = p.penalty(wt)
    (pg,) = torch.autograd.grad(pv, wt)
    close(pv.detach().numpy(), jv, 1e-6, name)
    close(pg.numpy(), jg, 1e-6, f"{name} gradient")
