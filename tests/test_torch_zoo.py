"""The port's model zoo (``deeplearning4j_tpu_torch/zoo``) held against
the JAX package's on the CPU.

Every one of the 16 architectures at a reduced input size (the sizes of
``tests/test_zoo.py`` where it has them; UNet, InceptionResNetV1,
NASNetMobile and TextGenerationLSTM cut by their own constructor knobs):
both packages build the same configuration (the same JSON string), the
port's seeded ``init()`` parameters and state are carried into the
reference's network, and one ``output`` at B=2 of both is within 1e-5 of
the reference's largest |value| (fp32, inference mode; the port's
outputs with its 64-bit switch on, as the suite runs the reference).
``initPretrained``
from a seeded cache: a ``ModelSerializer`` zip the reference wrote, a
Keras-layout ``.h5`` sibling (written with ``h5py``: the ``model_config``
attribute and ``model_weights/<layer>/`` groups), a registered fetch hook,
a missing artifact naming the path to seed, and a bad checksum that
raises and keeps the seeded file — each as the reference does it.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.zoo as RZ
import deeplearning4j_tpu_torch.zoo as PZ
from deeplearning4j_tpu.nn.computation_graph import ComputationGraph as RGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as RNetwork
from deeplearning4j_tpu.util.model_serializer import ModelSerializer as RSerializer
from deeplearning4j_tpu.util.resources import Resources as RResources
from deeplearning4j_tpu_torch import nd
from deeplearning4j_tpu_torch.nn import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.train.updaters import tree_map
from deeplearning4j_tpu_torch.util.resources import Resources, sha256_of
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5


CASES = {
    "LeNet": dict(numClasses=10, inputShape=(1, 28, 28)),
    "SimpleCNN": dict(numClasses=5, inputShape=(3, 32, 32)),
    "AlexNet": dict(numClasses=7, inputShape=(3, 80, 80)),
    "VGG16": dict(numClasses=5, inputShape=(3, 32, 32)),
    "VGG19": dict(numClasses=5, inputShape=(3, 32, 32)),
    "ResNet50": dict(numClasses=6, inputShape=(3, 64, 64)),
    "SqueezeNet": dict(numClasses=6, inputShape=(3, 64, 64)),
    "Darknet19": dict(numClasses=5, inputShape=(3, 64, 64)),
    "UNet": dict(inputShape=(3, 32, 32), depth=2, baseFilters=4),
    "Xception": dict(numClasses=6, inputShape=(3, 64, 64)),
    "TextGenerationLSTM": dict(totalUniqueCharacters=12, lstmLayerSize=16),
    "TinyYOLO": dict(numClasses=3, inputShape=(3, 64, 64)),
    "YOLO2": dict(numClasses=3, inputShape=(3, 64, 64)),
    "InceptionResNetV1": dict(numClasses=4, inputShape=(3, 96, 96), blocks=(1, 1, 1)),
    "FaceNetNN4Small2": dict(numClasses=5, inputShape=(3, 64, 64)),
    "NASNetMobile": dict(numClasses=3, inputShape=(3, 64, 64), cells_per_stage=1, filters=16),
}


def test_zoo_exports_every_architecture():
    assert PZ.__all__ == RZ.__all__
    assert sorted(CASES) == sorted(RZ.__all__[1:])


def _input(name, model, rng):
    if name == "TextGenerationLSTM":
        return rng.normal(size=(2, 20, 12)).astype(np.float32)
    return rng.normal(size=(2,) + tuple(model.inputShape)).astype(np.float32)


def _carried(net, rm, updater=False):
    """The reference's network for zoo model ``rm`` holding the port
    network's parameters and state (and, with ``updater``, its updater's
    initial state). The reference's own seeded init draws with jax.random,
    which the port's network tests hold it to; here the two forwards start
    from one set of values."""
    ref = (RGraph if isinstance(net.conf, ComputationGraphConfiguration) else RNetwork)(
        rm.conf())
    ref._params = tree_map(lambda t: jnp.asarray(t.numpy()), net._params)
    ref._state = tree_map(lambda t: jnp.asarray(t.numpy()), net._state)
    if updater:
        ref._tx = ref.conf.updater.to_optax()
        ref._opt_state = ref._tx.init(ref._params)
    return ref


@pytest.mark.parametrize("name", list(CASES))
def test_architecture_matches_reference(name):
    kw = CASES[name]
    pm, rm = getattr(PZ, name)(**kw), getattr(RZ, name)(**kw)
    conf = pm.conf()
    assert conf.to_json() == rm.conf().to_json()
    net = pm.init(device="cpu")
    graph = isinstance(conf, ComputationGraphConfiguration)
    ref = _carried(net, rm)
    x = _input(name, pm, np.random.default_rng(0))
    with nd.enableX64(True):
        got = (net.outputSingle(x) if graph else net.output(x)).toNumpy()
    want = np.asarray((ref.outputSingle(x) if graph else ref.output(x)).toNumpy())
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max())


def test_init_needs_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PZ.LeNet().init()


def _keras_h5(path, rng):
    """A Keras-3-layout Sequential h5 written with h5py: Dense(5, relu) ->
    Dense(3, softmax) over 4 features."""
    import h5py

    layers = [{"class_name": "InputLayer", "config": {"batch_shape": [None, 4],
                                                      "name": "input_layer"}},
              {"class_name": "Dense", "config": {"name": "dense", "units": 5,
                                                 "activation": "relu", "use_bias": True}},
              {"class_name": "Dense", "config": {"name": "dense_1", "units": 3,
                                                 "activation": "softmax",
                                                 "use_bias": True}}]
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps({"class_name": "Sequential",
                                              "config": {"name": "seq", "layers": layers}})
        mw = f.create_group("model_weights")
        for name, shape in (("dense", (4, 5)), ("dense_1", (5, 3))):
            g = mw.create_group(name).create_group("sequential").create_group(name)
            g["kernel"] = rng.normal(size=shape).astype(np.float32)
            g["bias"] = rng.normal(size=shape[1:]).astype(np.float32)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4JTPU_RESOURCES_CACHE_DIR", str(tmp_path))
    yield tmp_path
    Resources.registerFetchHook(None)
    RResources.registerFetchHook(None)


def _same_net(port, ref, x):
    np.testing.assert_array_equal(port.params().toNumpy(), np.asarray(ref.params().toNumpy()))
    np.testing.assert_allclose(port.output(x).toNumpy(), np.asarray(ref.output(x).toNumpy()),
                               atol=TOL)


def test_init_pretrained_zip_from_reference(cache):
    """A zip the reference's ModelSerializer wrote into the cache loads
    through the port's zoo with the reference's parameters and outputs,
    with and without its checksum."""
    rzoo, pzoo = RZ.LeNet(), PZ.LeNet()
    with pytest.raises(FileNotFoundError, match="seed"):
        pzoo.initPretrained("MNIST", device="cpu")
    assert not pzoo.pretrainedAvailable("MNIST")
    net = _carried(pzoo.init(device="cpu"), rzoo, updater=True)
    dest = cache / rzoo.pretrainedResourceName("MNIST")
    assert pzoo.pretrainedResourceName("MNIST") == rzoo.pretrainedResourceName("MNIST")
    dest.parent.mkdir(parents=True)
    RSerializer.writeModel(net, str(dest), saveUpdater=False)
    assert pzoo.pretrainedAvailable("MNIST")
    x = np.random.default_rng(1).normal(size=(2, 1, 28, 28)).astype(np.float32)
    want = rzoo.initPretrained("MNIST", sha256=sha256_of(str(dest)))
    with nd.enableX64(True):
        for sha in (None, sha256_of(str(dest))):
            _same_net(pzoo.initPretrained("MNIST", sha256=sha, device="cpu"), want, x)


def test_init_pretrained_h5_sibling(cache):
    """With no zip, the ``.h5`` sibling is read through the Keras importer
    (routed by its ``model_config`` class) in both packages, with and
    without its checksum."""
    rng = np.random.default_rng(2)
    h5 = cache / (PZ.SimpleCNN().pretrainedResourceName("CIFAR10").removesuffix(".zip") + ".h5")
    h5.parent.mkdir(parents=True)
    _keras_h5(h5, rng)
    assert PZ.SimpleCNN().pretrainedAvailable("CIFAR10")
    x = rng.normal(size=(3, 4)).astype(np.float32)
    want = RZ.SimpleCNN().initPretrained("CIFAR10")
    with nd.enableX64(True):
        for sha in (None, sha256_of(str(h5))):
            got = PZ.SimpleCNN().initPretrained("CIFAR10", sha256=sha, device="cpu")
            assert type(got).__name__ == type(want).__name__ == "MultiLayerNetwork"
            _same_net(got, want, x)


def test_init_pretrained_through_fetch_hook(cache, tmp_path_factory):
    """Nothing cached: a registered fetch hook is asked for the zip, its
    file lands in the cache, and the network loads from it."""
    src = tmp_path_factory.mktemp("source") / "lenet.zip"
    RSerializer.writeModel(_carried(PZ.LeNet().init(device="cpu"), RZ.LeNet(), updater=True),
                           str(src), saveUpdater=False)
    name = PZ.LeNet().pretrainedResourceName("MNIST")
    asked = []

    def hook(resource, dest):
        asked.append(resource)
        dest.write_bytes(src.read_bytes())

    Resources.registerFetchHook(hook)
    assert PZ.LeNet().pretrainedAvailable("MNIST")
    with nd.enableX64(True):
        got = PZ.LeNet().initPretrained("MNIST", device="cpu")
    assert asked == [name] and (cache / name).exists()
    x = np.random.default_rng(3).normal(size=(2, 1, 28, 28)).astype(np.float32)
    with nd.enableX64(True):
        _same_net(got, RZ.LeNet().initPretrained("MNIST"), x)


def test_init_pretrained_bad_checksum_keeps_seed(cache):
    zoo = PZ.LeNet()
    net = _carried(zoo.init(device="cpu"), RZ.LeNet(), updater=True)
    dest = cache / zoo.pretrainedResourceName("MNIST")
    dest.parent.mkdir(parents=True)
    RSerializer.writeModel(net, str(dest), saveUpdater=False)
    for z, kw in ((zoo, {"device": "cpu"}), (RZ.LeNet(), {})):
        with pytest.raises(IOError, match="checksum"):
            z.initPretrained("MNIST", sha256="0" * 64, **kw)
        assert dest.exists()
