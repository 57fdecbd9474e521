"""Reference architectures (counterpart: ``deeplearning4j_tpu/zoo/models.py``;
ref: deeplearning4j-zoo/src/main/java/org/
deeplearning4j/zoo/model/ — LeNet, SimpleCNN, AlexNet, VGG16/19, ResNet50,
SqueezeNet, Darknet19, UNet, Xception, TextGenerationLSTM).

Each model is a config builder over the nn DSL, exactly as the reference's
ZooModel.conf() methods build MultiLayerConfiguration/
ComputationGraphConfiguration. Pretrained weights load through the
Resources cache resolver (ZooModel.initPretrained): local-first (seed
~/.deeplearning4j_tpu/resources/zoo/) with checksum verification, plus a
pluggable fetch hook for networked environments; nothing here downloads.
Networks are built on ``device`` (default ``"cuda"``)."""
from __future__ import annotations

from typing import Optional, Tuple

from deeplearning4j_tpu_torch.nn import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.computation_graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.conf.graph import ElementWiseVertex, MergeVertex
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer, BatchNormalization, ConvolutionLayer, DenseLayer,
    DropoutLayer, Deconvolution2D, GlobalPoolingLayer, LSTM, LocalResponseNormalization,
    OutputLayer, RnnOutputLayer, SeparableConvolution2D, SubsamplingLayer,
    ZeroPaddingLayer)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.train.updaters import AdaDelta, Adam, Nesterovs


class ZooModel:
    """(ref: org.deeplearning4j.zoo.ZooModel)."""
    numClasses: int
    seed: int
    inputShape: Tuple[int, int, int]

    def __init__(self, numClasses: int = 1000, seed: int = 123,
                 inputShape: Tuple[int, int, int] = (3, 224, 224)):
        self.numClasses = numClasses
        self.seed = seed
        self.inputShape = inputShape

    def conf(self):
        raise NotImplementedError

    def init(self, device=None):
        """Build + initialize the network on ``device`` (ref: ZooModel.init)."""
        c = self.conf()
        from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
        if isinstance(c, MultiLayerConfiguration):
            return MultiLayerNetwork(c, device=device).init()
        return ComputationGraph(c, device=device).init()

    def pretrainedResourceName(self, pretrained_type: str = "IMAGENET") -> str:
        """Cache-relative resource name for this model's weights
        (ref: ZooModel.pretrainedUrl — here a Resources cache key)."""
        return f"zoo/{type(self).__name__.lower()}_{pretrained_type.lower()}.zip"

    def pretrainedAvailable(self, pretrained_type: str = "IMAGENET") -> bool:
        """True when weights are loadable: cached (zip or .h5 sibling), or
        fetchable via a registered hook (ref: ZooModel.pretrainedUrl != null)."""
        from deeplearning4j_tpu_torch.util.resources import Resources
        name = self.pretrainedResourceName(pretrained_type)
        return (Resources.exists(name)
                or Resources.exists(name.removesuffix(".zip") + ".h5")
                or Resources._fetch_hook is not None)

    def initPretrained(self, pretrained_type: str = "IMAGENET",
                       sha256: Optional[str] = None, device=None):
        """Load pretrained weights through the Resources resolver
        (ref: ZooModel.initPretrained — download + cache + checksum; here
        the cache is local-first and the download is a pluggable fetch
        hook). The network lands on ``device``. The cached artifact is a
        ModelSerializer zip, or a Keras .h5 sibling routed by the h5's own
        model_config class. ``sha256`` applies to whichever artifact is
        picked; a mismatch raises without deleting the seeded file."""
        from deeplearning4j_tpu_torch.util.resources import Resources
        name = self.pretrainedResourceName(pretrained_type)
        h5 = name.removesuffix(".zip") + ".h5"
        picked = name if (Resources.exists(name)
                          or not Resources.exists(h5)) else h5
        try:
            path = Resources.asFile(picked, sha256=sha256,
                                    evictOnMismatch=False)
        except FileNotFoundError:
            raise FileNotFoundError(
                f"no cached weights for {type(self).__name__} "
                f"({pretrained_type}): seed {Resources.cacheDir() / name} "
                "(ModelSerializer zip) or the .h5 sibling (Keras), or "
                "registerFetchHook for networked environments "
                "(ref: ZooModel.initPretrained)") from None
        if str(path).endswith(".h5"):
            import h5py
            import json as _json
            from deeplearning4j_tpu_torch.modelimport.keras import KerasModelImport
            with h5py.File(str(path), "r") as f:
                cls = _json.loads(f.attrs["model_config"])["class_name"]
            if cls == "Sequential":
                return KerasModelImport.importKerasSequentialModelAndWeights(
                    str(path), device=device)
            return KerasModelImport.importKerasModelAndWeights(str(path), device=device)
        from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer
        return ModelSerializer.restoreModel(str(path), device=device)


class LeNet(ZooModel):
    """(ref: zoo.model.LeNet — BASELINE config #1)."""

    def __init__(self, numClasses: int = 10, seed: int = 123,
                 inputShape: Tuple[int, int, int] = (1, 28, 28)):
        super().__init__(numClasses, seed, inputShape)

    def conf(self):
        c, h, w = self.inputShape
        return (NeuralNetConfiguration.Builder().seed(self.seed)
                .updater(Adam(1e-3)).weightInit("XAVIER")
                .list()
                .layer(ConvolutionLayer(nOut=20, kernelSize=(5, 5), stride=(1, 1),
                                        convolutionMode="Same", activation="IDENTITY"))
                .layer(SubsamplingLayer(poolingType="MAX", kernelSize=(2, 2), stride=(2, 2)))
                .layer(ConvolutionLayer(nOut=50, kernelSize=(5, 5), stride=(1, 1),
                                        convolutionMode="Same", activation="IDENTITY"))
                .layer(SubsamplingLayer(poolingType="MAX", kernelSize=(2, 2), stride=(2, 2)))
                .layer(DenseLayer(nOut=500, activation="RELU"))
                .layer(OutputLayer(nOut=self.numClasses, activation="SOFTMAX",
                                   lossFunction="MCXENT"))
                .setInputType(InputType.convolutional(h, w, c))
                .build())


class SimpleCNN(ZooModel):
    """(ref: zoo.model.SimpleCNN)."""

    def __init__(self, numClasses: int = 10, seed: int = 123,
                 inputShape: Tuple[int, int, int] = (3, 48, 48)):
        super().__init__(numClasses, seed, inputShape)

    def conf(self):
        c, h, w = self.inputShape
        b = (NeuralNetConfiguration.Builder().seed(self.seed)
             .updater(AdaDelta()).activation("RELU").weightInit("XAVIER")
             .list())
        for n_out in (96, 96, 192, 192):
            b = b.layer(ConvolutionLayer(nOut=n_out, kernelSize=(3, 3),
                                         convolutionMode="Same", activation="IDENTITY"))
            b = b.layer(BatchNormalization())
            b = b.layer(ActivationLayer(activation="RELU"))
        b = (b.layer(SubsamplingLayer(poolingType="MAX", kernelSize=(2, 2), stride=(2, 2)))
             .layer(DropoutLayer(dropOut=0.5))
             .layer(GlobalPoolingLayer(poolingType="AVG"))
             .layer(OutputLayer(nOut=self.numClasses, activation="SOFTMAX",
                                lossFunction="MCXENT")))
        return b.setInputType(InputType.convolutional(h, w, c)).build()


class AlexNet(ZooModel):
    """(ref: zoo.model.AlexNet — one-tower variant)."""

    def conf(self):
        c, h, w = self.inputShape
        return (NeuralNetConfiguration.Builder().seed(self.seed)
                .updater(Nesterovs(1e-2, 0.9)).weightInit("NORMAL")
                .list()
                .layer(ConvolutionLayer(nOut=96, kernelSize=(11, 11), stride=(4, 4),
                                        activation="RELU"))
                .layer(LocalResponseNormalization())
                .layer(SubsamplingLayer(poolingType="MAX", kernelSize=(3, 3), stride=(2, 2)))
                .layer(ConvolutionLayer(nOut=256, kernelSize=(5, 5), convolutionMode="Same",
                                        activation="RELU", biasInit=1.0))
                .layer(LocalResponseNormalization())
                .layer(SubsamplingLayer(poolingType="MAX", kernelSize=(3, 3), stride=(2, 2)))
                .layer(ConvolutionLayer(nOut=384, kernelSize=(3, 3), convolutionMode="Same",
                                        activation="RELU"))
                .layer(ConvolutionLayer(nOut=384, kernelSize=(3, 3), convolutionMode="Same",
                                        activation="RELU", biasInit=1.0))
                .layer(ConvolutionLayer(nOut=256, kernelSize=(3, 3), convolutionMode="Same",
                                        activation="RELU", biasInit=1.0))
                .layer(SubsamplingLayer(poolingType="MAX", kernelSize=(3, 3), stride=(2, 2)))
                .layer(DenseLayer(nOut=4096, activation="RELU", dropOut=0.5, biasInit=1.0))
                .layer(DenseLayer(nOut=4096, activation="RELU", dropOut=0.5, biasInit=1.0))
                .layer(OutputLayer(nOut=self.numClasses, activation="SOFTMAX",
                                   lossFunction="MCXENT"))
                .setInputType(InputType.convolutional(h, w, c))
                .build())


def _vgg_blocks(b, spec):
    for n_convs, n_out in spec:
        for _ in range(n_convs):
            b = b.layer(ConvolutionLayer(nOut=n_out, kernelSize=(3, 3),
                                         convolutionMode="Same", activation="RELU"))
        b = b.layer(SubsamplingLayer(poolingType="MAX", kernelSize=(2, 2), stride=(2, 2)))
    return b


class VGG16(ZooModel):
    """(ref: zoo.model.VGG16)."""

    _spec = [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]

    def conf(self):
        c, h, w = self.inputShape
        b = (NeuralNetConfiguration.Builder().seed(self.seed)
             .updater(Nesterovs(1e-2, 0.9)).weightInit("XAVIER").list())
        b = _vgg_blocks(b, self._spec)
        return (b.layer(DenseLayer(nOut=4096, activation="RELU", dropOut=0.5))
                .layer(DenseLayer(nOut=4096, activation="RELU", dropOut=0.5))
                .layer(OutputLayer(nOut=self.numClasses, activation="SOFTMAX",
                                   lossFunction="MCXENT"))
                .setInputType(InputType.convolutional(h, w, c))
                .build())


class VGG19(VGG16):
    """(ref: zoo.model.VGG19)."""
    _spec = [(2, 64), (2, 128), (4, 256), (4, 512), (4, 512)]


class ResNet50(ZooModel):
    """(ref: zoo.model.ResNet50 — BASELINE config #2). Bottleneck residual
    blocks over ComputationGraph with ElementWiseVertex(Add) shortcuts."""

    def conf(self):
        c, h, w = self.inputShape
        g = (NeuralNetConfiguration.Builder().seed(self.seed)
             .updater(Adam(1e-3)).weightInit("RELU")  # he-style
             .graphBuilder()
             .addInputs("input")
             .setInputTypes(InputType.convolutional(h, w, c)))
        g.addLayer("stem_conv", ConvolutionLayer(nOut=64, kernelSize=(7, 7), stride=(2, 2),
                                                 convolutionMode="Same",
                                                 activation="IDENTITY"), "input")
        g.addLayer("stem_bn", BatchNormalization(activation="RELU"), "stem_conv")
        g.addLayer("stem_pool", SubsamplingLayer(poolingType="MAX", kernelSize=(3, 3),
                                                 stride=(2, 2), convolutionMode="Same"),
                   "stem_bn")
        prev = "stem_pool"
        stages = [(3, 64, 256, 1), (4, 128, 512, 2), (6, 256, 1024, 2), (3, 512, 2048, 2)]
        for si, (blocks, mid, out, first_stride) in enumerate(stages):
            for bi in range(blocks):
                stride = first_stride if bi == 0 else 1
                name = f"s{si}b{bi}"
                g.addLayer(f"{name}_c1", ConvolutionLayer(nOut=mid, kernelSize=(1, 1),
                                                          stride=(stride, stride),
                                                          activation="IDENTITY"), prev)
                g.addLayer(f"{name}_bn1", BatchNormalization(activation="RELU"), f"{name}_c1")
                g.addLayer(f"{name}_c2", ConvolutionLayer(nOut=mid, kernelSize=(3, 3),
                                                          convolutionMode="Same",
                                                          activation="IDENTITY"), f"{name}_bn1")
                g.addLayer(f"{name}_bn2", BatchNormalization(activation="RELU"), f"{name}_c2")
                g.addLayer(f"{name}_c3", ConvolutionLayer(nOut=out, kernelSize=(1, 1),
                                                          activation="IDENTITY"), f"{name}_bn2")
                g.addLayer(f"{name}_bn3", BatchNormalization(activation="IDENTITY"), f"{name}_c3")
                if bi == 0:
                    g.addLayer(f"{name}_sc", ConvolutionLayer(nOut=out, kernelSize=(1, 1),
                                                              stride=(stride, stride),
                                                              activation="IDENTITY"), prev)
                    g.addLayer(f"{name}_scbn", BatchNormalization(activation="IDENTITY"),
                               f"{name}_sc")
                    shortcut = f"{name}_scbn"
                else:
                    shortcut = prev
                g.addVertex(f"{name}_add", ElementWiseVertex(op="Add"),
                            f"{name}_bn3", shortcut)
                g.addLayer(f"{name}_relu", ActivationLayer(activation="RELU"), f"{name}_add")
                prev = f"{name}_relu"
        g.addLayer("avgpool", GlobalPoolingLayer(poolingType="AVG"), prev)
        g.addLayer("output", OutputLayer(nOut=self.numClasses, activation="SOFTMAX",
                                         lossFunction="MCXENT"), "avgpool")
        g.setOutputs("output")
        return g.build()


class SqueezeNet(ZooModel):
    """(ref: zoo.model.SqueezeNet — fire modules: squeeze 1x1 -> expand 1x1|3x3)."""

    def conf(self):
        c, h, w = self.inputShape
        g = (NeuralNetConfiguration.Builder().seed(self.seed)
             .updater(Adam(1e-3)).weightInit("XAVIER")
             .graphBuilder()
             .addInputs("input")
             .setInputTypes(InputType.convolutional(h, w, c)))
        g.addLayer("conv1", ConvolutionLayer(nOut=64, kernelSize=(3, 3), stride=(2, 2),
                                             convolutionMode="Same", activation="RELU"),
                   "input")
        g.addLayer("pool1", SubsamplingLayer(poolingType="MAX", kernelSize=(3, 3),
                                             stride=(2, 2), convolutionMode="Same"), "conv1")
        prev = "pool1"
        fires = [(16, 64), (16, 64), (32, 128), (32, 128),
                 (48, 192), (48, 192), (64, 256), (64, 256)]
        for i, (sq, ex) in enumerate(fires):
            n = f"fire{i + 2}"
            g.addLayer(f"{n}_sq", ConvolutionLayer(nOut=sq, kernelSize=(1, 1),
                                                   activation="RELU"), prev)
            g.addLayer(f"{n}_e1", ConvolutionLayer(nOut=ex, kernelSize=(1, 1),
                                                   activation="RELU"), f"{n}_sq")
            g.addLayer(f"{n}_e3", ConvolutionLayer(nOut=ex, kernelSize=(3, 3),
                                                   convolutionMode="Same",
                                                   activation="RELU"), f"{n}_sq")
            g.addVertex(f"{n}_cat", MergeVertex(), f"{n}_e1", f"{n}_e3")
            prev = f"{n}_cat"
            if i in (2, 6):
                g.addLayer(f"pool{i}", SubsamplingLayer(poolingType="MAX", kernelSize=(3, 3),
                                                        stride=(2, 2), convolutionMode="Same"),
                           prev)
                prev = f"pool{i}"
        g.addLayer("drop", DropoutLayer(dropOut=0.5), prev)
        g.addLayer("conv10", ConvolutionLayer(nOut=self.numClasses, kernelSize=(1, 1),
                                              activation="RELU"), "drop")
        g.addLayer("gap", GlobalPoolingLayer(poolingType="AVG"), "conv10")
        g.addLayer("output", OutputLayer(nIn=self.numClasses, nOut=self.numClasses,
                                         activation="SOFTMAX", lossFunction="MCXENT"), "gap")
        g.setOutputs("output")
        return g.build()


class Darknet19(ZooModel):
    """(ref: zoo.model.Darknet19)."""

    def conf(self):
        c, h, w = self.inputShape
        b = (NeuralNetConfiguration.Builder().seed(self.seed)
             .updater(Nesterovs(1e-3, 0.9)).weightInit("XAVIER").list())

        def conv_bn(b, n_out, k):
            return (b.layer(ConvolutionLayer(nOut=n_out, kernelSize=(k, k),
                                             convolutionMode="Same", hasBias=False,
                                             activation="IDENTITY"))
                    .layer(BatchNormalization(activation="LEAKYRELU")))

        spec = [(32, 3, True), (64, 3, True),
                (128, 3, False), (64, 1, False), (128, 3, True),
                (256, 3, False), (128, 1, False), (256, 3, True),
                (512, 3, False), (256, 1, False), (512, 3, False), (256, 1, False),
                (512, 3, True),
                (1024, 3, False), (512, 1, False), (1024, 3, False), (512, 1, False),
                (1024, 3, False)]
        for n_out, k, pool in spec:
            b = conv_bn(b, n_out, k)
            if pool:
                b = b.layer(SubsamplingLayer(poolingType="MAX", kernelSize=(2, 2),
                                             stride=(2, 2)))
        return (b.layer(ConvolutionLayer(nOut=self.numClasses, kernelSize=(1, 1),
                                         activation="IDENTITY"))
                .layer(GlobalPoolingLayer(poolingType="AVG"))
                .layer(OutputLayer(nIn=self.numClasses, nOut=self.numClasses,
                                   activation="SOFTMAX", lossFunction="MCXENT"))
                .setInputType(InputType.convolutional(h, w, c))
                .build())


class UNet(ZooModel):
    """(ref: zoo.model.UNet — encoder/decoder with skip MergeVertex concat;
    sigmoid pixel output)."""

    def __init__(self, numClasses: int = 1, seed: int = 123,
                 inputShape: Tuple[int, int, int] = (3, 128, 128), depth: int = 4,
                 baseFilters: int = 16):
        super().__init__(numClasses, seed, inputShape)
        self.depth = depth
        self.baseFilters = baseFilters

    def conf(self):
        c, h, w = self.inputShape
        g = (NeuralNetConfiguration.Builder().seed(self.seed)
             .updater(Adam(1e-3)).weightInit("XAVIER")
             .graphBuilder()
             .addInputs("input")
             .setInputTypes(InputType.convolutional(h, w, c)))

        def double_conv(name, n_out, src):
            g.addLayer(f"{name}_c1", ConvolutionLayer(nOut=n_out, kernelSize=(3, 3),
                                                      convolutionMode="Same",
                                                      activation="RELU"), src)
            g.addLayer(f"{name}_c2", ConvolutionLayer(nOut=n_out, kernelSize=(3, 3),
                                                      convolutionMode="Same",
                                                      activation="RELU"), f"{name}_c1")
            return f"{name}_c2"

        skips = []
        prev = "input"
        f = self.baseFilters
        for d in range(self.depth):
            prev = double_conv(f"enc{d}", f * (2 ** d), prev)
            skips.append(prev)
            g.addLayer(f"down{d}", SubsamplingLayer(poolingType="MAX", kernelSize=(2, 2),
                                                    stride=(2, 2)), prev)
            prev = f"down{d}"
        prev = double_conv("bottleneck", f * (2 ** self.depth), prev)
        for d in reversed(range(self.depth)):
            g.addLayer(f"up{d}", Deconvolution2D(nOut=f * (2 ** d), kernelSize=(2, 2),
                                                 stride=(2, 2), convolutionMode="Same",
                                                 activation="RELU"), prev)
            g.addVertex(f"skip{d}", MergeVertex(), f"up{d}", skips[d])
            prev = double_conv(f"dec{d}", f * (2 ** d), f"skip{d}")
        g.addLayer("head", ConvolutionLayer(nOut=self.numClasses, kernelSize=(1, 1),
                                            activation="SIGMOID"), prev)
        from deeplearning4j_tpu_torch.nn.conf.layers import LossLayer
        g.addLayer("output", LossLayer(lossFunction="XENT"), "head")
        g.setOutputs("output")
        return g.build()


class Xception(ZooModel):
    """(ref: zoo.model.Xception — depthwise-separable conv towers with
    residual shortcuts; simplified to entry + 4 middle blocks + exit)."""

    def conf(self):
        c, h, w = self.inputShape
        g = (NeuralNetConfiguration.Builder().seed(self.seed)
             .updater(Adam(1e-3)).weightInit("XAVIER")
             .graphBuilder()
             .addInputs("input")
             .setInputTypes(InputType.convolutional(h, w, c)))
        g.addLayer("stem1", ConvolutionLayer(nOut=32, kernelSize=(3, 3), stride=(2, 2),
                                             convolutionMode="Same", hasBias=False,
                                             activation="IDENTITY"), "input")
        g.addLayer("stem1_bn", BatchNormalization(activation="RELU"), "stem1")
        g.addLayer("stem2", ConvolutionLayer(nOut=64, kernelSize=(3, 3),
                                             convolutionMode="Same", hasBias=False,
                                             activation="IDENTITY"), "stem1_bn")
        g.addLayer("stem2_bn", BatchNormalization(activation="RELU"), "stem2")
        prev = "stem2_bn"
        for i, n_out in enumerate((128, 256, 728)):
            n = f"entry{i}"
            g.addLayer(f"{n}_s1", SeparableConvolution2D(nOut=n_out, kernelSize=(3, 3),
                                                         convolutionMode="Same",
                                                         activation="RELU"), prev)
            g.addLayer(f"{n}_s2", SeparableConvolution2D(nOut=n_out, kernelSize=(3, 3),
                                                         convolutionMode="Same",
                                                         activation="IDENTITY"), f"{n}_s1")
            g.addLayer(f"{n}_pool", SubsamplingLayer(poolingType="MAX", kernelSize=(3, 3),
                                                     stride=(2, 2), convolutionMode="Same"),
                       f"{n}_s2")
            g.addLayer(f"{n}_sc", ConvolutionLayer(nOut=n_out, kernelSize=(1, 1),
                                                   stride=(2, 2), convolutionMode="Same",
                                                   activation="IDENTITY"), prev)
            g.addVertex(f"{n}_add", ElementWiseVertex(op="Add"), f"{n}_pool", f"{n}_sc")
            prev = f"{n}_add"
        for i in range(4):  # middle flow (reference has 8; 4 keeps tests fast)
            n = f"mid{i}"
            src = prev
            for j in range(3):
                g.addLayer(f"{n}_s{j}", SeparableConvolution2D(
                    nOut=728, kernelSize=(3, 3), convolutionMode="Same",
                    activation="RELU"), prev)
                prev = f"{n}_s{j}"
            g.addVertex(f"{n}_add", ElementWiseVertex(op="Add"), prev, src)
            prev = f"{n}_add"
        g.addLayer("exit_s1", SeparableConvolution2D(nOut=1024, kernelSize=(3, 3),
                                                     convolutionMode="Same",
                                                     activation="RELU"), prev)
        g.addLayer("gap", GlobalPoolingLayer(poolingType="AVG"), "exit_s1")
        g.addLayer("output", OutputLayer(nIn=1024, nOut=self.numClasses,
                                         activation="SOFTMAX", lossFunction="MCXENT"), "gap")
        g.setOutputs("output")
        return g.build()


class TextGenerationLSTM(ZooModel):
    """(ref: zoo.model.TextGenerationLSTM — the GravesLSTM char-RNN,
    BASELINE config #3)."""

    def __init__(self, totalUniqueCharacters: int = 47, seed: int = 123,
                 lstmLayerSize: int = 200):
        super().__init__(totalUniqueCharacters, seed, (0, 0, 0))
        self.lstmLayerSize = lstmLayerSize

    def conf(self):
        n = self.numClasses
        return (NeuralNetConfiguration.Builder().seed(self.seed)
                .updater(Adam(1e-3)).weightInit("XAVIER")
                .list()
                .layer(LSTM(nIn=n, nOut=self.lstmLayerSize, activation="TANH"))
                .layer(LSTM(nIn=self.lstmLayerSize, nOut=self.lstmLayerSize,
                            activation="TANH"))
                .layer(RnnOutputLayer(nIn=self.lstmLayerSize, nOut=n,
                                      activation="SOFTMAX", lossFunction="MCXENT"))
                .backpropType("TruncatedBPTT").tBPTTForwardLength(50)
                .tBPTTBackwardLength(50)
                .build())


class TinyYOLO(ZooModel):
    """(ref: zoo.model.TinyYOLO — Darknet-tiny backbone + Yolo2OutputLayer;
    default anchors from the VOC-trained reference config, grid units)."""

    DEFAULT_ANCHORS = ((1.08, 1.19), (3.42, 4.41), (6.63, 11.38),
                       (9.42, 5.11), (16.62, 10.52))

    def __init__(self, numClasses: int = 20, seed: int = 123,
                 inputShape: Tuple[int, int, int] = (3, 416, 416),
                 boundingBoxes=None):
        super().__init__(numClasses, seed, inputShape)
        self.boundingBoxes = tuple(boundingBoxes or self.DEFAULT_ANCHORS)

    def conf(self):
        from deeplearning4j_tpu_torch.nn.conf.layers import Yolo2OutputLayer
        c, h, w = self.inputShape
        b = (NeuralNetConfiguration.Builder().seed(self.seed)
             .updater(Adam(1e-3)).weightInit("XAVIER").list())

        def conv_bn(b, n_out):
            return (b.layer(ConvolutionLayer(nOut=n_out, kernelSize=(3, 3),
                                             convolutionMode="Same", hasBias=False,
                                             activation="IDENTITY"))
                    .layer(BatchNormalization(activation="LEAKYRELU")))

        for i, n_out in enumerate([16, 32, 64, 128, 256]):
            b = conv_bn(b, n_out)
            b = b.layer(SubsamplingLayer(poolingType="MAX", kernelSize=(2, 2),
                                         stride=(2, 2)))
        b = conv_bn(b, 512)
        b = b.layer(SubsamplingLayer(poolingType="MAX", kernelSize=(2, 2),
                                     stride=(1, 1), convolutionMode="Same"))
        b = conv_bn(b, 1024)
        A = len(self.boundingBoxes)
        return (b.layer(ConvolutionLayer(nOut=A * (5 + self.numClasses),
                                         kernelSize=(1, 1), activation="IDENTITY"))
                .layer(Yolo2OutputLayer(boundingBoxes=self.boundingBoxes))
                .setInputType(InputType.convolutional(h, w, c))
                .build())


class YOLO2(ZooModel):
    """(ref: zoo.model.YOLO2 — Darknet19 backbone + Yolo2OutputLayer).

    Deviation from the reference: the passthrough reorg (26x26 features
    SpaceToDepth'd and concatenated into the 13x13 head) needs a skip
    connection, which a sequential conf cannot express — this build is the
    straight-through backbone only. Use ``graph_conf()`` for the faithful
    passthrough variant."""

    def graph_conf(self):
        """ComputationGraph variant WITH the passthrough: conv13's 26x26x512
        features go through 1x1 conv(64) + SpaceToDepth(2) and merge into the
        13x13 head (the reference's reorg route)."""
        from deeplearning4j_tpu_torch.nn.conf.layers import SpaceToDepthLayer, Yolo2OutputLayer
        from deeplearning4j_tpu_torch.nn.conf.graph import MergeVertex
        c, h, w = self.inputShape
        g = (NeuralNetConfiguration.Builder().seed(self.seed)
             .updater(Adam(1e-3)).weightInit("XAVIER").graphBuilder()
             .addInputs("input")
             .setInputTypes(InputType.convolutional(h, w, c)))

        def conv_bn(name, n_out, k, frm):
            g.addLayer(f"{name}c", ConvolutionLayer(nOut=n_out, kernelSize=(k, k),
                                                    convolutionMode="Same", hasBias=False,
                                                    activation="IDENTITY"), frm)
            g.addLayer(name, BatchNormalization(activation="LEAKYRELU"), f"{name}c")
            return name

        spec = [(32, 3, True), (64, 3, True),
                (128, 3, False), (64, 1, False), (128, 3, True),
                (256, 3, False), (128, 1, False), (256, 3, True),
                (512, 3, False), (256, 1, False), (512, 3, False), (256, 1, False),
                (512, 3, True),
                (1024, 3, False), (512, 1, False), (1024, 3, False),
                (512, 1, False), (1024, 3, False),
                (1024, 3, False), (1024, 3, False)]
        prev, passthrough = "input", None
        for i, (n_out, k, pool) in enumerate(spec):
            prev = conv_bn(f"b{i}", n_out, k, prev)
            if i == 12:
                passthrough = prev  # conv13 output, 26x26x512, pre-pool
            if pool:
                g.addLayer(f"b{i}p", SubsamplingLayer(poolingType="MAX",
                                                      kernelSize=(2, 2), stride=(2, 2)),
                           prev)
                prev = f"b{i}p"
        pt = conv_bn("pt", 64, 1, passthrough)
        g.addLayer("pt_s2d", SpaceToDepthLayer(blockSize=2), pt)  # 13x13x256
        g.addVertex("cat", MergeVertex(), "pt_s2d", prev)
        head = conv_bn("head", 1024, 3, "cat")
        A = len(self.boundingBoxes)
        g.addLayer("det", ConvolutionLayer(nOut=A * (5 + self.numClasses),
                                           kernelSize=(1, 1), activation="IDENTITY"),
                   head)
        g.addLayer("output", Yolo2OutputLayer(boundingBoxes=self.boundingBoxes), "det")
        g.setOutputs("output")
        return g.build()

    DEFAULT_ANCHORS = ((0.57273, 0.677385), (1.87446, 2.06253),
                       (3.33843, 5.47434), (7.88282, 3.52778),
                       (9.77052, 9.16828))

    def __init__(self, numClasses: int = 80, seed: int = 123,
                 inputShape: Tuple[int, int, int] = (3, 608, 608),
                 boundingBoxes=None):
        super().__init__(numClasses, seed, inputShape)
        self.boundingBoxes = tuple(boundingBoxes or self.DEFAULT_ANCHORS)

    def conf(self):
        from deeplearning4j_tpu_torch.nn.conf.layers import Yolo2OutputLayer
        c, h, w = self.inputShape
        b = (NeuralNetConfiguration.Builder().seed(self.seed)
             .updater(Adam(1e-3)).weightInit("XAVIER").list())

        def conv_bn(b, n_out, k):
            return (b.layer(ConvolutionLayer(nOut=n_out, kernelSize=(k, k),
                                             convolutionMode="Same", hasBias=False,
                                             activation="IDENTITY"))
                    .layer(BatchNormalization(activation="LEAKYRELU")))

        spec = [(32, 3, True), (64, 3, True),
                (128, 3, False), (64, 1, False), (128, 3, True),
                (256, 3, False), (128, 1, False), (256, 3, True),
                (512, 3, False), (256, 1, False), (512, 3, False), (256, 1, False),
                (512, 3, True),
                (1024, 3, False), (512, 1, False), (1024, 3, False),
                (512, 1, False), (1024, 3, False),
                (1024, 3, False), (1024, 3, False)]
        for n_out, k, pool in spec:
            b = conv_bn(b, n_out, k)
            if pool:
                b = b.layer(SubsamplingLayer(poolingType="MAX", kernelSize=(2, 2),
                                             stride=(2, 2)))
        A = len(self.boundingBoxes)
        return (b.layer(ConvolutionLayer(nOut=A * (5 + self.numClasses),
                                         kernelSize=(1, 1), activation="IDENTITY"))
                .layer(Yolo2OutputLayer(boundingBoxes=self.boundingBoxes))
                .setInputType(InputType.convolutional(h, w, c))
                .build())


class InceptionResNetV1(ZooModel):
    """(ref: zoo.model.InceptionResNetV1 — the FaceNet backbone: stem,
    scaled-residual Inception-ResNet A/B/C blocks with reductions, global
    pool, bottleneck embedding). Block counts are configurable (reference:
    5/10/5) so tests instantiate shallow variants; the 1x1-linear-then-
    ScaleVertex-then-ElementWiseAdd residual wiring is the reference's.
    Ends with an L2-normalized ``embeddings`` output feeding a softmax
    classification head (the reference trains it the same way and reads the
    embedding layer at inference)."""

    def __init__(self, numClasses: int = 1000, seed: int = 123,
                 inputShape: Tuple[int, int, int] = (3, 160, 160),
                 embeddingSize: int = 128, blocks: Tuple[int, int, int] = (5, 10, 5)):
        super().__init__(numClasses, seed, inputShape)
        self.embeddingSize = embeddingSize
        self.blocks = blocks

    def conf(self):
        from deeplearning4j_tpu_torch.nn.conf.graph import ScaleVertex, L2NormalizeVertex
        from deeplearning4j_tpu_torch.nn.conf.layers import (ActivationLayer,
                                                       GlobalPoolingLayer)
        c, h, w = self.inputShape
        g = (NeuralNetConfiguration.Builder().seed(self.seed)
             .updater(Adam(1e-3)).weightInit("RELU").graphBuilder()
             .addInputs("input")
             .setInputTypes(InputType.convolutional(h, w, c)))

        def conv(name, frm, n_out, k, stride=1, act="RELU", same=True):
            g.addLayer(name, ConvolutionLayer(
                nOut=n_out, kernelSize=k if isinstance(k, tuple) else (k, k),
                stride=(stride, stride),
                convolutionMode="Same" if same else "Truncate",
                activation=act), frm)
            return name

        # stem (ref: InceptionResNetV1.inputBlock)
        prev = conv("stem1", "input", 32, 3, 2, same=False)
        prev = conv("stem2", prev, 32, 3, same=False)
        prev = conv("stem3", prev, 64, 3)
        g.addLayer("stem_pool", SubsamplingLayer(poolingType="MAX",
                                                 kernelSize=(3, 3), stride=(2, 2)),
                   prev)
        prev = conv("stem4", "stem_pool", 80, 1)
        prev = conv("stem5", prev, 192, 3, same=False)
        prev = conv("stem6", prev, 256, 3, 2, same=False)

        def residual_block(name, frm, branches, filters, scale):
            """branches: list of [(n_out, kernel), ...] chains; concat ->
            1x1 linear to `filters` -> scale -> add -> relu."""
            outs = []
            for bi, chain in enumerate(branches):
                p = frm
                for ci, (n_out, k) in enumerate(chain):
                    p = conv(f"{name}_b{bi}c{ci}", p, n_out, k)
                outs.append(p)
            g.addVertex(f"{name}_cat", MergeVertex(), *outs)
            conv(f"{name}_up", f"{name}_cat", filters, 1, act="IDENTITY")
            g.addVertex(f"{name}_scale", ScaleVertex(scaleFactor=scale),
                        f"{name}_up")
            g.addVertex(f"{name}_add", ElementWiseVertex(op="Add"), frm,
                        f"{name}_scale")
            g.addLayer(f"{name}_relu", ActivationLayer(activation="RELU"),
                       f"{name}_add")
            return f"{name}_relu"

        a, b_, c_ = self.blocks
        for i in range(a):  # Inception-ResNet-A (block35)
            prev = residual_block(f"a{i}", prev,
                                  [[(32, 1)], [(32, 1), (32, 3)],
                                   [(32, 1), (32, 3), (32, 3)]], 256, 0.17)
        # reduction-A
        ra = [conv("redA_b0", prev, 384, 3, 2, same=False),
              conv("redA_b1c2",
                   conv("redA_b1c1", conv("redA_b1c0", prev, 192, 1), 192, 3),
                   256, 3, 2, same=False)]
        g.addLayer("redA_pool", SubsamplingLayer(poolingType="MAX",
                                                 kernelSize=(3, 3), stride=(2, 2)),
                   prev)
        g.addVertex("redA", MergeVertex(), *ra, "redA_pool")
        prev = "redA"
        for i in range(b_):  # Inception-ResNet-B (block17), asymmetric 1x7/7x1
            prev = residual_block(f"b{i}", prev,
                                  [[(128, 1)],
                                   [(128, 1), (128, (1, 7)), (128, (7, 1))]],
                                  896, 0.10)
        # reduction-B
        rb = [conv("redB_b0c1", conv("redB_b0c0", prev, 256, 1), 384, 3, 2, same=False),
              conv("redB_b1c1", conv("redB_b1c0", prev, 256, 1), 256, 3, 2, same=False),
              conv("redB_b2c2",
                   conv("redB_b2c1", conv("redB_b2c0", prev, 256, 1), 256, 3),
                   256, 3, 2, same=False)]
        g.addLayer("redB_pool", SubsamplingLayer(poolingType="MAX",
                                                 kernelSize=(3, 3), stride=(2, 2)),
                   prev)
        g.addVertex("redB", MergeVertex(), *rb, "redB_pool")
        prev = "redB"
        for i in range(c_):  # Inception-ResNet-C (block8), asymmetric 1x3/3x1
            prev = residual_block(f"c{i}", prev,
                                  [[(192, 1)],
                                   [(192, 1), (192, (1, 3)), (192, (3, 1))]],
                                  1792, 0.20)

        g.addLayer("avgpool", GlobalPoolingLayer(poolingType="AVG"), prev)
        g.addLayer("bottleneck", DenseLayer(nOut=self.embeddingSize,
                                            activation="IDENTITY"), "avgpool")
        g.addVertex("embeddings", L2NormalizeVertex(), "bottleneck")
        g.addLayer("output", OutputLayer(nOut=self.numClasses,
                                         lossFunction="MCXENT"), "embeddings")
        g.setOutputs("output")
        return g.build()


class FaceNetNN4Small2(ZooModel):
    """(ref: zoo.model.FaceNetNN4Small2Deep — OpenFace's nn4.small2
    inception stack trained with CENTER LOSS on identities; embeddings read
    from the L2-normalized 128-d bottleneck).

    Topology follows the public nn4.small2 definition exactly: conv1 7x7/2
    -> maxpool -> LRN -> conv2 1x1 -> conv3 3x3 -> LRN -> maxpool ->
    inception 3a/3b/3c -> 4a/4e -> 5a/5b (mixed 1x1 / reduced-3x3 /
    reduced-5x5 branches with MAX or L2 (p-norm, p=2) pool projections;
    3c/4e are the stride-2 grid reductions with pass-through pools) ->
    global avgpool -> 128-d linear -> L2 normalize. Every conv carries
    batch-norm + ReLU, as in the reference."""

    def __init__(self, numClasses: int = 100, seed: int = 123,
                 inputShape: Tuple[int, int, int] = (3, 96, 96),
                 embeddingSize: int = 128, alpha: float = 0.5,
                 lambda_: float = 3e-3):
        super().__init__(numClasses, seed, inputShape)
        self.embeddingSize = embeddingSize
        self.alpha = alpha
        self.lambda_ = lambda_

    def conf(self):
        from deeplearning4j_tpu_torch.nn.conf.graph import L2NormalizeVertex
        from deeplearning4j_tpu_torch.nn.conf.layers import (
            ActivationLayer, BatchNormalization, CenterLossOutputLayer,
            GlobalPoolingLayer, LocalResponseNormalization)
        c, h, w = self.inputShape
        g = (NeuralNetConfiguration.Builder().seed(self.seed)
             .updater(Adam(1e-3)).weightInit("RELU").graphBuilder()
             .addInputs("input")
             .setInputTypes(InputType.convolutional(h, w, c)))

        def conv_bn(name, frm, n_out, k, stride=1):
            """conv -> BN -> ReLU (nn4 uses SpatialBatchNormalization)."""
            g.addLayer(f"{name}_c", ConvolutionLayer(
                nOut=n_out, kernelSize=(k, k), stride=(stride, stride),
                convolutionMode="Same", activation="IDENTITY"), frm)
            g.addLayer(f"{name}_bn", BatchNormalization(), f"{name}_c")
            g.addLayer(name, ActivationLayer(activation="RELU"), f"{name}_bn")
            return name

        def inception(name, frm, n1, r3, n3, r5, n5, pool_kind, pool_proj,
                      stride=1):
            """nn4 inception module. n1=0 drops the 1x1 branch (3c/4e);
            r5=0 drops the 5x5 branch (5a/5b); pool_proj=0 passes the pool
            through unprojected (the stride-2 modules)."""
            branches = []
            if n1:
                branches.append(conv_bn(f"{name}_1x1", frm, n1, 1))
            branches.append(conv_bn(
                f"{name}_3x3", conv_bn(f"{name}_3x3r", frm, r3, 1), n3, 3,
                stride))
            if r5:
                branches.append(conv_bn(
                    f"{name}_5x5", conv_bn(f"{name}_5x5r", frm, r5, 1), n5, 5,
                    stride))
            pool = f"{name}_pool"
            g.addLayer(pool, SubsamplingLayer(
                poolingType="MAX" if pool_kind == "max" else "PNORM",
                pnorm=2, kernelSize=(3, 3), stride=(stride, stride),
                convolutionMode="Same"), frm)
            branches.append(conv_bn(f"{name}_poolproj", pool, pool_proj, 1)
                            if pool_proj else pool)
            g.addVertex(name, MergeVertex(), *branches)
            return name

        prev = conv_bn("conv1", "input", 64, 7, 2)
        g.addLayer("pool1", SubsamplingLayer(poolingType="MAX", kernelSize=(3, 3),
                                             stride=(2, 2),
                                             convolutionMode="Same"), prev)
        g.addLayer("lrn1", LocalResponseNormalization(), "pool1")
        prev = conv_bn("conv2", "lrn1", 64, 1)
        prev = conv_bn("conv3", prev, 192, 3)
        g.addLayer("lrn2", LocalResponseNormalization(), prev)
        g.addLayer("pool2", SubsamplingLayer(poolingType="MAX", kernelSize=(3, 3),
                                             stride=(2, 2),
                                             convolutionMode="Same"), "lrn2")
        # (n1, r3, n3, r5, n5, pool, proj, stride) per the nn4.small2 table
        prev = inception("inc3a", "pool2", 64, 96, 128, 16, 32, "max", 32)
        prev = inception("inc3b", prev, 64, 96, 128, 32, 64, "l2", 64)
        prev = inception("inc3c", prev, 0, 128, 256, 32, 64, "max", 0, stride=2)
        prev = inception("inc4a", prev, 256, 96, 192, 32, 64, "l2", 128)
        prev = inception("inc4e", prev, 0, 160, 256, 64, 128, "max", 0, stride=2)
        prev = inception("inc5a", prev, 256, 96, 384, 0, 0, "l2", 96)
        prev = inception("inc5b", prev, 256, 96, 384, 0, 0, "max", 96)
        g.addLayer("avgpool", GlobalPoolingLayer(poolingType="AVG"), prev)
        g.addLayer("bottleneck", DenseLayer(nOut=self.embeddingSize,
                                            activation="IDENTITY"), "avgpool")
        g.addVertex("embeddings", L2NormalizeVertex(), "bottleneck")
        g.addLayer("output", CenterLossOutputLayer(
            nOut=self.numClasses, alpha=self.alpha, lambda_=self.lambda_,
            lossFunction="MCXENT"), "embeddings")
        g.setOutputs("output")
        return g.build()


class NASNetMobile(ZooModel):
    """(ref: zoo.model.NASNet — NASNet-A cells). Normal cells combine
    separable-conv/pool/identity pairs on (h, h_prev) with 5 block outputs
    concatenated; reduction cells halve the spatial dims. Cell count and
    penultimate-filter width are configurable (reference mobile: 4 cells @
    1056 penultimate). After each reduction, h_prev stays at the old
    resolution and the next cell's adjust block applies the reference's
    FACTORIZED REDUCTION: two 1x1-stride-2 average-pool paths, the second
    offset one pixel, concatenated and batch-normed."""

    def __init__(self, numClasses: int = 1000, seed: int = 123,
                 inputShape: Tuple[int, int, int] = (3, 224, 224),
                 cells_per_stage: int = 2, stem_filters: int = 32,
                 filters: int = 44):
        super().__init__(numClasses, seed, inputShape)
        self.cells_per_stage = cells_per_stage
        self.stem_filters = stem_filters
        self.filters = filters

    def conf(self):
        from deeplearning4j_tpu_torch.nn.conf.layers import (
            BatchNormalization, Cropping2D, GlobalPoolingLayer,
            ZeroPaddingLayer)
        c, h, w = self.inputShape
        g = (NeuralNetConfiguration.Builder().seed(self.seed)
             .updater(Adam(1e-3)).weightInit("RELU").graphBuilder()
             .addInputs("input")
             .setInputTypes(InputType.convolutional(h, w, c)))
        uid = [0]
        # spatial-resolution level per tensor name (increments at each
        # stride-2 reduction) — drives h_prev factorized reduction
        res: dict = {}

        def sep(frm, n_out, k, stride=1):
            uid[0] += 1
            name = f"sep{uid[0]}"
            g.addLayer(name, SeparableConvolution2D(
                nOut=n_out, kernelSize=(k, k), stride=(stride, stride),
                convolutionMode="Same", activation="RELU"), frm)
            return name

        def factorized_reduction(frm, n_out):
            """Stride-2 downsample without information loss at the grid
            boundary (ref: NASNet's FactorizedReduction / adjust_block):
            two 1x1-stride-2 average-pool paths, the second offset by one
            pixel, each 1x1-conv'd to n_out/2, concatenated, batch-normed."""
            uid[0] += 1
            base = f"fr{uid[0]}"
            g.addLayer(f"{base}_p1", SubsamplingLayer(
                poolingType="AVG", kernelSize=(1, 1), stride=(2, 2)), frm)
            g.addLayer(f"{base}_c1", ConvolutionLayer(
                nOut=n_out // 2, kernelSize=(1, 1), activation="IDENTITY"),
                f"{base}_p1")
            # offset path: shift the grid by (1,1) so the concat covers the
            # pixels the first path's stride skipped
            g.addLayer(f"{base}_pad", ZeroPaddingLayer(padding=(0, 1, 0, 1)), frm)
            g.addLayer(f"{base}_crop", Cropping2D(cropping=(1, 0, 1, 0)),
                       f"{base}_pad")
            g.addLayer(f"{base}_p2", SubsamplingLayer(
                poolingType="AVG", kernelSize=(1, 1), stride=(2, 2)),
                f"{base}_crop")
            g.addLayer(f"{base}_c2", ConvolutionLayer(
                nOut=n_out - n_out // 2, kernelSize=(1, 1),
                activation="IDENTITY"), f"{base}_p2")
            g.addVertex(f"{base}_cat", MergeVertex(), f"{base}_c1", f"{base}_c2")
            g.addLayer(base, BatchNormalization(), f"{base}_cat")
            return base

        def adjust(frm, n_out, target_res=None):
            """Match h_prev to the cell's filter count — and, when it sits
            one resolution level behind (the cell right after a reduction),
            bring it down via factorized reduction (ref: adjust_block)."""
            if target_res is not None and res.get(frm, target_res) < target_res:
                name = factorized_reduction(frm, n_out)
                res[name] = target_res
                return name
            uid[0] += 1
            name = f"adj{uid[0]}"
            g.addLayer(name, ConvolutionLayer(
                nOut=n_out, kernelSize=(1, 1), activation="RELU"), frm)
            res[name] = res.get(frm, 0)
            return name

        def pool(frm, kind, stride=1):
            uid[0] += 1
            name = f"pool{uid[0]}"
            g.addLayer(name, SubsamplingLayer(
                poolingType=kind, kernelSize=(3, 3), stride=(stride, stride),
                convolutionMode="Same"), frm)
            return name

        def add(a, b):
            uid[0] += 1
            name = f"add{uid[0]}"
            g.addVertex(name, ElementWiseVertex(op="Add"), a, b)
            return name

        def normal_cell(h_cur, h_prev, f):
            """NASNet-A normal cell: 5 combinations concat'd."""
            hc = adjust(h_cur, f)
            hp = adjust(h_prev, f, target_res=res.get(h_cur, 0))
            b1 = add(sep(hc, f, 3), hc)
            b2 = add(sep(hp, f, 3), sep(hc, f, 5))
            b3 = add(pool(hp, "AVG"), hp)
            b4 = add(pool(hp, "AVG"), pool(hp, "AVG"))
            b5 = add(sep(hp, f, 5), sep(hp, f, 3))
            uid[0] += 1
            name = f"ncell{uid[0]}"
            g.addVertex(name, MergeVertex(), b1, b2, b3, b4, b5)
            res[name] = res.get(h_cur, 0)
            return name

        def reduction_cell(h_cur, h_prev, f):
            hc = adjust(h_cur, f)
            hp = adjust(h_prev, f, target_res=res.get(h_cur, 0))
            b1 = add(sep(hc, f, 5, 2), sep(hp, f, 7, 2))
            b2 = add(pool(hc, "MAX", 2), sep(hp, f, 7, 2))
            b3 = add(pool(hc, "AVG", 2), sep(hp, f, 5, 2))
            b4 = add(pool(b1, "AVG"), b2)
            b5 = add(sep(b1, f, 3), pool(hc, "MAX", 2))
            uid[0] += 1
            name = f"rcell{uid[0]}"
            g.addVertex(name, MergeVertex(), b2, b3, b4, b5)
            res[name] = res.get(h_cur, 0) + 1
            return name

        g.addLayer("stem", ConvolutionLayer(nOut=self.stem_filters,
                                            kernelSize=(3, 3), stride=(2, 2),
                                            convolutionMode="Same",
                                            activation="RELU"), "input")
        res["stem"] = 0
        h_prev, h_cur = "stem", "stem"
        f = self.filters
        for stage in range(3):
            if stage > 0:
                f *= 2
                nxt = reduction_cell(h_cur, h_prev, f)
                # the reference keeps h_prev at the OLD resolution here; the
                # next cell's adjust() brings it down via factorized
                # reduction (two offset stride-2 avg-pool paths, concat, BN)
                h_prev, h_cur = h_cur, nxt
            for _ in range(self.cells_per_stage):
                nxt = normal_cell(h_cur, h_prev, f)
                h_prev, h_cur = h_cur, nxt
        g.addLayer("gap", GlobalPoolingLayer(poolingType="AVG"), h_cur)
        g.addLayer("output", OutputLayer(nOut=self.numClasses,
                                         lossFunction="MCXENT"), "gap")
        g.setOutputs("output")
        return g.build()
