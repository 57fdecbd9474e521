"""Input types + shape inference (counterpart: ``deeplearning4j_tpu/nn/conf/
inputs.py``; ref: org.deeplearning4j.nn.conf.inputs.InputType and the
preprocessor auto-insertion logic in MultiLayerConfiguration).

An InputType flows through the layer configs at build time: each layer reports
its output type, nIn fields are filled automatically, and format adapters
(flatten CNN->FF etc. — the reference's InputPreProcessors) are inserted where
the kinds disagree. CNN layout is NCHW (reference default)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class InputType:
    kind: str  # 'ff' | 'cnn' | 'cnn3d' | 'rnn'
    size: int = 0  # ff feature count / rnn feature size
    channels: int = 0
    height: int = 0
    width: int = 0
    depth: int = 0
    timeSeriesLength: int = -1  # -1 = variable

    @staticmethod
    def feedForward(size: int) -> "InputType":
        return InputType("ff", size=size)

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType("cnn", channels=channels, height=height, width=width)

    @staticmethod
    def convolutionalFlat(height: int, width: int, channels: int) -> "InputType":
        """Flattened-image input, e.g. MNIST (B, 784) — the network reshapes to
        NCHW before the first layer (ref: InputType.convolutionalFlat +
        FeedForwardToCnnPreProcessor auto-insertion)."""
        return InputType("cnnflat", channels=channels, height=height, width=width)

    def as_cnn(self) -> "InputType":
        if self.kind == "cnnflat":
            return InputType.convolutional(self.height, self.width, self.channels)
        return self

    @staticmethod
    def convolutional3D(depth: int, height: int, width: int, channels: int) -> "InputType":
        return InputType("cnn3d", channels=channels, height=height, width=width, depth=depth)

    @staticmethod
    def recurrent(size: int, timeSeriesLength: int = -1) -> "InputType":
        return InputType("rnn", size=size, timeSeriesLength=timeSeriesLength)

    @staticmethod
    def convolutionalSequence(height: int, width: int, channels: int,
                              timeSeriesLength: int = -1) -> "InputType":
        """Sequence of images (B, T, C, H, W) — the ConvLSTM2D input
        (ref: KerasConvLSTM2D's 5D input; upstream InputType has no distinct
        kind, the importer there juggles preprocessors instead)."""
        return InputType("cnnseq", channels=channels, height=height,
                         width=width, timeSeriesLength=timeSeriesLength)

    def flat_size(self) -> int:
        if self.kind == "ff":
            return self.size
        if self.kind in ("cnn", "cnnseq"):  # cnnseq: per-frame feature count
            return self.channels * self.height * self.width
        if self.kind == "cnn3d":
            return self.channels * self.depth * self.height * self.width
        return self.size

    def array_shape(self, batch: int = 1):
        if self.kind == "ff":
            return (batch, self.size)
        if self.kind == "cnn":
            return (batch, self.channels, self.height, self.width)
        if self.kind == "cnn3d":
            return (batch, self.channels, self.depth, self.height, self.width)
        if self.kind == "cnnseq":
            t = self.timeSeriesLength if self.timeSeriesLength > 0 else 1
            return (batch, t, self.channels, self.height, self.width)
        t = self.timeSeriesLength if self.timeSeriesLength > 0 else 1
        return (batch, t, self.size)

    def to_dict(self):
        return {"kind": self.kind, **{k: v for k, v in self.__dict__.items() if k != "kind"}}

    @staticmethod
    def from_dict(d):
        return InputType(**d)
