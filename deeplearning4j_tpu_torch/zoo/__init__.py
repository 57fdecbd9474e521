"""Model zoo (counterpart: ``deeplearning4j_tpu/zoo``; ref:
deeplearning4j-zoo — org.deeplearning4j.zoo.ZooModel and
org.deeplearning4j.zoo.model.*)."""
from deeplearning4j_tpu_torch.zoo.models import (
    ZooModel, LeNet, SimpleCNN, AlexNet, VGG16, VGG19, ResNet50, SqueezeNet,
    Darknet19, UNet, Xception, TextGenerationLSTM, TinyYOLO, YOLO2,
    InceptionResNetV1, FaceNetNN4Small2, NASNetMobile)

__all__ = [
    "ZooModel", "LeNet", "SimpleCNN", "AlexNet", "VGG16", "VGG19", "ResNet50",
    "SqueezeNet", "Darknet19", "UNet", "Xception", "TextGenerationLSTM",
    "TinyYOLO", "YOLO2", "InceptionResNetV1", "FaceNetNN4Small2",
    "NASNetMobile",
]
