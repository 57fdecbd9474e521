"""Training math: updaters, losses, activations, schedules, regularization
(counterpart: ``deeplearning4j_tpu/train``; ref:
org.nd4j.linalg.{learning,lossfunctions,activations,schedule})."""
from deeplearning4j_tpu_torch.train import activations, losses, regularization, schedules, updaters  # noqa: F401
from deeplearning4j_tpu_torch.train.updaters import (  # noqa: F401
    Adam, AdamW, AdaDelta, AdaGrad, AdaMax, AMSGrad, Nadam, Nesterovs, NoOp, RmsProp, Sgd, Updater,
)
from deeplearning4j_tpu_torch.train.schedules import (  # noqa: F401
    ExponentialSchedule, FixedSchedule, InverseSchedule, MapSchedule, PolySchedule, Schedule,
    SigmoidSchedule, StepSchedule, WarmupLinearDecaySchedule,
)
from deeplearning4j_tpu_torch.train.regularization import L1, L2, WeightDecay  # noqa: F401
