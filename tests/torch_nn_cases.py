"""Jax-free case recipes for the networks slices: one small configuration
(or a few) of each of the reference's 57 layer types (``deeplearning4j_
tpu_torch/nn/conf/layers.py``), built by name from either package's
``layers`` module so the same recipe drives the JAX package and the port
(``tests/test_torch_nn_*.py``; ``chip_smoke.py`` reads the names). The
cases from ``prelu`` on (:data:`SECOND_HALF_IDS`) are the second half's 27
types.

A case is ``(id, layer spec, input spec, masked)``:

- a layer spec is ``(class name, kwargs)``; a kwarg whose value is a
  layer spec builds that layer (``Bidirectional.fwd``,
  ``LastTimeStep.underlying``);
- an input spec is ``(kind, *sizes)``: ``("ff", F)`` (B, F),
  ``("rnn", F, T)`` (B, T, F), ``("rnn_ncw", F, T)`` (B, F, T),
  ``("rnn_padded", F, T)`` (B, T, F) whose rows after the first end in
  all-zero steps, ``("cnn", H, W, C)`` (B, C, H, W), ``("cnn3d", D, H,
  W, C)`` (B, C, D, H, W), ``("cnnseq", H, W, C, T)`` (B, T, C, H, W),
  ``("ids", V)`` (B,) and ``("idseq", V, T)`` (B, T) integer indices;
- ``masked``: the case also runs with a (B, T) features mask whose rows
  end at different lengths.
"""
import numpy as np

BATCH = 3

CASES = [
    ("dense", ("DenseLayer", dict(nOut=4, activation="TANH")), ("ff", 5), False),
    ("dense_nobias", ("DenseLayer", dict(nOut=3, hasBias=False, activation="SIGMOID")),
     ("ff", 4), False),
    ("embedding", ("EmbeddingLayer", dict(nIn=7, nOut=4)), ("ids", 7), False),
    ("embedding_sequence", ("EmbeddingSequenceLayer", dict(nIn=7, nOut=4)),
     ("idseq", 7, 5), False),
    ("conv_truncate", ("ConvolutionLayer", dict(nOut=3, kernelSize=(3, 3), padding=(1, 1),
                                                activation="RELU")), ("cnn", 6, 6, 2), False),
    ("conv_same_s2", ("ConvolutionLayer", dict(nOut=3, kernelSize=(3, 3), stride=(2, 2),
                                               convolutionMode="Same")), ("cnn", 7, 6, 2), False),
    ("conv_dilated", ("ConvolutionLayer", dict(nOut=2, kernelSize=(2, 2), dilation=(2, 2))),
     ("cnn", 6, 6, 2), False),
    ("conv1d", ("Convolution1DLayer", dict(nOut=3, kernelSize=3)), ("rnn", 4, 6), False),
    ("conv1d_truncate", ("Convolution1DLayer", dict(nOut=3, kernelSize=2, stride=2,
                                                    padding=1, convolutionMode="Truncate")),
     ("rnn", 4, 7), False),
    ("deconv_same", ("Deconvolution2D", dict(nOut=2, kernelSize=(3, 3), stride=(2, 2),
                                             convolutionMode="Same")), ("cnn", 4, 4, 3), False),
    ("deconv_truncate", ("Deconvolution2D", dict(nOut=2, kernelSize=(2, 2), stride=(2, 2),
                                                 padding=(1, 1))), ("cnn", 4, 5, 2), False),
    ("depthwise", ("DepthwiseConvolution2D", dict(kernelSize=(3, 3), depthMultiplier=2,
                                                  convolutionMode="Same")),
     ("cnn", 5, 5, 2), False),
    ("separable", ("SeparableConvolution2D", dict(nOut=4, kernelSize=(3, 3),
                                                  depthMultiplier=2)), ("cnn", 5, 5, 2), False),
    ("pool_max", ("SubsamplingLayer", dict(poolingType="MAX")), ("cnn", 6, 6, 2), False),
    ("pool_avg_same", ("SubsamplingLayer", dict(poolingType="AVG", kernelSize=(3, 3),
                                                stride=(2, 2), convolutionMode="Same")),
     ("cnn", 5, 5, 2), False),
    ("pool_sum", ("SubsamplingLayer", dict(poolingType="SUM", padding=(1, 1))),
     ("cnn", 5, 5, 2), False),
    ("pool_pnorm", ("SubsamplingLayer", dict(poolingType="PNORM", pnorm=3)),
     ("cnn", 4, 4, 2), False),
    ("pool1d", ("Subsampling1DLayer", dict(poolingType="MAX")), ("rnn", 3, 6), False),
    ("pool1d_avg", ("Subsampling1DLayer", dict(poolingType="AVG", kernelSize=3, stride=1,
                                               padding=1)), ("rnn", 3, 6), False),
    ("batchnorm_cnn", ("BatchNormalization", dict(activation="RELU")), ("cnn", 4, 4, 3), False),
    ("batchnorm_ff", ("BatchNormalization", dict(decay=0.8)), ("ff", 5), False),
    ("batchnorm_seq", ("BatchNormalization", dict(lockGammaBeta=True)), ("rnn", 4, 5), False),
    ("lrn", ("LocalResponseNormalization", dict(n=3)), ("cnn", 3, 3, 5), False),
    ("dropout_layer", ("DropoutLayer", dict(dropOut=0.6)), ("ff", 6), False),
    ("activation_leaky", ("ActivationLayer", dict(activation="LEAKYRELU", alpha=0.2)),
     ("ff", 5), False),
    ("activation_elu", ("ActivationLayer", dict(activation="ELU", alpha=0.5)), ("ff", 5), False),
    ("activation_threshold", ("ActivationLayer", dict(activation="THRESHOLDEDRELU",
                                                      alpha=0.3)), ("ff", 5), False),
    ("activation_gelu", ("ActivationLayer", dict(activation="GELU")), ("ff", 5), False),
    ("upsampling2d", ("Upsampling2D", dict(size=(2, 3))), ("cnn", 3, 3, 2), False),
    ("zero_padding", ("ZeroPaddingLayer", dict(padding=(1, 0, 2, 1))), ("cnn", 3, 3, 2), False),
    ("cropping2d", ("Cropping2D", dict(cropping=(1, 0, 1, 2))), ("cnn", 5, 6, 2), False),
    ("global_avg_seq", ("GlobalPoolingLayer", dict(poolingType="AVG")), ("rnn", 4, 6), True),
    ("global_max_seq", ("GlobalPoolingLayer", dict(poolingType="MAX")), ("rnn", 4, 6), True),
    ("global_pnorm_cnn", ("GlobalPoolingLayer", dict(poolingType="PNORM")),
     ("cnn", 3, 3, 2), False),
    ("global_sum_cnn", ("GlobalPoolingLayer", dict(poolingType="SUM")), ("cnn", 3, 3, 2), False),
    ("lstm", ("LSTM", dict(nOut=5)), ("rnn", 4, 6), True),
    ("lstm_ncw", ("LSTM", dict(nOut=4, rnnDataFormat="NCW")), ("rnn_ncw", 3, 5), False),
    ("graves_lstm", ("GravesLSTM", dict(nOut=5)), ("rnn", 4, 6), True),
    ("simple_rnn", ("SimpleRnn", dict(nOut=4, activation="TANH")), ("rnn", 3, 5), True),
    ("gru", ("GRU", dict(nOut=4)), ("rnn", 3, 5), True),
    ("bidirectional_concat", ("Bidirectional", dict(fwd=("LSTM", dict(nOut=3)))),
     ("rnn", 4, 5), True),
    ("bidirectional_add", ("Bidirectional", dict(fwd=("GravesLSTM", dict(nOut=3)),
                                                 mode="ADD")), ("rnn", 4, 5), False),
    ("conv_lstm2d", ("ConvLSTM2D", dict(nOut=3, kernelSize=(3, 3))),
     ("cnnseq", 4, 4, 2, 3), False),
    ("conv_lstm2d_seq", ("ConvLSTM2D", dict(nOut=2, kernelSize=(3, 3), returnSequences=True)),
     ("cnnseq", 4, 3, 2, 3), False),
    ("repeat_vector", ("RepeatVector", dict(repetitionFactor=3)), ("ff", 4), False),
    ("last_time_step", ("LastTimeStep", dict(underlying=("LSTM", dict(nOut=4)))),
     ("rnn", 3, 6), True),
    ("output", ("OutputLayer", dict(nOut=4, lossFunction="MCXENT")), ("ff", 5), False),
    ("output_mse", ("OutputLayer", dict(nOut=3, lossFunction="MSE", activation="IDENTITY")),
     ("ff", 5), False),
    ("rnn_output", ("RnnOutputLayer", dict(nOut=4, lossFunction="MCXENT")), ("rnn", 3, 5),
     False),
    ("rnn_output_ncw", ("RnnOutputLayer", dict(nOut=3, lossFunction="MCXENT",
                                               rnnDataFormat="NCW")), ("rnn_ncw", 4, 5), False),
    ("loss_layer", ("LossLayer", dict(lossFunction="MCXENT", activation="SOFTMAX")),
     ("ff", 4), False),
    ("self_attention", ("SelfAttentionLayer", dict(nOut=8, nHeads=2)), ("rnn", 6, 8), True),
    ("self_attention_unprojected", ("SelfAttentionLayer", dict(projectInput=False)),
     ("rnn", 6, 8), True),
    # ---- the second half: shape and elementwise
    ("prelu", ("PReLULayer", dict(sharedAxes=(2, 3))), ("cnn", 3, 4, 2), False),
    ("prelu_ff", ("PReLULayer", dict()), ("ff", 5), False),
    ("elementwise_mult", ("ElementWiseMultiplicationLayer", dict(nIn=5, activation="TANH")),
     ("ff", 5), False),
    ("mask_zero", ("MaskZeroLayer", dict(underlying=("LSTM", dict(nOut=4)))),
     ("rnn_padded", 3, 6), False),
    ("reshape_cnn_to_seq", ("ReshapeLayer", dict(targetShape=(-1, 6))), ("cnn", 2, 3, 2),
     False),
    ("reshape_ff_to_cnn", ("ReshapeLayer", dict(targetShape=(3, 2, 2))), ("ff", 12), False),
    ("permute", ("PermuteLayer", dict(permuteDims=(2, 1, 3))), ("cnn", 3, 4, 2), False),
    ("space_to_depth", ("SpaceToDepthLayer", dict(blockSize=2)), ("cnn", 4, 6, 3), False),
    ("upsampling1d", ("Upsampling1D", dict(size=3)), ("rnn", 3, 4), False),
    ("upsampling3d", ("Upsampling3D", dict(size=(1, 2, 3))), ("cnn3d", 2, 2, 3, 2), False),
    ("cropping1d", ("Cropping1D", dict(cropping=(1, 2))), ("rnn", 3, 7), False),
    ("cropping3d", ("Cropping3D", dict(cropping=(1, 0, 0, 1, 1, 1))), ("cnn3d", 3, 4, 4, 2),
     False),
    ("zero_padding1d", ("ZeroPadding1DLayer", dict(padding=(2, 1))), ("rnn", 3, 4), False),
    ("zero_padding3d", ("ZeroPadding3DLayer", dict(padding=(1, 0, 0, 2, 1, 1))),
     ("cnn3d", 2, 2, 2, 2), False),
    # ---- 3D convolution, 3D pooling, locally connected
    ("conv3d", ("Convolution3D", dict(nOut=3, kernelSize=(2, 2, 2), activation="RELU")),
     ("cnn3d", 3, 4, 4, 2), False),
    ("conv3d_same_s2", ("Convolution3D", dict(nOut=2, kernelSize=(3, 3, 2), stride=(2, 2, 2),
                                              convolutionMode="Same")),
     ("cnn3d", 3, 5, 4, 2), False),
    ("pool3d_max", ("Subsampling3DLayer", dict(poolingType="MAX")), ("cnn3d", 4, 4, 4, 2),
     False),
    ("pool3d_avg_same", ("Subsampling3DLayer", dict(poolingType="AVG", kernelSize=(3, 3, 3),
                                                    convolutionMode="Same")),
     ("cnn3d", 3, 5, 4, 2), False),
    ("locally_connected1d", ("LocallyConnected1D", dict(nOut=3, kernelSize=3, stride=2)),
     ("rnn", 4, 7), False),
    ("locally_connected2d", ("LocallyConnected2D", dict(nOut=3, kernelSize=(2, 2),
                                                        stride=(2, 1), activation="TANH")),
     ("cnn", 5, 4, 2), False),
    # ---- recurrent extras
    ("graves_bidirectional_lstm", ("GravesBidirectionalLSTM", dict(nOut=4)), ("rnn", 3, 5),
     True),
    ("learned_self_attention", ("LearnedSelfAttentionLayer", dict(nOut=6, nHeads=2,
                                                                  nQueries=3)),
     ("rnn", 4, 5), True),
    ("recurrent_attention", ("RecurrentAttentionLayer", dict(nOut=4)), ("rnn", 3, 5), True),
    # ---- capsules
    ("primary_capsules", ("PrimaryCapsules", dict(capsuleDimensions=4, channels=2,
                                                  kernelSize=(3, 3), stride=(2, 2))),
     ("cnn", 7, 7, 2), False),
    ("capsule", ("CapsuleLayer", dict(capsules=3, capsuleDimensions=4, routings=3)),
     ("rnn", 5, 6), False),
    ("capsule_strength", ("CapsuleStrengthLayer", dict()), ("rnn", 4, 3), False),
    # ---- heads
    ("center_loss_output", ("CenterLossOutputLayer", dict(nOut=3, lambda_=0.1)), ("ff", 5),
     False),
    ("ocnn_output", ("OCNNOutputLayer", dict(hiddenSize=4)), ("ff", 5), False),
    ("yolo2_output", ("Yolo2OutputLayer", dict(boundingBoxes=((1.0, 1.5), (2.0, 1.0)))),
     ("cnn", 3, 3, 14), False),
    # ---- pretrainable
    ("autoencoder", ("AutoEncoder", dict(nOut=3, activation="SIGMOID")), ("ff", 5), False),
    ("vae", ("VariationalAutoencoder", dict(nOut=2, encoderLayerSizes=(6,),
                                            decoderLayerSizes=(5,), activation="TANH")),
     ("ff", 4), False),
]

# every layer type the cases above exercise: the reference's 57
LAYER_NAMES = (
    "DenseLayer", "EmbeddingLayer", "EmbeddingSequenceLayer", "ConvolutionLayer",
    "Convolution1DLayer", "Deconvolution2D", "DepthwiseConvolution2D",
    "SeparableConvolution2D", "SubsamplingLayer", "Subsampling1DLayer",
    "BatchNormalization", "LocalResponseNormalization", "DropoutLayer", "ActivationLayer",
    "Upsampling2D", "ZeroPaddingLayer", "Cropping2D", "GlobalPoolingLayer", "LSTM",
    "GravesLSTM", "SimpleRnn", "GRU", "Bidirectional", "ConvLSTM2D", "RepeatVector",
    "LastTimeStep", "OutputLayer", "RnnOutputLayer", "LossLayer", "SelfAttentionLayer",
    # the second half
    "PReLULayer", "ElementWiseMultiplicationLayer", "MaskZeroLayer", "ReshapeLayer",
    "PermuteLayer", "SpaceToDepthLayer", "Upsampling1D", "Upsampling3D", "Cropping1D",
    "Cropping3D", "ZeroPadding1DLayer", "ZeroPadding3DLayer", "Convolution3D",
    "Subsampling3DLayer", "LocallyConnected1D", "LocallyConnected2D",
    "GravesBidirectionalLSTM", "LearnedSelfAttentionLayer", "RecurrentAttentionLayer",
    "PrimaryCapsules", "CapsuleLayer", "CapsuleStrengthLayer", "CenterLossOutputLayer",
    "OCNNOutputLayer", "Yolo2OutputLayer", "AutoEncoder", "VariationalAutoencoder",
)

CASE_IDS = [c[0] for c in CASES]
SECOND_HALF_IDS = CASE_IDS[CASE_IDS.index("prelu"):]


def case(case_id):
    return next(c for c in CASES if c[0] == case_id)


def make_layer(layers_module, spec):
    """The layer of ``spec`` from ``layers_module`` (either package's)."""
    name, kwargs = spec
    kw = {k: make_layer(layers_module, v) if isinstance(v, tuple) and len(v) == 2
          and isinstance(v[0], str) and isinstance(v[1], dict) else v
          for k, v in kwargs.items()}
    return getattr(layers_module, name)(**kw)


def input_type(input_type_cls, spec):
    kind, *s = spec
    if kind == "ff":
        return input_type_cls.feedForward(s[0])
    if kind in ("rnn", "rnn_ncw", "rnn_padded"):
        return input_type_cls.recurrent(s[0], s[1])
    if kind == "cnn":
        return input_type_cls.convolutional(*s)
    if kind == "cnn3d":
        return input_type_cls.convolutional3D(*s)
    if kind == "cnnseq":
        return input_type_cls.convolutionalSequence(*s)
    if kind == "ids":
        return input_type_cls.feedForward(1)
    if kind == "idseq":
        return input_type_cls.recurrent(1, s[1])
    raise ValueError(kind)


def build(pkg, case_id, seed=0):
    """(the layer after the builder's inherit / nIn fill, the
    configuration) for ``pkg``, a package's ``nn`` module (the JAX
    package's or the port's)."""
    _, spec, ispec, _ = case(case_id)
    layer = make_layer(pkg.layers, spec)
    conf = (pkg.NeuralNetConfiguration.Builder().seed(seed).list().layer(layer)
            .setInputType(input_type(pkg.InputType, ispec)).build())
    return conf.layers[0], conf


def inputs(case_id, seed=0):
    """(x, mask or None, cotangent maker) as numpy, float32 features."""
    _, _, ispec, masked = case(case_id)
    rng = np.random.default_rng(seed)
    kind, *s = ispec
    B = BATCH
    if kind == "ff":
        x = rng.standard_normal((B, s[0])).astype(np.float32)
    elif kind == "rnn":
        x = rng.standard_normal((B, s[1], s[0])).astype(np.float32)
    elif kind == "rnn_padded":
        x = rng.standard_normal((B, s[1], s[0])).astype(np.float32)
        for row in range(1, B):
            x[row, s[1] - 1 - row:] = 0.0
    elif kind == "rnn_ncw":
        x = rng.standard_normal((B, s[0], s[1])).astype(np.float32)
    elif kind == "cnn":
        H, W, C = s
        x = rng.standard_normal((B, C, H, W)).astype(np.float32)
    elif kind == "cnn3d":
        D, H, W, C = s
        x = rng.standard_normal((B, C, D, H, W)).astype(np.float32)
    elif kind == "cnnseq":
        H, W, C, T = s
        x = rng.standard_normal((B, T, C, H, W)).astype(np.float32)
    elif kind == "ids":
        x = rng.integers(0, s[0], (B,)).astype(np.int32)
    elif kind == "idseq":
        x = rng.integers(0, s[0], (B, s[1])).astype(np.int32)
    else:
        raise ValueError(kind)
    mask = None
    if masked:
        T = s[1]
        lengths = [T, T - 2, 1][:B]
        mask = (np.arange(T)[None, :] < np.array(lengths)[:, None]).astype(np.float32)
    return x, mask


def cotangent(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
