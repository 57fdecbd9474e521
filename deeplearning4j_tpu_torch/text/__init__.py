"""NLP / embedding models (counterpart: ``deeplearning4j_tpu/text``; ref:
deeplearning4j-nlp-parent — Word2Vec, ParagraphVectors, GloVe, FastText,
tokenizers, vocab, serializer). The models train on ``device`` (default
``"cuda"``; without CUDA they raise unless ``device="cpu"``)."""
from deeplearning4j_tpu_torch.text.tokenization import (
    DefaultTokenizerFactory, NGramTokenizerFactory, CommonPreprocessor,
    LowCasePreProcessor)
from deeplearning4j_tpu_torch.text.sentence_iterator import (
    BasicLineIterator, CollectionSentenceIterator, LineSentenceIterator)
from deeplearning4j_tpu_torch.text.vocab import VocabCache, VocabWord
from deeplearning4j_tpu_torch.text.word2vec import Word2Vec
from deeplearning4j_tpu_torch.text.paragraph_vectors import ParagraphVectors
from deeplearning4j_tpu_torch.text.glove import Glove
from deeplearning4j_tpu_torch.text.fasttext import FastText
from deeplearning4j_tpu_torch.text.serializer import WordVectorSerializer

__all__ = [
    "DefaultTokenizerFactory", "NGramTokenizerFactory", "CommonPreprocessor",
    "LowCasePreProcessor", "BasicLineIterator", "CollectionSentenceIterator",
    "LineSentenceIterator", "VocabCache", "VocabWord", "Word2Vec",
    "ParagraphVectors", "Glove", "FastText", "WordVectorSerializer",
]
