"""Word-vector persistence (counterpart: ``deeplearning4j_tpu/text/
serializer.py``; ref: deeplearning4j-nlp WordVectorSerializer — the ~4k-LoC
class handling every w2v file format; here: the standard text format (word
+ space-separated floats per line, optional count header), Google's binary
format and a compressed npz container). The writers are the reference's,
byte for byte; a reader builds its model for ``device`` (default
``"cuda"``; without CUDA it raises unless ``device="cpu"``), which a later
``fit`` trains on."""
from __future__ import annotations

import gzip
import os
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch import default_device
from deeplearning4j_tpu_torch.text.word2vec import Word2Vec, WordVectorsModel


class WordVectorSerializer:

    @staticmethod
    def writeWord2VecModel(model: WordVectorsModel, path: str):
        """Standard text format with "<vocab> <dim>" header
        (ref: writeWord2VecModel)."""
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "wt") as f:
            f.write(f"{model.vocab.numWords()} {model.layerSize}\n")
            for i in range(model.vocab.numWords()):
                vec = " ".join(f"{v:.6f}" for v in model.syn0[i])
                f.write(f"{model.vocab.wordAtIndex(i)} {vec}\n")

    @staticmethod
    def readWord2VecModel(path: str, device=None) -> Word2Vec:
        """(ref: readWord2VecModel / loadTxtVectors)."""
        device = default_device(device)
        opener = gzip.open if path.endswith(".gz") else open
        words, vecs = [], []
        with opener(path, "rt") as f:
            first = f.readline().split()
            header = len(first) == 2  # "<vocab> <dim>"
            if not header:
                words.append(first[0])
                vecs.append([float(v) for v in first[1:]])
            for line in f:
                parts = line.rstrip("\n").split(" ")
                if len(parts) < 2:
                    continue
                words.append(parts[0])
                vecs.append([float(v) for v in parts[1:] if v])
        model = Word2Vec(layerSize=len(vecs[0]), device=device)
        for w in words:
            model.vocab.addToken(w)
        model.vocab.finalize_vocab(1)
        # preserve file order: re-index by appearance
        syn0 = np.zeros((len(words), len(vecs[0])), np.float32)
        for w, v in zip(words, vecs):
            syn0[model.vocab.indexOf(w)] = v
        model.syn0 = syn0
        return model

    loadTxtVectors = readWord2VecModel

    # ------------------------------------------------- Google binary format
    @staticmethod
    def writeBinaryModel(model: WordVectorsModel, path: str):
        """Google News word2vec .bin format: "<vocab> <dim>\\n" then per word
        "<word> " + dim*float32 little-endian (ref: writeBinary path of
        WordVectorSerializer)."""
        with open(path, "wb") as f:
            f.write(f"{model.vocab.numWords()} {model.layerSize}\n".encode())
            for i in range(model.vocab.numWords()):
                f.write(model.vocab.wordAtIndex(i).encode("utf-8") + b" ")
                f.write(np.asarray(model.syn0[i], np.float32).tobytes())
                f.write(b"\n")

    @staticmethod
    def readBinaryModel(path: str, device=None) -> Word2Vec:
        """(ref: readBinaryModel — streams the Google News .bin format)."""
        device = default_device(device)
        with open(path, "rb") as f:
            header = f.readline().split()
            vocab_size, dim = int(header[0]), int(header[1])
            model = Word2Vec(layerSize=dim, device=device)
            vecs = np.zeros((vocab_size, dim), np.float32)
            words = []
            for _ in range(vocab_size):
                chars = bytearray()
                while True:
                    c = f.read(1)
                    if c in (b" ", b""):
                        break
                    if c != b"\n":  # leading newline from previous record
                        chars.extend(c)
                words.append(chars.decode("utf-8"))
                vecs[len(words) - 1] = np.frombuffer(
                    f.read(4 * dim), dtype="<f4")
        for w in words:
            model.vocab.addToken(w)
        model.vocab.finalize_vocab(1)
        syn0 = np.zeros_like(vecs)
        for w, v in zip(words, vecs):
            syn0[model.vocab.indexOf(w)] = v
        model.syn0 = syn0
        return model

    # ------------------------------------------------- ParagraphVectors serde
    @staticmethod
    def writeParagraphVectors(model, path: str):
        """npz container: word tables + doc labels/vectors
        (ref: writeParagraphVectors zip format)."""
        from deeplearning4j_tpu_torch.text.paragraph_vectors import ParagraphVectors
        assert isinstance(model, ParagraphVectors)
        words = [model.vocab.wordAtIndex(i)
                 for i in range(model.vocab.numWords())]
        np.savez_compressed(
            path,
            words=np.array(words, dtype=object),
            syn0=np.asarray(model.syn0, np.float32),
            syn1=np.asarray(model._syn1, np.float32),  # inferVector needs it
            doc_labels=np.array(model.doc_labels, dtype=object),
            doc_vectors=np.asarray(model.doc_vectors, np.float32),
            layer_size=np.int64(model.layerSize))

    @staticmethod
    def readParagraphVectors(path: str, device=None):
        """(ref: readParagraphVectors). Each member is read once (the
        reference reads ``z["syn0"]`` anew, a whole decompression, for
        every word); the model is the reference's."""
        device = default_device(device)
        from deeplearning4j_tpu_torch.text.paragraph_vectors import ParagraphVectors
        z = np.load(path if str(path).endswith(".npz") else str(path) + ".npz",
                    allow_pickle=True)
        model = ParagraphVectors(layerSize=int(z["layer_size"]), device=device)
        words = [str(w) for w in z["words"]]
        for w in words:
            model.vocab.addToken(w)
        model.vocab.finalize_vocab(1)
        rows = [model.vocab.indexOf(w) for w in words]
        src0 = z["syn0"]
        syn0 = np.zeros_like(src0)
        syn1 = np.zeros_like(src0)
        syn0[rows] = src0
        if "syn1" in z:
            syn1[rows] = z["syn1"]
        model.syn0 = syn0
        model._syn1 = syn1
        model.doc_labels = [str(l) for l in z["doc_labels"]]
        model.doc_vectors = z["doc_vectors"]
        return model

    # ------------------------------------------------------- GloVe text load
    @staticmethod
    def loadGloveVectors(path: str, device=None) -> Word2Vec:
        """GloVe's headerless text format — same parser, header optional
        (ref: loadTxtVectors handles both)."""
        return WordVectorSerializer.readWord2VecModel(path, device)
