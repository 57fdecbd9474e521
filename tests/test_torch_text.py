"""The port's text embeddings (``deeplearning4j_tpu_torch/text``) held
against the JAX package's on the CPU.

- Tokenizers, sentence iterators and the vocabulary are copies: equal
  tokens, words, indices, and the unigram and keep-probability arrays
  bit for bit.
- The steps (``_mean_scatter``, ``_sg_step``, ``_cbow_step``,
  ``_glove_step``, ``_ft_sg_step``) on batches with duplicate rows and
  negatives equal to the positive: within ``STEP_TOL`` of the largest
  |value| of the reference's output. One step rounds each element a few
  times in float32; the dot products sum in another order (XLA's dot,
  torch's sum), so a few ulps of the largest value.
- The host stream: the port's numpy pair builder, shuffle and negative
  draws give the reference's loop's pairs, ``rng.shuffle``'s order and
  ``rng.choice``'s draws, and leave the generator where those leave it.
- Fits (``Word2Vec`` skip-gram and CBOW, ``ParagraphVectors``, ``Glove``,
  ``FastText``) on the reference tests' corpora: the same vocabulary,
  tables within ``FIT_TOL`` of the reference's largest |value|, the same
  ``wordsNearest``. Every batch is the reference's (the same draws), so
  only float rounding separates the tables: a few ulps a step over
  hundreds of steps; measured up to 2.3e-6, held to 1e-5.
- ``WordVectorSerializer`` writes the reference's bytes in every format
  (gzip's header holds a time stamp: there the decompressed bytes), and
  each package reads the other's files.
- Every model's ``device`` default raises without CUDA.
"""
import gzip
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.text as R
import deeplearning4j_tpu.text.fasttext as RF
import deeplearning4j_tpu.text.glove as RG
import deeplearning4j_tpu.text.word2vec as RW
import deeplearning4j_tpu_torch.text as P
import deeplearning4j_tpu_torch.text.fasttext as PF
import deeplearning4j_tpu_torch.text.glove as PG
import deeplearning4j_tpu_torch.text.word2vec as PW
import test_longtail_components as RL
import test_text as RT
from deeplearning4j_tpu.text.paragraph_vectors import LabelledDocument as RDoc
from deeplearning4j_tpu_torch.text.paragraph_vectors import LabelledDocument as PDoc
from torch_threads import one_torch_thread  # noqa: F401

STEP_TOL = 1e-6
FIT_TOL = 1e-5

_mean_scatter_jit = jax.jit(RW._mean_scatter)


def _within(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got.astype(np.float64) - want).max()
    bound = tol * max(np.abs(want).max(), 1e-30)
    assert err <= bound, f"{what}: {err:.3e} > {bound:.3e}"


def _larger_corpus():
    """``test_text.test_word2vec_convergence_larger_corpus``'s corpus."""
    rng = np.random.default_rng(42)
    topics = [[f"t{k}w{i}" for i in range(8)] for k in range(3)]
    return [" ".join(rng.choice(topics[rng.integers(0, 3)], size=8))
            for _ in range(600)], topics


# ----------------------------------------------------- copies of the host


def test_tokenizers_iterators_vocab_equal(tmp_path):
    text = "Hello, World! 123 foo (bar) baz; A.B q/r"
    for pre in (None, R.CommonPreprocessor, R.LowCasePreProcessor):
        rt, pt = R.DefaultTokenizerFactory(), P.DefaultTokenizerFactory()
        if pre is not None:
            rt.setTokenPreProcessor(pre())
            pt.setTokenPreProcessor(getattr(P, pre.__name__)())
        assert pt.create(text).getTokens() == rt.create(text).getTokens()
    assert (P.NGramTokenizerFactory(1, 3).create("a b c d").getTokens()
            == R.NGramTokenizerFactory(1, 3).create("a b c d").getTokens())
    tok = P.DefaultTokenizerFactory().create("x y z")
    assert tok.countTokens() == 3 and tok.nextToken() == "x" and tok.hasMoreTokens()

    p = tmp_path / "corpus.txt"
    p.write_text("line one\n\n  line two  \nthree\n")
    assert list(P.BasicLineIterator(str(p))) == list(R.BasicLineIterator(str(p)))
    assert list(P.LineSentenceIterator(str(p))) == ["line one", "line two", "three"]
    sents = RT._corpus(50)
    assert list(P.CollectionSentenceIterator(sents)) == list(R.CollectionSentenceIterator(sents))

    words = " ".join(RT._corpus(300)).split() + ["rare"]
    for min_freq in (1, 2, 200):
        rv, pv = R.VocabCache(), P.VocabCache()
        for w in words:
            rv.addToken(w)
            pv.addToken(w)
        rv.finalize_vocab(min_freq)
        pv.finalize_vocab(min_freq)
        assert pv.words() == rv.words() and pv.numWords() == rv.numWords()
        assert [pv.indexOf(w) for w in set(words)] == [rv.indexOf(w) for w in set(words)]
        assert pv.totalWordOccurrences() == rv.totalWordOccurrences()
        for got, want in ((pv.unigram_table(), rv.unigram_table()),
                          (pv.unigram_table(0.5), rv.unigram_table(0.5)),
                          (pv.subsample_keep_prob(1e-3), rv.subsample_keep_prob(1e-3)),
                          (pv.subsample_keep_prob(1e-5), rv.subsample_keep_prob(1e-5))):
            assert got.dtype == want.dtype and np.array_equal(got, want)


def _reference_pairs(sentences, keep, window, rng):
    """The reference's pair loop (``Word2Vec.fit``), the oracle."""
    pairs = []
    for ids in sentences:
        if keep is not None:
            ids = ids[rng.random(len(ids)) < keep[ids]]
        for i, c in enumerate(ids):
            b = rng.integers(1, window + 1)
            lo, hi = max(0, i - b), min(len(ids), i + b + 1)
            for j in range(lo, hi):
                if j != i:
                    pairs.append((c, ids[j]))
    return np.asarray(pairs, dtype=np.int32).reshape(-1, 2)


@pytest.mark.parametrize("window,sampling", [(1, None), (5, None), (5, 0.3)])
def test_pairs_equal_the_reference_loop(window, sampling):
    rng = np.random.default_rng(3)
    sentences = [rng.integers(0, 40, size=int(n)).astype(np.int32)
                 for n in rng.integers(0, 30, size=60)]
    keep = None if sampling is None else rng.random(40).astype(np.float32) + sampling
    r1, r2 = np.random.default_rng(11), np.random.default_rng(11)
    want = _reference_pairs(sentences, keep, window, r1)
    got = PW.sentence_pairs(sentences, keep, window, r2)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert r1.random() == r2.random()   # the generators stand at one place


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_shuffle_and_negative_draws_equal_numpys(dtype):
    """``shuffle_rows`` and ``UnigramDraws`` against the calls they stand
    for (``rng.shuffle`` of the pairs, ``rng.choice`` over the table)."""
    r1, r2 = np.random.default_rng(8), np.random.default_rng(8)
    p = np.random.default_rng(1).random(997).astype(dtype) ** 3
    p = (p / p.sum()).astype(dtype)
    draws = PW.UnigramDraws(p)
    for n in (0, 1, 513):
        a = np.random.default_rng(n).integers(0, 50, (n, 2)).astype(np.int32)
        want = a.copy()
        r1.shuffle(want)
        assert np.array_equal(PW.shuffle_rows(r2, a), want)
        want = r1.choice(len(p), size=(n, 5), p=p).astype(np.int32)
        got = draws(r2, (n, 5))
        assert got.dtype == np.int32 and np.array_equal(got, want)
    assert r1.random() == r2.random()


# ------------------------------------------------------------ the steps


def _tables(rng, V, D, zero_second=False):
    a = ((rng.random((V, D), np.float32) - 0.5) / D)
    b = np.zeros((V, D), np.float32) if zero_second else \
        ((rng.random((V, D), np.float32) - 0.5) / D)
    return a, b


def _batch(rng, V, B, K):
    """Few rows, so every batch repeats rows; negatives hit the positive."""
    center = rng.integers(0, V, B).astype(np.int32)
    ctx = rng.integers(0, V, B).astype(np.int32)
    neg = rng.integers(0, V, (B, K)).astype(np.int32)
    neg[::3, 0] = ctx[::3]
    return center, ctx, neg


def _t(*arrs):
    return [torch.from_numpy(np.array(a, dtype=np.int64 if a.dtype.kind == "i"
                                      else a.dtype)) for a in arrs]


@pytest.mark.parametrize("weighted", [False, True])
def test_mean_scatter(weighted):
    rng = np.random.default_rng(1)
    V, D, N = 7, 5, 64
    table = rng.normal(size=(V, D)).astype(np.float32)
    idx = rng.integers(0, V, N).astype(np.int32)
    grads = rng.normal(size=(N, D)).astype(np.float32)
    w = (rng.random(N) < 0.6).astype(np.float32) if weighted else None
    want = _mean_scatter_jit(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(grads),
                             0.05, None if w is None else jnp.asarray(w))
    got = PW._mean_scatter(torch.from_numpy(table.copy()), *_t(idx),
                           torch.from_numpy(grads), 0.05,
                           None if w is None else torch.from_numpy(w))
    _within(got.numpy(), np.asarray(want), STEP_TOL, "mean_scatter")


@pytest.mark.parametrize("V,D,B,K", [(9, 16, 48, 4), (50, 32, 96, 5)])
def test_sg_and_cbow_steps(V, D, B, K):
    rng = np.random.default_rng(V)
    syn0, syn1 = _tables(rng, V, D)
    center, ctx, neg = _batch(rng, V, B, K)
    want = RW._sg_step_jit(jnp.asarray(syn0), jnp.asarray(syn1), jnp.asarray(center),
                           jnp.asarray(ctx), jnp.asarray(neg), 0.025)
    got = PW._sg_step(torch.from_numpy(syn0.copy()), torch.from_numpy(syn1.copy()),
                      *_t(center, ctx, neg), 0.025)
    for g, w, name in zip(got, want, ("syn0", "syn1")):
        _within(g.numpy(), np.asarray(w), STEP_TOL, f"sg {name}")

    W = 3
    win = rng.integers(0, V, (B, W)).astype(np.int32)
    mask = (rng.random((B, W)) < 0.7).astype(np.float32)
    mask[:5] = 0.0                       # empty windows: the denominator's floor
    want = RW._cbow_step_jit(jnp.asarray(syn0), jnp.asarray(syn1), jnp.asarray(win),
                             jnp.asarray(mask), jnp.asarray(ctx), jnp.asarray(neg), 0.05)
    got = PW._cbow_step(torch.from_numpy(syn0.copy()), torch.from_numpy(syn1.copy()),
                        *_t(win), torch.from_numpy(mask), *_t(ctx, neg), 0.05)
    for g, w, name in zip(got, want, ("syn0", "syn1")):
        _within(g.numpy(), np.asarray(w), STEP_TOL, f"cbow {name}")


def test_glove_step():
    rng = np.random.default_rng(5)
    V, D, B = 11, 12, 128
    w, wt = _tables(rng, V, D)
    b, bt = (rng.normal(size=V).astype(np.float32) * 0.1 for _ in range(2))
    hw, hwt = (rng.random((V, D)).astype(np.float32) for _ in range(2))
    hb, hbt = (rng.random(V).astype(np.float32) for _ in range(2))
    ci = rng.integers(0, V, B).astype(np.int32)
    cj = rng.integers(0, V, B).astype(np.int32)
    cx = (rng.random(B) * 150 + 0.1).astype(np.float32)   # past xMax too
    state = (w, wt, b, bt, hw, hwt, hb, hbt)
    want = RG._glove_step_jit(*map(jnp.asarray, state), jnp.asarray(ci), jnp.asarray(cj),
                              jnp.asarray(cx), 100.0, 0.75, 0.05)
    got = PG._glove_step(*(torch.from_numpy(a.copy()) for a in state), *_t(ci, cj),
                         torch.from_numpy(cx), 100.0, 0.75, 0.05)
    names = ("w", "wt", "b", "bt", "hw", "hwt", "hb", "hbt", "loss")
    for g, wv, name in zip(got, want, names):
        _within(g.numpy(), np.asarray(wv), STEP_TOL, f"glove {name}")


def test_ft_sg_step():
    rng = np.random.default_rng(7)
    V, bucket, D, B, K, M = 13, 40, 8, 64, 3, 6
    syn0 = ((rng.random((V + bucket, D), np.float32) - 0.5) / D)
    syn1 = rng.normal(size=(V, D)).astype(np.float32) * 0.1
    sub = rng.integers(0, V + bucket, (B, M)).astype(np.int32)
    mask = (rng.random((B, M)) < 0.6).astype(np.float32)
    mask[:, 0] = 1.0
    _, ctx, neg = _batch(rng, V, B, K)
    want = RF._ft_sg_step(jnp.asarray(syn0), jnp.asarray(syn1), jnp.asarray(sub),
                          jnp.asarray(mask), jnp.asarray(ctx), jnp.asarray(neg), 0.05)
    got = PF._ft_sg_step(torch.from_numpy(syn0.copy()), torch.from_numpy(syn1.copy()),
                         *_t(sub), torch.from_numpy(mask), *_t(ctx, neg), 0.05)
    for g, w, name in zip(got, want, ("syn0", "syn1")):
        _within(g.numpy(), np.asarray(w), STEP_TOL, f"ft {name}")


def test_ngrams_and_hashes():
    for word in ("fox", "日本語", "a", "quick"):
        assert PF._ngrams(word, 3, 6) == RF._ngrams(word, 3, 6)
    grams = [g for w in ("héllo", "日本語", "plain", "x") for g in RF._ngrams(w, 1, 6)]
    for bucket in (7, 2_000_000):
        want = [RF._hash(g, bucket) for g in grams]
        assert [PF._hash(g, bucket) for g in grams] == want
        assert PF._hash_many(grams, bucket).tolist() == want


# ----------------------------------------------------------------- fits


def _fit_pair(rcls, pcls, sentences, **kw):
    ref = rcls(iterate=R.CollectionSentenceIterator(sentences), **kw).fit()
    port = pcls(iterate=P.CollectionSentenceIterator(sentences), device="cpu",
                **kw).fit()
    assert port.vocab.words() == ref.vocab.words()
    return ref, port


W2V_CASES = {
    "skipgram": (RT._corpus(), dict(minWordFrequency=1, layerSize=16, seed=1,
                                    windowSize=3, epochs=3, learningRate=0.05,
                                    negativeSample=4), ["cat", "gpu"]),
    "cbow": (RT._corpus(200, seed=3), dict(minWordFrequency=1, layerSize=12, seed=2,
                                           windowSize=3, epochs=2,
                                           elementsLearningAlgorithm="CBOW"),
             ["cat", "ram"]),
    "larger": (_larger_corpus()[0], dict(minWordFrequency=1, layerSize=24, seed=9,
                                         windowSize=4, epochs=3, learningRate=0.05,
                                         negativeSample=5), ["t0w0", "t1w0", "t2w0"]),
    "subsampled": (RT._corpus(120, seed=5), dict(layerSize=8, seed=4, sampling=0.05,
                                                 iterations=2, epochs=2), ["dog"]),
}


@pytest.mark.parametrize("case", sorted(W2V_CASES))
def test_word2vec_fit(case):
    sentences, kw, probes = W2V_CASES[case]
    ref, port = _fit_pair(R.Word2Vec, P.Word2Vec, sentences, **kw)
    _within(port.syn0, ref.syn0, FIT_TOL, f"{case} syn0")
    _within(port._syn1, ref._syn1, FIT_TOL, f"{case} syn1")
    for w in probes:
        assert port.wordsNearest(w, 3) == ref.wordsNearest(w, 3), w
        assert port.similarity(w, probes[0]) == pytest.approx(
            ref.similarity(w, probes[0]), abs=1e-4)


def test_word2vec_builder_and_lookups():
    b = (P.Word2Vec.Builder().layerSize(12).seed(2).windowSize(3).epochs(2)
         .elementsLearningAlgorithm("CBOW").device("cpu")
         .iterate(P.CollectionSentenceIterator(RT._corpus(40))))
    vec = b.build().fit()
    assert vec.getWordVector("cat").shape == (12,) and vec.getWordVector("zzz") is None
    assert vec.hasWord("dog") and np.isnan(vec.similarity("cat", "zzz"))
    assert vec.wordsNearest(vec.getWordVector("cat"), 2)[0] == "cat"
    assert vec.wordsNearest("zzz") == []


def test_paragraph_vectors_fit_and_infer():
    rows = ([(" ".join(["cat", "dog", "horse"] * 4), f"animal_{i}") for i in range(6)]
            + [(" ".join(["cpu", "gpu", "ram"] * 4), f"tech_{i}") for i in range(6)])
    kw = dict(layerSize=12, seed=5, epochs=10, learningRate=0.05)
    ref = R.ParagraphVectors(labelledDocuments=[RDoc(*r) for r in rows], **kw).fit()
    port = P.ParagraphVectors(labelledDocuments=[PDoc(*r) for r in rows],
                              device="cpu", **kw).fit()
    assert port.doc_labels == ref.doc_labels
    _within(port.doc_vectors, ref.doc_vectors, FIT_TOL, "doc vectors")
    _within(port.syn0, ref.syn0, FIT_TOL, "syn0")
    _within(port._syn1, ref._syn1, FIT_TOL, "syn1")
    _within(port.inferVector("dog horse cat"), ref.inferVector("dog horse cat"),
            FIT_TOL, "inferVector")
    for label in ("animal_1", "tech_1"):
        assert port.similarityToLabel("dog horse cat", label) == pytest.approx(
            ref.similarityToLabel("dog horse cat", label), abs=1e-4)
    assert port.getVectorForLabel("nope") is None


def test_glove_fit():
    kw = dict(layerSize=12, seed=6, iterations=30, windowSize=3, learningRate=0.1)
    ref, port = _fit_pair(R.Glove, P.Glove, RT._corpus(400), **kw)
    _within(port.syn0, ref.syn0, FIT_TOL, "glove")
    assert port.wordsNearest("cat", 3) == ref.wordsNearest("cat", 3)
    with pytest.raises(ValueError, match="empty co-occurrence"):
        P.Glove(iterate=P.CollectionSentenceIterator(["solo"]), device="cpu").fit()


@pytest.mark.parametrize("extra", [{}, {"sampling": 1e-4}], ids=["plain", "subsampled"])
def test_fasttext_fit(extra):
    kw = dict(minWordFrequency=1, layerSize=16, epochs=3, seed=7, bucket=512, **extra)
    ref, port = _fit_pair(R.FastText, P.FastText, RL.CORPUS, **kw)
    assert np.array_equal(port._sub_ids, ref._sub_ids)
    assert np.array_equal(port._sub_mask, ref._sub_mask)
    _within(port._bucket_table, ref._bucket_table, FIT_TOL, "bucket table")
    _within(port.syn0, ref.syn0, FIT_TOL, "word vectors")
    assert not port.hasWord("foxxes")
    _within(port.getWordVector("foxxes"), ref.getWordVector("foxxes"), FIT_TOL, "oov")
    assert port.wordsNearest("fox", 3) == ref.wordsNearest("fox", 3)
    ft = P.FastText.Builder().layerSize(8).bucket(64).minn(2).maxn(3).device("cpu").build()
    assert (ft.layerSize, ft.bucket, ft.minn, ft.maxn) == (8, 64, 2, 3)
    assert ft.getOOVVector("abc") is None        # nothing fitted yet


# ----------------------------------------------------------- serializer


def _model_pair(words, syn0):
    ref, port = R.Word2Vec(layerSize=syn0.shape[1]), P.Word2Vec(
        layerSize=syn0.shape[1], device="cpu")
    for m in (ref, port):
        for w in words:
            m.vocab.addToken(w)
        m.vocab.finalize_vocab(1)
        m.syn0 = syn0
    return ref, port


@pytest.mark.parametrize("fmt", ["txt", "txt.gz", "bin"])
def test_serializer_word2vec_formats(tmp_path, fmt):
    words = ["alpha", "beta", "héllo", "日本語", "gamma"]
    syn0 = np.random.default_rng(0).normal(size=(5, 7)).astype(np.float32)
    ref, port = _model_pair(words, syn0)
    rp, pp = str(tmp_path / f"ref.{fmt}"), str(tmp_path / f"port.{fmt}")
    write = "writeBinaryModel" if fmt == "bin" else "writeWord2VecModel"
    read = "readBinaryModel" if fmt == "bin" else "readWord2VecModel"
    getattr(R.WordVectorSerializer, write)(ref, rp)
    getattr(P.WordVectorSerializer, write)(port, pp)
    opener = gzip.open if fmt.endswith(".gz") else open
    with opener(rp, "rb") as a, opener(pp, "rb") as b:
        assert a.read() == b.read()
    # each package reads the other's file
    back_p = getattr(P.WordVectorSerializer, read)(rp, device="cpu")
    back_r = getattr(R.WordVectorSerializer, read)(pp)
    assert back_p.vocab.words() == back_r.vocab.words()
    assert np.array_equal(back_p.syn0, back_r.syn0)
    tol = 0 if fmt == "bin" else 5e-7     # the text format keeps 6 decimals
    np.testing.assert_allclose(back_p.getWordVector("日本語"), ref.getWordVector("日本語"),
                               atol=tol, rtol=0)


def test_serializer_glove_headerless(tmp_path):
    p = tmp_path / "glove.txt"
    p.write_text("king 1.0 2.0 3.0\nqueen 4.0 5.0 6.0\n")
    m = P.WordVectorSerializer.loadGloveVectors(str(p), device="cpu")
    r = R.WordVectorSerializer.loadGloveVectors(str(p))
    assert m.vocab.words() == r.vocab.words() and np.array_equal(m.syn0, r.syn0)
    t = P.WordVectorSerializer.loadTxtVectors(str(p), device="cpu")
    assert np.array_equal(t.syn0, m.syn0)


def test_serializer_paragraph_vectors(tmp_path):
    docs = [("the quick brown fox jumps", "a"), ("lazy dogs sleep deeply today", "b")]
    ref = R.ParagraphVectors(labelledDocuments=[RDoc(*d) for d in docs], layerSize=8,
                             epochs=3, minWordFrequency=1).fit()
    port = P.ParagraphVectors(labelledDocuments=[PDoc(*d) for d in docs], layerSize=8,
                              device="cpu")
    for w in ref.vocab.words():
        port.vocab.addToken(w)
    port.vocab.finalize_vocab(1)
    port.syn0, port._syn1 = ref.syn0, ref._syn1
    port.doc_labels, port.doc_vectors = ref.doc_labels, ref.doc_vectors
    rp, pp = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    R.WordVectorSerializer.writeParagraphVectors(ref, rp)
    P.WordVectorSerializer.writeParagraphVectors(port, pp)
    # the members' bytes (a zip entry's header holds its write time)
    with zipfile.ZipFile(rp) as a, zipfile.ZipFile(pp) as b:
        assert a.namelist() == b.namelist()
        for name in a.namelist():
            assert a.read(name) == b.read(name), name
    back_p = P.WordVectorSerializer.readParagraphVectors(rp, device="cpu")
    back_r = R.WordVectorSerializer.readParagraphVectors(pp)
    assert back_p.doc_labels == back_r.doc_labels == ["a", "b"]
    for a, b in ((back_p.syn0, back_r.syn0), (back_p._syn1, back_r._syn1),
                 (back_p.doc_vectors, back_r.doc_vectors)):
        assert np.array_equal(a, b)
    _within(back_p.inferVector("the quick fox"), ref.inferVector("the quick fox"),
            FIT_TOL, "inferVector after load")


# --------------------------------------------------------------- device


@pytest.mark.parametrize("make", [
    lambda: P.Word2Vec(), lambda: P.ParagraphVectors(), lambda: P.Glove(),
    lambda: P.FastText(), lambda: P.Word2Vec.Builder().build(),
    lambda: P.WordVectorSerializer.loadGloveVectors("unused")])
def test_device_default_needs_cuda(monkeypatch, make):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()
