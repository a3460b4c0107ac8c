"""Port parity for the on-device beam search and its n-gram LM:
tpu_asr_torch/ops/beam_search.py against JAX's ctc_beam_search_batched
and the host prefix-search oracle, ops/ngram_lm.py against JAX's NgramLM,
on the CPU, on numpy inputs from a seed.

Tolerances: tokens, lengths, automaton tables and ARPA bytes exact; scores
within 1e-4 (tests/test_beam_search.py's bound); LM log-probs within
1e-12 (the same float64 host arithmetic)."""

import tests.torch_threads  # noqa: F401  (first: CPU threads)
import json

import numpy as np
import pytest
import torch

from tpu_asr.ops.beam_search import \
    ctc_beam_search_batched as jax_beam_search
from tpu_asr.ops.decoding import CTCDecoding as JaxCTCDecoding
from tpu_asr.ops.ngram_lm import NgramLM as JaxNgramLM
from tpu_asr.ops.ngram_lm import \
    train_ngram_from_manifest as jax_train_from_manifest
from tpu_asr_torch.ops.beam_search import ctc_beam_search_batched
from tpu_asr_torch.ops.decoding import CTCDecoding, ctc_prefix_beam_search
from tpu_asr_torch.ops.ngram_lm import NgramLM, train_ngram_from_manifest

B, T, V = 4, 25, 8          # blank = V-1; the oracle's top-2W pruning is a
W = 8                       # no-op when 2W >= V: both searches exhaustive
TOL = 1e-4


def _rand_log_probs(seed, b=B, t=T, v=V):
    rng = np.random.default_rng(seed)
    x = rng.normal(scale=2.0, size=(b, t, v)).astype(np.float32)
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


def _both(lp, lens, **kw):
    """(port's (tokens, lens, scores), JAX's), numpy."""
    got = ctc_beam_search_batched(torch.from_numpy(lp),
                                  torch.from_numpy(lens), **kw)
    jkw = dict(kw)
    if "bigram_lm" in jkw:
        jkw["bigram_lm"] = np.asarray(jkw["bigram_lm"])
    want = jax_beam_search(lp, lens, **jkw)
    return ([g.numpy() for g in got], [np.asarray(w) for w in want])


def _assert_beams_equal(got, want):
    """Every finite beam: tokens and lengths equal, scores within TOL."""
    (tok, ln, sc), (jtok, jln, jsc) = got, want
    assert tok.dtype == np.int32 and ln.dtype == np.int32
    np.testing.assert_allclose(sc, jsc, rtol=TOL, atol=TOL)
    finite = jsc > -1e29
    np.testing.assert_array_equal(ln[finite], jln[finite])
    for b, w in zip(*np.nonzero(finite)):
        np.testing.assert_array_equal(tok[b, w, :ln[b, w]],
                                      jtok[b, w, :jln[b, w]])


def _assert_top_is_oracle(got, lp, lens, w=W, **kw):
    tok, ln, sc = got
    for i in range(lp.shape[0]):
        ref = ctc_prefix_beam_search(lp[i], int(lens[i]), w, **kw)[0]
        assert tok[i, 0, :ln[i, 0]].tolist() == ref.y_sequence, f"row {i}"
        np.testing.assert_allclose(sc[i, 0], ref.score, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_beam_parity_no_lm(seed):
    lp = _rand_log_probs(seed)
    lens = np.asarray([T, T - 3, T - 7, 5], np.int32)
    got, want = _both(lp, lens, beam_width=W)
    _assert_beams_equal(got, want)
    _assert_top_is_oracle(got, lp, lens)


def test_beam_parity_word_bonus():
    lp = _rand_log_probs(11)
    lens = np.full((B,), T, np.int32)
    got, want = _both(lp, lens, beam_width=W, word_bonus=0.8)
    _assert_beams_equal(got, want)
    _assert_top_is_oracle(got, lp, lens, word_bonus=0.8)


def test_beam_parity_bigram_lm():
    rng = np.random.default_rng(5)
    lm = rng.normal(scale=0.5, size=(V, V)).astype(np.float32)
    blank = V - 1
    lp = _rand_log_probs(6)
    lens = np.asarray([T, T - 2, 9, T], np.int32)
    got, want = _both(lp, lens, beam_width=W, bigram_lm=lm, lm_weight=0.7)
    _assert_beams_equal(got, want)
    _assert_top_is_oracle(
        got, lp, lens, lm_weight=0.7,
        lm_score_fn=lambda p, c: float(lm[p[-1] if p else blank, c]))


@pytest.mark.parametrize("seed", [0, 7])
def test_beam_parity_tiny_vocab_wide_beam(seed):
    """A beam wider than the finite candidates (V=3, W=8): -1e30 ties fill
    the slots, duplicate beams fold, and the stable sort must keep JAX's
    lower-index-first order among them."""
    v, w, t = 3, 8, 12
    lp = _rand_log_probs(seed, b=3, t=t, v=v)
    lens = np.asarray([t, t - 4, 3], np.int32)
    got, want = _both(lp, lens, beam_width=w, blank=v - 1)
    _assert_beams_equal(got, want)
    np.testing.assert_array_equal(got[0], want[0])
    _assert_top_is_oracle(got, lp, lens, w=w)


def test_beams_distinct_sorted_and_capped():
    lp = _rand_log_probs(4)
    lens = np.full((B,), T, np.int32)
    (tok, ln, sc), _ = _both(lp, lens, beam_width=W)
    for i in range(B):
        assert np.all(np.diff(sc[i]) <= 0)
        seqs = {tuple(tok[i, j, :ln[i, j]]) for j in range(W)
                if sc[i, j] > -1e29}
        assert len(seqs) == int((sc[i] > -1e29).sum())
    got, want = _both(lp, lens, beam_width=W, max_tokens=6)
    assert got[0].shape == (B, W, 6)
    np.testing.assert_array_equal(got[0], want[0])


def _train_tiny_lm(cls, order=3, vocab=V - 1, n_seqs=40, seed=9):
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, vocab, size=rng.integers(3, 12)).tolist()
            for _ in range(n_seqs)]
    return cls.train(seqs, order=order)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_ngram_lm_matches_jax(order, tmp_path):
    """Training, log_prob, score_sequence, the dense automaton and the ARPA
    file (byte-equal; loading it back gives JAX's loaded model)."""
    lm, jlm = _train_tiny_lm(NgramLM, order), _train_tiny_lm(JaxNgramLM,
                                                             order)
    assert lm.probs == jlm.probs and lm.backoffs == jlm.backoffs
    rng = np.random.default_rng(order)
    for _ in range(40):
        hist = rng.integers(0, V - 1, size=rng.integers(0, 6)).tolist()
        tok = int(rng.integers(0, V))
        assert lm.log_prob(hist, tok) == pytest.approx(
            jlm.log_prob(hist, tok), abs=1e-12)
        assert lm.score_sequence(hist) == pytest.approx(
            jlm.score_sequence(hist), abs=1e-12)
    for got, want in zip(lm.to_dense_automaton(V), jlm.to_dense_automaton(V),
                         strict=True):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    lm.save_arpa(str(tmp_path / "port.arpa"))
    jlm.save_arpa(str(tmp_path / "jax.arpa"))
    assert (tmp_path / "port.arpa").read_bytes() == \
        (tmp_path / "jax.arpa").read_bytes()
    back = NgramLM.load_arpa(str(tmp_path / "jax.arpa"))
    jback = JaxNgramLM.load_arpa(str(tmp_path / "jax.arpa"))
    assert back.probs == jback.probs and back.backoffs == jback.backoffs
    assert back._unk_logp == jback._unk_logp


def test_train_ngram_from_manifest_matches_jax(tmp_path):
    from tpu_asr.data.tokenizer import train_bpe as jax_train_bpe
    from tpu_asr_torch.data.tokenizer import train_bpe
    texts = ["the cat sat", "a dog ran far", "the dog sat", "", "a cat ran"]
    path = tmp_path / "m.jsonl"
    path.write_text("\n".join(json.dumps({"text": t}) for t in texts) + "\n")
    lm = train_ngram_from_manifest(str(path), train_bpe(texts, 24))
    jlm = jax_train_from_manifest(str(path), jax_train_bpe(texts, 24))
    assert lm.probs == jlm.probs and lm.backoffs == jlm.backoffs


def test_beam_parity_ngram_lm():
    """The beam with the compiled n-gram automaton against JAX's and
    against the host oracle with the LM's callback."""
    lm = _train_tiny_lm(NgramLM)
    tables = lm.to_dense_automaton(V)
    lp = _rand_log_probs(17)
    lens = np.asarray([T, T - 4, 7, T], np.int32)
    got, want = _both(lp, lens, beam_width=W, ngram_tables=tables,
                      lm_weight=0.6)
    _assert_beams_equal(got, want)
    _assert_top_is_oracle(got, lp, lens, lm_score_fn=lm.lm_score_fn(),
                          lm_weight=0.6)
    with pytest.raises(ValueError, match="not both"):
        ctc_beam_search_batched(torch.from_numpy(lp), torch.from_numpy(lens),
                                bigram_lm=np.zeros((V, V), np.float32),
                                ngram_tables=tables)


class _Tok:
    vocab_size = V - 1

    def ids_to_text(self, ids):
        return " ".join(str(i) for i in ids)

    def text_to_ids(self, text):
        return [int(x) for x in text.split()]


def test_ctcdecoding_beam_batch_ngram_lm_roundtrip(tmp_path):
    """CTCDecoding('beam_batch', ngram_lm=<ARPA path>) compiles the LM at
    first use and gives strategy 'beam' with the same LM's texts, and
    JAX's beam_batch texts and scores; plain beam_batch gives 'beam's."""
    lm = _train_tiny_lm(NgramLM)
    arpa = str(tmp_path / "lm.arpa")
    lm.save_arpa(arpa)
    lp = _rand_log_probs(21)
    lens = np.full((B,), T, np.int32)
    dev = CTCDecoding(_Tok(), "beam_batch", beam_width=W, ngram_lm=arpa)
    host = CTCDecoding(_Tok(), "beam", beam_width=W, ngram_lm=arpa)
    jdev = JaxCTCDecoding(_Tok(), "beam_batch", beam_width=W, ngram_lm=arpa)
    assert dev.ngram_tables is None and dev.lm_weight == 1.0
    got = dev.ctc_decoder_predictions_tensor(torch.from_numpy(lp),
                                             torch.from_numpy(lens), True)
    assert dev.ngram_tables is not None
    want = jdev.ctc_decoder_predictions_tensor(lp, lens, True)
    assert [h.text for h in got] == [h.text for h in want] == \
        host.ctc_decoder_predictions_tensor(lp, lens)
    np.testing.assert_allclose([h.score for h in got],
                               [h.score for h in want], rtol=TOL, atol=TOL)
    plain = CTCDecoding(_Tok(), "beam_batch", beam_width=W)
    assert plain.ctc_decoder_predictions_tensor(lp, lens) == CTCDecoding(
        _Tok(), "beam", beam_width=W).ctc_decoder_predictions_tensor(lp, lens)
