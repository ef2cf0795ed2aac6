"""The port's host modules against the JAX package's, on the CPU: the
YAML reader, the tokenizers, text normalization, letter-to-sound,
CER / WER, and the data pipeline (datasets, iterators, loaders) behind
the runner's ``build_data``.

Each is a copy of its JAX counterpart; these tests hold the copies equal
on the same inputs: every YAML under ``recipes/`` and ``config/`` loads to
the same dict; char, subword (a hand-built SentencePiece ``.model`` read
by the native parser, and a trained HF ``tokenizer.json``) and G2P ids
and decoded texts are the same; the runner's ``build_data`` yields the
same batches (keys, arrays, ``indices``, ``n_real``) over two epochs of a
small WAV set. No batch here takes the native FLAC fast path.
"""

import glob
import os
import wave as wavemod

import numpy as np
import pytest

from speechain_tpu.data import tokenizer as jtok
from speechain_tpu.runner import build_data as jbuild_data
from speechain_tpu.utils import letter_to_sound as jlts
from speechain_tpu.utils import metrics as jmetrics
from speechain_tpu.utils import textnorm as jtextnorm
from speechain_tpu.utils.yamlref import load_yaml as jload_yaml
from speechain_tpu_torch.data import tokenizer as ttok
from speechain_tpu_torch.runner import build_data as tbuild_data
from speechain_tpu_torch.utils import letter_to_sound as tlts
from speechain_tpu_torch.utils import metrics as tmetrics
from speechain_tpu_torch.utils import textnorm as ttextnorm
from speechain_tpu_torch.utils.yamlref import load_yaml as tload_yaml
from tests.test_sp_model import build_model as sp_model_bytes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(os.path.relpath(p, REPO) for pat in ("recipes", "config")
               for p in glob.glob(os.path.join(REPO, pat, "**", "*.yaml"),
                                  recursive=True))
TEXTS = ["hello world", "the quick brown fox", "a", "zebra  crossing xq",
         "it's the cat's toy", ""]
MARK = "▁"


def test_every_recipe_yaml_is_counted():
    assert len(YAMLS) == 73


@pytest.mark.parametrize("path", YAMLS)
def test_yaml_loads_equal(path):
    """Every recipe and config YAML: the same dict through both readers
    (the !ref / !tuple / !list / !str tags resolved)."""
    full = os.path.join(REPO, path)
    assert tload_yaml(full) == jload_yaml(full)


def write_wav(path, x, sr):
    with wavemod.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


TONES = "abcdefgh"


def make_wav_set(root, sizes=(("train", 10), ("valid", 4), ("test", 4)),
                 sr=8000, tone_len=600, seed=0):
    """A small tone data set like ``tests/test_runner.py``'s: each split's
    WAVs (3-5 tones of one of 8 pitches a token), idx2wav, idx2text,
    idx2wav_len, and a char vocab under ``root/token``."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "token"), exist_ok=True)
    with open(os.path.join(root, "token", "vocab"), "w") as f:
        f.write("\n".join(["<blank>", "<unk>"] + list(TONES)
                          + ["<sos/eos>"]) + "\n")
    for split, n in sizes:
        d = os.path.join(root, split)
        os.makedirs(os.path.join(d, "wav"), exist_ok=True)
        files = {"idx2wav": [], "idx2text": [], "idx2wav_len": []}
        for i in range(n):
            toks = rng.randint(0, len(TONES), size=int(rng.randint(3, 6)))
            t = np.arange(tone_len) / sr
            sig = np.concatenate([0.7 * np.sin(2 * np.pi * (350 + 220 * k)
                                               * t) for k in toks])
            idx = f"{split}_{i:03d}"
            path = os.path.join(d, "wav", idx + ".wav")
            write_wav(path, sig, sr)
            files["idx2wav"].append(f"{idx} {path}")
            files["idx2text"].append(f"{idx} "
                                     + "".join(TONES[k] for k in toks))
            files["idx2wav_len"].append(f"{idx} {len(sig)}")
        for name, lines in files.items():
            with open(os.path.join(d, name), "w") as f:
                f.write("\n".join(lines) + "\n")
    return root


def data_cfg(root, batch_len=9000):
    def split(name, conf):
        return dict(dataset_type="speech_text", dataset_conf=dict(
            main_data=dict(wav=f"{root}/{name}/idx2wav",
                           text=f"{root}/{name}/idx2text")),
            data_len=f"{root}/{name}/idx2wav_len", **conf)
    return dict(train=dict(type="block", conf=split("train", dict(
                    shuffle=True, is_descending=True, batch_len=batch_len))),
                valid=dict(type="abs", conf=split("valid", dict(
                    shuffle=False, batch_size=3))))


def test_build_data_yields_the_same_batches(tmp_path):
    """The runner's build_data over two epochs of the train set (block
    batching, epoch-seeded shuffle) and one of the valid set: the same
    batches in the same order, key for key."""
    root = make_wav_set(str(tmp_path))
    cfg = data_cfg(root)
    jt = jtok.CharTokenizer(token_path=f"{root}/token")
    tt = ttok.CharTokenizer(token_path=f"{root}/token")
    n = 0
    for split, epochs in (("train", (1, 2)), ("valid", (1,))):
        jl = jbuild_data(cfg, split, jt, num_workers=2)
        tl = tbuild_data(cfg, split, tt, num_workers=2)
        assert len(jl) == len(tl)
        for epoch in epochs:
            jb, tb = list(jl.epoch(epoch)), list(tl.epoch(epoch))
            assert len(jb) == len(tb) > 1
            for a, b in zip(jb, tb):
                assert sorted(a) == sorted(b)
                for k in a:
                    if isinstance(a[k], np.ndarray):
                        assert a[k].dtype == b[k].dtype, k
                        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                    else:
                        assert a[k] == b[k], k
                n += 1
    order = [list(tl.epoch(e))[0]["indices"] for e in (1, 2)]
    assert order[0] != order[1] or n > 0
    assert n >= 5


def test_char_tokenizer_matches(tmp_path):
    vocab = ["<blank>", "<unk>", "<space>"] + list("abcdefghijklmnopqrstuvw'") \
        + ["<sos/eos>"]
    (tmp_path / "vocab").write_text("\n".join(vocab) + "\n")
    j = jtok.CharTokenizer(token_path=str(tmp_path))
    t = ttok.CharTokenizer(token_path=str(tmp_path))
    for text in TEXTS:
        for kw in ({}, dict(no_sos=True), dict(no_eos=True)):
            a, b = j.text2tensor(text, **kw), t.text2tensor(text, **kw)
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        assert j.tensor2text(a) == t.tensor2text(b)
    assert t.vocab_size == j.vocab_size == len(vocab)


def _sp_pieces():
    letters = list("abcdefghijklmnopqrstuvwxyz'")
    pieces = [("<unk>", 0.0, 2), (MARK, -3.0, 1)]
    pieces += [(c, -4.0, 1) for c in letters]
    pieces += [(MARK + c, -3.5, 1) for c in letters]
    pieces += [(p, -2.0 - 0.01 * i, 1) for i, p in enumerate(
        ["th", "he", "qu", "ck", "ow", "or", "ld", MARK + "the",
         MARK + "hel", "lo", MARK + "wor", "ing", MARK + "cat"])]
    return pieces


@pytest.mark.parametrize("model_type", [1, 2])
def test_subword_tokenizer_matches_on_a_hand_built_model(tmp_path,
                                                         model_type):
    """A hand-built SentencePiece ``model`` (unigram and BPE) read by the
    native parser on both sides: the same ids and decoded texts."""
    pieces = _sp_pieces()
    (tmp_path / "model").write_bytes(sp_model_bytes(pieces, model_type))
    vocab = ["<blank>", "<unk>"] + [p for p, _, t in pieces if t == 1] \
        + ["<sos/eos>"]
    (tmp_path / "vocab").write_text("\n".join(vocab) + "\n")
    j = jtok.SubwordTokenizer(token_path=str(tmp_path))
    t = ttok.SubwordTokenizer(token_path=str(tmp_path))
    assert t._sp_native is not None and j._sp_native is not None
    for text in TEXTS:
        a, b = j.text2tensor(text), t.text2tensor(text)
        np.testing.assert_array_equal(a, b)
        assert j.tensor2text(a) == t.tensor2text(b)
    assert len(t.text2tensor("the world")) < len("the world") + 2


def test_subword_tokenizer_matches_on_a_trained_tokenizer_json(tmp_path):
    """``train_subword_tokenizer`` (HF tokenizers) writes the same files
    from both packages, and either tokenizer reads them alike."""
    pytest.importorskip("tokenizers")
    corpus = TEXTS[:-1] * 20 + ["brown cats cross the world quickly"] * 5
    jdir = jtok.train_subword_tokenizer(corpus, str(tmp_path / "j"), 60)
    tdir = ttok.train_subword_tokenizer(corpus, str(tmp_path / "t"), 60)
    for f in ("vocab", "tokenizer.json"):
        assert (open(os.path.join(jdir, f)).read()
                == open(os.path.join(tdir, f)).read()), f
    j = jtok.SubwordTokenizer(token_path=jdir)
    t = ttok.SubwordTokenizer(token_path=jdir)
    for text in TEXTS:
        a, b = j.text2tensor(text), t.text2tensor(text)
        np.testing.assert_array_equal(a, b)
        assert j.tensor2text(a) == t.tensor2text(b)


def test_g2p_tokenizer_matches(tmp_path):
    """G2P: lexicon words, OOV words through letter-to-sound, phoneme-list
    input and the stress-stripped fallback."""
    phones = ["AH0", "B", "K", "AE1", "T", "DH", "HH", "L", "OW1", "W",
              "ER1", "D", "IY1", "Z", "EH1", "R", "S", "IH0", "N", "NG",
              "AA1", "M", "P", "F", "V", "Y", "G", "UW1", "AY1", "EY1",
              "OW", "AH"]
    vocab = ["<blank>", "<unk>", "<space>"] + phones + ["<sos/eos>"]
    (tmp_path / "vocab").write_text("\n".join(vocab) + "\n")
    (tmp_path / "lexicon").write_text(
        "hello\tHH AH0 L OW1\nworld W ER1 L D\nthe DH AH0\n")
    j = jtok.GraphemeToPhonemeTokenizer(token_path=str(tmp_path))
    t = ttok.GraphemeToPhonemeTokenizer(token_path=str(tmp_path))
    for text in TEXTS[:-1] + ["['HH', 'AH0', 'L', 'OW0']", "zyxt plover"]:
        a, b = j.text2tensor(text), t.text2tensor(text)
        np.testing.assert_array_equal(a, b)
        assert j.tensor2text(a) == t.tensor2text(b)
        assert j.g2p(text) == t.g2p(text)


NORM_TEXTS = ["Hello, World!", "It's  THE café--naïve   end.",
              "“Quoted”: 'single' -- dash/slash; semi", "A1 b2 æon",
              "don't stop' 'here", "rôle œuvre über ñ"]


@pytest.mark.parametrize("fmt", ["punc", "no-punc"])
def test_textnorm_matches(fmt):
    for text in NORM_TEXTS:
        assert ttextnorm.en_text_process(text, fmt) == \
            jtextnorm.en_text_process(text, fmt)


def test_letter_to_sound_matches():
    words = ["hello", "through", "knight", "phone", "xylophone", "quick",
             "station", "judge", "cheese", "a", "strengths", "rhythm"]
    for w in words:
        for stress in (True, False):
            assert tlts.letter_to_sound(w, stress) == \
                jlts.letter_to_sound(w, stress)


def test_error_rates_match():
    hyps = ["the cat sat", "", "a b c d", "hello wrld", "x"]
    refs = ["the cat sat on", "nothing here", "a c d", "hello world", ""]
    assert tmetrics.batch_error_rates(hyps, refs) == \
        jmetrics.batch_error_rates(hyps, refs)
    for h, r in zip(hyps, refs):
        assert tmetrics.levenshtein_alignment(h.split(), r.split()) == \
            jmetrics.levenshtein_alignment(h.split(), r.split())


def test_registry_resolves_the_ports_components():
    from speechain_tpu_torch.data.dataset import SpeechTextDataset
    from speechain_tpu_torch.data.iterator import BlockIterator
    from speechain_tpu_torch.utils.registry import resolve
    assert resolve("iterator.block") is BlockIterator
    assert resolve("block.BlockIterator") is BlockIterator
    assert resolve("speech_text.SpeechTextDataset") is SpeechTextDataset
    assert resolve("data.iterator.BlockIterator") is BlockIterator
    with pytest.raises(KeyError):
        resolve("iterator.nonexistent")
