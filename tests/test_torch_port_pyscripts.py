"""The port's data-preparation CLIs (``speechain_tpu_torch/pyscripts``)
against the JAX package's (``speechain_tpu/pyscripts``), on the CPU.

Each CLI runs twice on the same tiny generated layout with the same
flags, the JAX script first and the port's second, into the same output
folder (emptied between the two, so absolute paths inside the files
agree): every file written must be byte-equal and the printed lines
equal. ``meta_generator`` runs once for each corpus layout (LibriSpeech,
LJSpeech, LibriTTS, VCTK); ``pitch_extractor``'s ``.npy`` tracks are byte-
and array-equal; ``data_packager``'s chunk files (zip and hdf5 containers
record their write time) are compared array by array;
``distribution_visualizer`` and ``data_packager --comp_format hdf5`` run
where matplotlib and h5py import, as their scripts import them lazily.
"""

import contextlib
import importlib
import io
import shutil

import numpy as np
import pytest

import chip_smoke
from speechain_tpu_torch.utils.fileio import write_wav

SR = 16000


def _wave(n, seed):
    return chip_smoke.speech_like(n, np.random.default_rng(seed))


def _snapshot(out):
    return {str(p.relative_to(out)): p.read_bytes()
            for p in sorted(out.rglob("*")) if p.is_file()}


def both(name, argv, out, setup=None, compare=None):
    """Run the JAX and the port's ``name`` CLI on ``argv``; ``out`` (a
    folder only the CLI writes to) emptied before each, ``setup`` run
    before each; the files written and the printed lines must be equal
    (``compare(a_files, b_files)`` replaces the byte check where given).
    Returns the port's files."""
    runs = []
    for pkg in ("speechain_tpu", "speechain_tpu_torch"):
        mod = importlib.import_module(f"{pkg}.pyscripts.{name}")
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        if setup is not None:
            setup()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            mod.main([str(a) for a in argv])
        runs.append((_snapshot(out), printed.getvalue()))
    (a, pa), (b, pb) = runs
    assert a, f"{name} wrote nothing"
    assert pa == pb
    if compare is None:
        assert a == b
    else:
        compare(a, b)
    return b


# ---- the corpus layouts ---------------------------------------------------

def _librispeech(src):
    for spk, chap in (("19", "198"), ("26", "495")):
        d = src / "train-clean-5" / spk / chap
        d.mkdir(parents=True)
        lines = []
        for i in range(2):
            idx = f"{spk}-{chap}-{i:04d}"
            (d / f"{idx}.flac").write_bytes(b"fLaC")
            lines.append(f"{idx} HELLO WORLD NUMBER {i}, SAID {spk}.")
        (d / f"{spk}-{chap}.trans.txt").write_text("\n".join(lines) + "\n")


def _ljspeech(src):
    (src / "wavs").mkdir(parents=True)
    rows = []
    for i in range(3):
        idx = f"LJ001-{i:04d}"
        write_wav(str(src / "wavs" / f"{idx}.wav"), _wave(2000, i), SR)
        rows.append(f"{idx}|Raw text {i}; Mr. Smith's dog.|"
                    + ("" if i == 1 else f"Normalized text {i}, Mister."))
    (src / "metadata.csv").write_text("\n".join(rows) + "\n")


def _libritts(src):
    for spk, chap in (("84", "121123"), ("174", "50561")):
        d = src / spk / chap
        d.mkdir(parents=True)
        for i in range(2):
            idx = f"{spk}_{chap}_{i:06d}_000000"
            write_wav(str(d / f"{idx}.wav"), _wave(1600, i), SR)
            kind = "original" if i else "normalized"
            (d / f"{idx}.{kind}.txt").write_text(f"It was {kind} {i}!\n")


def _vctk(src):
    for spk in ("p225", "p226"):
        (src / "wav48_silence_trimmed" / spk).mkdir(parents=True)
        (src / "txt" / spk).mkdir(parents=True)
        for i in range(1, 3):
            idx = f"{spk}_{i:03d}"
            for mic in ("mic1", "mic2"):
                (src / "wav48_silence_trimmed" / spk /
                 f"{idx}_{mic}.flac").write_bytes(b"fLaC")
            (src / "txt" / spk / f"{idx}.txt").write_text(
                f"Please call Stella {i}.\n")


LAYOUTS = dict(librispeech=_librispeech, ljspeech=_ljspeech,
               libritts=_libritts, vctk=_vctk)


@pytest.mark.parametrize("dataset", sorted(LAYOUTS))
def test_meta_generator(tmp_path, dataset):
    src = tmp_path / "src"
    LAYOUTS[dataset](src)
    out = tmp_path / "out"
    files = both("meta_generator", ["--dataset", dataset, "--src_path", src,
                                    "--save_path", out, "--txt_format",
                                    "no-punc"], out)
    assert {"idx2wav", "idx2text", "idx2spk", "idx2no-punc_text"} == \
        set(files)
    assert len(files["idx2wav"].splitlines()) >= 3


@pytest.fixture
def lj(tmp_path):
    """An LJSpeech layout through the JAX meta_generator: the idx2 files
    the later CLIs read."""
    from speechain_tpu.pyscripts import meta_generator
    src = tmp_path / "src"
    _ljspeech(src)
    data = tmp_path / "data"
    with contextlib.redirect_stdout(io.StringIO()):
        meta_generator.main(["--dataset", "ljspeech", "--src_path",
                             str(src), "--save_path", str(data)])
    return tmp_path, data


def test_meta_post_processor(tmp_path):
    src = tmp_path / "src"
    for sub, n in (("train-clean-100", 2), ("train-clean-360", 3),
                   ("dev-clean", 1)):
        (src / sub).mkdir(parents=True)
        for name in ("idx2wav", "idx2text"):
            (src / sub / name).write_text("".join(
                f"{sub}-{i} {name}-{i}\n" for i in range(n)))
        (src / sub / "idx2extra").write_text("a b\n")

    def pristine():
        for sub in ("train-clean-100", "train-clean-360", "dev-clean"):
            shutil.copytree(src / sub, tmp_path / "work" / sub)

    files = both("meta_post_processor", [
        "--src_path", tmp_path / "work", "--dataset", "librispeech",
        "--combine", "mine=train-clean-360,dev-clean"], tmp_path / "work",
        setup=pristine)
    assert "train-clean-460/idx2wav" in files and "mine/idx2extra" in files
    assert "train-960/idx2wav" not in files       # a member is missing


def test_text_dumper_and_lab_file_generator(lj):
    tmp, data = lj
    out = tmp / "out"
    both("text_dumper", ["--text_path", data / "idx2text", "--txt_format",
                         "punc", "--save_path", out / "idx2punc_text"], out)
    labs = both("lab_file_generator", ["--wav_path", data / "idx2wav",
                                       "--text_path", data / "idx2text",
                                       "--save_path", out], out)
    assert len(labs) == 3 and all(k.endswith(".lab") for k in labs)


def test_duration_calculator(tmp_path):
    grids = tmp_path / "grids"
    grids.mkdir()
    rng = np.random.default_rng(2)
    for i, secs in enumerate((1.234567, 2.5, 0.9)):
        words, phones = chip_smoke.tts_alignment(
            chip_smoke.tts_sentence(rng), secs, rng)
        chip_smoke.write_textgrid(grids / f"utt{i}.TextGrid",
                                  [("words", words), ("phones", phones)],
                                  secs)
    out = tmp_path / "out"
    files = both("duration_calculator", ["--textgrid_path", grids,
                                         "--save_path", out,
                                         "--hop_length", "0.0125"], out)
    lines = files["idx2duration"].decode().splitlines()
    assert len(lines) == 3
    # cumulative rounding at the hop: the frames add up to the last xmax
    totals = {ln.split()[0]: sum(map(int, ln.split()[1:])) for ln in lines}
    assert totals == {"utt0": round(1.234567 / 0.0125),
                      "utt1": 200, "utt2": round(0.9 / 0.0125)}
    # the words tier by --tier
    both("duration_calculator", ["--textgrid_path", grids, "--save_path",
                                 out, "--tier", "words"], out)


def test_pitch_extractor(lj):
    tmp, data = lj
    out = tmp / "out"
    files = both("pitch_extractor", ["--wav_path", data / "idx2wav",
                                     "--save_path", out, "--sr", SR,
                                     "--continuous_f0", "false"], out)
    npys = [k for k in files if k.endswith(".npy")]
    assert len(npys) == 3
    for k in npys:
        f0 = np.load(io.BytesIO(files[k]))
        assert f0.dtype == np.float32 and f0.shape[0] > 0


def test_data_len_generator(lj):
    tmp, data = lj
    out = tmp / "out"
    lens = both("data_len_generator", ["--data_path", data / "idx2wav",
                                       "--save_path", out / "idx2wav_len"],
                out)
    assert lens["idx2wav_len"].decode().split()[1] == "2000"
    both("data_len_generator", ["--data_path", data / "idx2text",
                                "--is_text", "--save_path",
                                out / "idx2text_len"], out)


@pytest.mark.parametrize("token_type", ["char", "word", "subword"])
def test_vocab_generator(lj, token_type):
    tmp, data = lj
    out = tmp / "out"
    files = both("vocab_generator", ["--text_path", data / "idx2text",
                                     "--save_path", out, "--token_type",
                                     token_type, "--vocab_size", 30], out)
    vocab = files["vocab"].decode().splitlines()
    assert vocab[:2] == ["<blank>", "<unk>"] and vocab[-1] == "<sos/eos>"
    if token_type == "subword":
        assert "tokenizer.json" in files


def test_wave_downsampler(lj):
    tmp, data = lj
    out = tmp / "out"
    files = both("wave_downsampler", ["--wav_path", data / "idx2wav",
                                      "--save_path", out, "--sample_rate",
                                      8000], out)
    assert files["idx2wav_len"].decode().split()[1] == "1000"


def test_empty_file_checker(lj):
    tmp, data = lj
    (tmp / "empty.wav").write_bytes(b"")
    idx2wav = data.joinpath("idx2wav").read_text() + (
        f"gone {tmp / 'missing.wav'}\nempty {tmp / 'empty.wav'}\n")
    out = tmp / "out"
    files = both("empty_file_checker", ["--data_path", out / "idx2wav",
                                        "--delete_bad"], out,
                 setup=lambda: (out / "idx2wav").write_text(idx2wav))
    assert len(files["idx2wav"].decode().splitlines()) == 3


def test_folder_summarizer(lj):
    tmp, _ = lj
    out = tmp / "out"
    files = both("folder_summarizer", ["--src_folder", tmp / "src",
                                       "--save_path", out], out)
    assert len(files["idx2wav"].decode().splitlines()) == 3
    both("folder_summarizer", ["--src_folder", tmp / "src", "--save_path",
                               out, "--ext", "csv", "--name", "idx2meta"],
         out)


def _same_arrays(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if k.endswith((".npz", ".hdf5")):
            assert _arrays(k, a[k]) == _arrays(k, b[k]), k
        else:
            assert a[k] == b[k], k


def _arrays(name, raw):
    if name.endswith(".npz"):
        with np.load(io.BytesIO(raw)) as z:
            return {k: z[k].tobytes() for k in z.files}
    import h5py
    with h5py.File(io.BytesIO(raw), "r") as f:
        return {k: np.asarray(f[k]).tobytes() for k in f}


@pytest.mark.parametrize("fmt", ["npz", "hdf5"])
def test_data_packager(tmp_path, fmt):
    if fmt == "hdf5":
        pytest.importorskip("h5py")
    feats = tmp_path / "feats"
    feats.mkdir()
    lines = []
    for i in range(5):
        p = feats / f"u{i}.npy"
        np.save(p, np.random.default_rng(i).standard_normal(
            (4 + i, 3)).astype(np.float32))
        lines.append(f"u{i} {p}")
    (tmp_path / "idx2feat").write_text("\n".join(lines) + "\n")
    out = tmp_path / "out"
    files = both("data_packager", ["--data_path", tmp_path / "idx2feat",
                                   "--save_path", out, "--chunk_size", 2,
                                   "--comp_format", fmt], out,
                 compare=_same_arrays)
    assert len([k for k in files if k.startswith("chunk_")]) == 3


@pytest.mark.parametrize("mode", ["scalar", "text_len", "duration"])
def test_distribution_visualizer(tmp_path, mode):
    pytest.importorskip("matplotlib")
    values = {"scalar": lambda i: str(1000 + 37 * i),
              "text_len": lambda i: " ".join(["w"] * (1 + i % 4)),
              "duration": lambda i: " ".join(str(j + i % 3)
                                             for j in range(4))}[mode]
    data = tmp_path / "data"
    data.mkdir()
    (data / "idx2x").write_text("".join(f"u{i} {values(i)}\n"
                                        for i in range(12)))
    out = tmp_path / "out"
    files = both("distribution_visualizer", [
        "--data_path", data / "idx2x", "--save_path", out / "hist.png",
        "--bins", 5, "--mode", mode], out)
    assert files["hist.png"][:4] == b"\x89PNG"
