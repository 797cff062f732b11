"""Port parity: utils/data.py against the JAX package's utils/data.py.  The
port's TokenLoader gives JAX's Python loader's batches, shuffled and
sequential (with the wrap), on both of its engines: the Python one, and
the native one over the C ABI of the repository's cpp/dataloader.cpp,
built by the port's g++ route into build/loader/ (skipped without g++).
A shard too short for one window is refused by both engines."""

import shutil

import numpy as np
import pytest

from cuda_flash_attention_tpu.utils import data as jax_data
from cuda_flash_attention_tpu_torch.utils import data


def _shard(tmp_path, n=5000, seed=0, vocab=32000):
    path = tmp_path / "tokens.bin"
    data.write_token_file(path, np.random.default_rng(seed).integers(
        0, vocab, size=n, dtype=np.int32))
    return path


@pytest.fixture(scope="module")
def native():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native loader")
    return data.build_native()


def test_write_token_file_is_jax_bytes(tmp_path):
    tokens = np.random.default_rng(1).integers(-5, 1 << 30, 300)
    data.write_token_file(tmp_path / "a.bin", tokens)
    jax_data.write_token_file(str(tmp_path / "b.bin"), tokens)
    assert (tmp_path / "a.bin").read_bytes() == (tmp_path / "b.bin").read_bytes()
    assert len((tmp_path / "a.bin").read_bytes()) == 4 * 300


@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffled", "sequential"])
@pytest.mark.parametrize("engine", ["python", "native"])
def test_batches_match_jax(tmp_path, shuffle, engine, request):
    if engine == "native":
        request.getfixturevalue("native")
    # 700 tokens, windows of 100: the sequential walk wraps inside 3 batches.
    path = _shard(tmp_path, n=700 if not shuffle else 5000)
    kw = dict(batch=3, seq_len=99, seed=42, shuffle=shuffle)
    with data.TokenLoader(path, native=engine == "native", **kw) as mine, \
            jax_data.TokenLoader(str(path), native=False, **kw) as ref:
        assert mine.native == (engine == "native")
        assert mine.n_tokens == ref.n_tokens
        for _ in range(4):
            got, want = next(mine), next(ref)
            assert got.dtype == np.int32 and got.shape == (3, 100)
            np.testing.assert_array_equal(got, want)


def test_sequential_wraps_to_the_start(tmp_path):
    path = _shard(tmp_path, n=300)
    tokens = np.fromfile(path, dtype="<i4")
    with data.TokenLoader(path, batch=2, seq_len=99, shuffle=False, native=False) as it:
        b1, b2 = next(it), next(it)
    np.testing.assert_array_equal(b1, tokens[:200].reshape(2, 100))
    np.testing.assert_array_equal(b2[0], tokens[200:300])
    np.testing.assert_array_equal(b2[1], tokens[0:100])


def test_native_equals_python_over_many_batches(tmp_path, native):
    path = _shard(tmp_path, seed=3)
    kw = dict(batch=8, seq_len=127, seed=7, prefetch=2)
    with data.TokenLoader(path, native=True, **kw) as nat, \
            data.TokenLoader(path, native=False, **kw) as py:
        for _ in range(12):
            np.testing.assert_array_equal(next(nat), next(py))
    assert native.parent == data.BUILD_DIR and native.name.startswith("libcfa_loader-")


@pytest.mark.parametrize("engine", ["python", "native"])
def test_short_shard_is_refused(tmp_path, engine, request):
    if engine == "native":
        request.getfixturevalue("native")
    path = _shard(tmp_path, n=64)
    with pytest.raises(OSError, match="needs > seq_len"):
        data.TokenLoader(path, batch=1, seq_len=63, native=engine == "native")
    with pytest.raises(OSError, match="needs > seq_len"):
        jax_data.TokenLoader(str(path), batch=1, seq_len=63, native=False)


def test_native_true_raises_when_it_cannot_build(tmp_path, monkeypatch):
    monkeypatch.setattr(data, "SOURCE", tmp_path / "missing.cpp")
    path = _shard(tmp_path)
    with pytest.raises((RuntimeError, OSError)):
        data.TokenLoader(path, batch=1, seq_len=15, native=True)
    # native=None falls back to the Python engine.
    with data.TokenLoader(path, batch=1, seq_len=15, native=None) as it:
        assert not it.native and next(it).shape == (1, 16)
