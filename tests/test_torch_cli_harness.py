"""Port parity: the CLI, the .bin format, the config matrix and the harness
of cuda_flash_attention_tpu_torch against the JAX package's.

A data directory written by one package loads in the other byte for byte;
the same data directory run through both CLIs (the port's with --device
cpu, where the kernels' plain versions run) gives every written file within
the JAX fp32 gates (2e-6 on O, 1e-5 on lse and gradients, absolute); the
harness writes the reference's CSV columns, which are the JAX as_row keys.
"""

import csv
import dataclasses
import os
import shutil

import numpy as np
import pytest

from cuda_flash_attention_tpu import cli as jax_cli
from cuda_flash_attention_tpu.bench import configs as jax_configs
from cuda_flash_attention_tpu.bench import harness as jax_harness
from cuda_flash_attention_tpu.utils import io as jax_io
from cuda_flash_attention_tpu_torch import cli
from cuda_flash_attention_tpu_torch.bench import configs, harness
from cuda_flash_attention_tpu_torch.utils import io

TOL = {"O.bin": 2e-6, "logsumexp.bin": 1e-5, "dQ.bin": 1e-5, "dK.bin": 1e-5,
       "dV.bin": 1e-5}


@pytest.mark.parametrize("path", ["data/B2_H8_S512_D64", "/x/y/B1_H1_S100_D32/",
                                  "B8_H16_S2048_D64"])
def test_parse_config_string_matches_jax(path):
    assert io.parse_config_string(path) == jax_io.parse_config_string(path)
    assert io.data_dir_name(*io.parse_config_string(path)) == \
        os.path.basename(os.path.normpath(path))


def test_bad_dir_name_raises():
    with pytest.raises(ValueError):
        io.parse_config_string("data/batch2_h8")


def test_bin_files_cross_between_packages(tmp_path):
    x = np.random.default_rng(0).standard_normal((2, 3, 4, 5)).astype(np.float32)
    io.save_binary_file(str(tmp_path / "port.bin"), x)
    jax_io.save_binary_file(str(tmp_path / "jax.bin"), x)
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()
    np.testing.assert_array_equal(io.load_binary_file(str(tmp_path / "jax.bin"), x.shape), x)
    np.testing.assert_array_equal(
        jax_io.load_binary_file(str(tmp_path / "port.bin"), x.shape), x)
    with pytest.raises(ValueError, match="expected"):
        io.load_binary_file(str(tmp_path / "port.bin"), (2, 3, 4, 6))


def _data_dir(root, b=1, h=2, s=100, d=64, seed=3):
    rng = np.random.default_rng(seed)
    ddir = root / io.data_dir_name(b, h, s, d)
    ddir.mkdir(parents=True)
    for name in ("Q", "K", "V"):
        rng.random((b, h, s, d), dtype=np.float32).tofile(ddir / f"{name}.bin")
    return ddir


def _run_both(tmp_path, argv_tail, with_do=False):
    """One data dir, copied, run through each CLI; returns both dirs."""
    src = _data_dir(tmp_path / "src")
    if with_do:
        np.random.default_rng(9).standard_normal((1, 2, 100, 64)).astype(
            np.float32).tofile(src / "dO.bin")
    dirs = {}
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        ddir = tmp_path / name / src.name
        shutil.copytree(src, ddir)
        extra = ["--device", "cpu"] if name == "port" else []
        for argv in argv_tail:
            assert main([*argv[:3], str(ddir), *argv[3:], *extra]) == 0
        dirs[name] = ddir
    return dirs


@pytest.mark.parametrize("runs,with_do", [
    ([("fa2", "forward", "fp32"), ("fa2", "backward", "fp32")], False),
    ([("fa2", "forward_backward", "fp32", "--causal")], True),
    ([("fa1", "forward", "fp32")], False),
    ([("fa2-naive", "forward", "fp32")], False),
    ([("naive", "forward", "fp32")], False),
], ids=["fa2-fwd-then-bwd", "fa2-both-causal-dO", "fa1", "fa2-naive", "naive"])
def test_cli_writes_what_the_jax_cli_writes(tmp_path, runs, with_do):
    dirs = _run_both(tmp_path, runs, with_do)
    jax_files = sorted(os.listdir(dirs["jax"]))
    assert sorted(os.listdir(dirs["port"])) == jax_files
    for name in jax_files:
        a = np.fromfile(dirs["port"] / name, dtype="<f4")
        b = np.fromfile(dirs["jax"] / name, dtype="<f4")
        assert a.shape == b.shape, name
        if name in TOL:
            np.testing.assert_allclose(a, b, atol=TOL[name], rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)  # inputs


def test_baselines_write_no_logsumexp(tmp_path):
    ddir = _data_dir(tmp_path)
    assert cli.main(["fa1", "forward", "fp32", str(ddir), "--device", "cpu"]) == 0
    assert sorted(os.listdir(ddir)) == ["K.bin", "O.bin", "Q.bin", "V.bin"]


def test_backward_needs_forward_artifacts(tmp_path, capsys):
    ddir = _data_dir(tmp_path)
    assert cli.main(["fa2", "backward", "fp32", str(ddir), "--device", "cpu"]) == 1
    assert "O.bin and logsumexp.bin" in capsys.readouterr().err
    with pytest.raises(FileNotFoundError):
        cli.run("fa2", "backward", "fp32", str(ddir), device="cpu")


@pytest.mark.parametrize("argv,code", [
    ([], 2),
    (["fa2", "forward", "fp32"], 2),
    (["fa2", "forward", "fp32", "DIR", "extra"], 2),
    (["fa2", "forward", "fp32", "DIR", "--device"], 2),
    (["fa3", "forward", "fp32", "DIR"], 1),          # unknown method
    (["fa1", "backward", "fp32", "DIR"], 1),          # baselines: forward only
    (["fa2-naive", "forward", "bf16", "DIR"], 1),     # baselines: fp32 only
    (["fa1", "forward", "fp32", "DIR", "--causal"], 1),
    (["fa2", "forward", "fp32", "not_a_config_dir"], 1),
])
def test_exit_codes_match_jax(tmp_path, argv, code):
    ddir = str(_data_dir(tmp_path))
    argv = [ddir if a == "DIR" else a for a in argv]
    tail = ["--device", "cpu"] if len(argv) >= 4 and "--device" not in argv else []
    assert cli.main(argv + tail) == code
    assert jax_cli.main(argv) == code


def test_naive_is_the_oracle_not_fa2_naive(tmp_path):
    """`naive` writes O and logsumexp (the materialized oracle gives an
    lse); fa2-naive writes no logsumexp."""
    ddir = _data_dir(tmp_path)
    out = cli.run("naive", "forward", "fp32", str(ddir), device="cpu")
    assert out["lse"] is not None
    assert "logsumexp.bin" in os.listdir(ddir)


def test_config_matrix_matches_jax():
    for mode in ("forward", "backward", "both"):
        for make in ("create_experiment_configs",
                     "create_sequence_length_experiment_configs"):
            got = [dataclasses.asdict(c) for c in getattr(configs, make)(mode)]
            want = [dataclasses.asdict(c) for c in getattr(jax_configs, make)(mode)]
            assert got == want
    assert [dataclasses.asdict(c) for c in configs.create_sequence_length_experiment_configs(
        extended=True)] == [dataclasses.asdict(c) for c in
                            jax_configs.create_sequence_length_experiment_configs(
                                extended=True)]


def test_harness_csv_has_the_jax_columns(tmp_path):
    """Two configs through Harness.run on the CPU: both pass, no time is
    taken (there is no device), and the CSV header is the JAX as_row keys."""
    cfgs = [c for c in configs.create_test_configs() if c.name in
            ("Small-1", "Edge-SmallSeq")]
    h = harness.Harness(device="cpu", verbose=False)
    results = h.run(cfgs)
    assert [r.passed for r in results] == [True, True]
    assert all(np.isnan(r.kernel_time_ms) for r in results)
    path = tmp_path / "results.csv"
    h.save_csv(str(path))
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    jax_keys = list(jax_harness.TestResult(
        config=jax_configs.TestConfig("x", 1, 1, 1, 1), test_type="forward",
        passed=True).as_row())
    assert list(rows[0]) == jax_keys == list(results[0].as_row())
    assert [r["Test"] for r in rows] == ["Small-1", "Edge-SmallSeq"]
    assert {r["Status"] for r in rows} == {"PASS"}
    assert "Per-kernel averages" in h.summary()


def test_harness_turns_an_exception_into_a_fail_row_and_stops():
    bad = configs.TestConfig("Bad", 1, 1, 32, 48)  # head_dim 48 is refused
    good = configs.TestConfig("Good", 1, 1, 32, 64)
    results = harness.Harness(device="cpu", verbose=False).run([bad, good])
    assert len(results) == 1 and not results[0].passed
    assert results[0].error_message.startswith("ValueError")
