"""bench.py contract tests.

``main()`` prints its one JSON line only after a real GPU measurement: it
exits non-zero, printing no JSON line, on a malformed knob or without a GPU
(this suite runs on the CPU).  The device loop itself runs here on tiny
shapes through ``bench_device()``; its timings are CPU timings and are
never reported.
"""

import pathlib
import subprocess
import sys

import pytest

import bench

REPO = pathlib.Path(__file__).resolve().parent.parent


def _assert_rejected(capsys, rc, knob):
    captured = capsys.readouterr()
    assert rc != 0
    assert captured.out == ""  # no JSON line on failure
    assert knob in captured.err


def test_main_fails_fast_on_bad_preset(monkeypatch, capsys):
    monkeypatch.setattr(bench, "PRESET", "tentn")  # typo
    _assert_rejected(capsys, bench.main(), "BP_BENCH_PRESET")


def test_main_fails_fast_on_bad_num_envs(monkeypatch, capsys):
    """Malformed BP_BENCH_NUM_ENVS exits non-zero with a message, not an
    import/parse traceback."""
    for bad in ("49k", "0", "-5"):
        monkeypatch.setattr(bench, "NUM_ENVS_RAW", bad)
        _assert_rejected(capsys, bench.main(), "BP_BENCH_NUM_ENVS")


def test_main_fails_fast_on_bad_mask_dtype(monkeypatch, capsys):
    monkeypatch.setattr(bench, "MASK_DTYPE", "fp8")
    _assert_rejected(capsys, bench.main(), "BP_BENCH_MASK_DTYPE")


def test_main_fails_fast_on_contradictory_combo(monkeypatch, capsys):
    """packed state + a non-bitboard mask would raise inside make_env —
    rejected before any device work."""
    monkeypatch.setattr(bench, "STATE_IMPL", "packed")
    monkeypatch.setattr(bench, "MASK_IMPL", "shift")
    _assert_rejected(capsys, bench.main(), "BP_BENCH_STATE_IMPL=packed")


def test_main_fails_fast_on_words_sampler_without_packed(monkeypatch, capsys):
    """BP_BENCH_SAMPLER=words needs the packed engine: u8 state or a
    non-bitboard mask are rejected before the device loop."""
    for knob, bad in (("STATE_IMPL", "u8"), ("MASK_IMPL", "shift")):
        monkeypatch.setattr(bench, "SAMPLER", "words")
        monkeypatch.setattr(bench, knob, bad)
        _assert_rejected(capsys, bench.main(), "BP_BENCH_SAMPLER=words")
        monkeypatch.undo()


def test_main_fails_fast_on_bad_sampler(monkeypatch, capsys):
    monkeypatch.setattr(bench, "SAMPLER", "gumbel")
    _assert_rejected(capsys, bench.main(), "BP_BENCH_SAMPLER")


def test_main_exits_nonzero_without_gpu(capsys):
    """Valid knobs on the CPU backend: no measurement, no JSON line."""
    _assert_rejected(capsys, bench.main(), "needs a GPU")


def test_script_exits_nonzero_without_gpu():
    """The script as the user runs it, in its own process."""
    r = subprocess.run(
        [sys.executable, "bench.py"], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert r.returncode != 0
    assert r.stdout == ""


def _shrink(monkeypatch):
    monkeypatch.setattr(bench, "NUM_ENVS_RAW", "32")
    monkeypatch.setattr(bench, "CHUNK", 8)
    monkeypatch.setattr(bench, "ITERS", 2)
    monkeypatch.setattr(bench, "WINDOWS", 1)


def test_bench_device_words_sampler_runs(monkeypatch):
    """The words-sampler device loop runs end-to-end on tiny shapes and
    reports a positive rate — pins the BP_BENCH_SAMPLER=words wiring
    (carry init, step, re-mask)."""
    _shrink(monkeypatch)
    monkeypatch.setattr(bench, "SAMPLER", "words")
    assert bench.bench_device() > 0


def test_bench_device_default_sampler_runs(monkeypatch):
    """The headline path (argmax sampler, packed engine) runs end-to-end
    on tiny shapes."""
    _shrink(monkeypatch)
    assert bench.bench_device() > 0


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_bench_device_matmul_formulation_runs(monkeypatch, dtype):
    """The all-pieces matmul mask on the u8 layout — the formulation the
    retired hand kernels implemented, timed against the packed default
    on the GPU — runs through the same loop in both operand dtypes."""
    _shrink(monkeypatch)
    monkeypatch.setattr(bench, "STATE_IMPL", "u8")
    monkeypatch.setattr(bench, "MASK_IMPL", "matmul")
    monkeypatch.setattr(bench, "MASK_DTYPE", dtype)
    assert bench.knob_error() is None
    assert bench.bench_device() > 0


def test_bench_oracle_runs():
    """The single-env oracle baseline needs only NumPy (no gymnasium)."""
    assert bench.bench_oracle(max_steps=50) > 0
