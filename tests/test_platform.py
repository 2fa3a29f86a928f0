"""Device selection: ``--platform gpu`` (the default) never falls back to
the CPU, and the roofline peak table refuses devices it does not know."""

import importlib.util
import pathlib

import pytest

from blockpuzzle_tpu.utils import select_platform

REPO = pathlib.Path(__file__).resolve().parent.parent


def _roofline():
    spec = importlib.util.spec_from_file_location(
        "roofline", REPO / "scripts" / "roofline.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_select_platform_gpu_fails_loudly_on_cpu():
    with pytest.raises(SystemExit, match="--platform cpu"):
        select_platform("gpu")


@pytest.mark.parametrize("cli", ["train", "evaluate"])
def test_cli_default_platform_refuses_the_cpu(cli, tmp_path):
    """The CLIs' default is the GPU: on a CPU-only backend they stop before
    any work instead of training on the CPU unnoticed."""
    from blockpuzzle_tpu.cli import evaluate, train

    argv = {"train": ["--updates", "1", "--num-envs", "8"],
            "evaluate": ["--checkpoint-dir", str(tmp_path / "none")]}[cli]
    with pytest.raises(SystemExit, match="--platform cpu"):
        {"train": train, "evaluate": evaluate}[cli].main(argv)


def test_roofline_peaks_for_h100():
    peaks = _roofline().peaks_for("NVIDIA H100 80GB HBM3")
    assert peaks == {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}


def test_roofline_refuses_unknown_device_kind():
    with pytest.raises(ValueError, match="no published peaks"):
        _roofline().peaks_for("Some Other Accelerator")
