"""The ``--platform`` choice shared by the CLIs and scripts.

``gpu`` (the default) requires JAX to have found a GPU and stops with an
error otherwise, so a run meant for the card never proceeds on the CPU
unnoticed.  ``cpu`` forces the CPU backend (tests, debugging); it must be
chosen before any backend initializes.
"""

from __future__ import annotations

import argparse
import subprocess

import jax

PLATFORMS = ("gpu", "cpu")


def add_platform_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--platform", choices=PLATFORMS, default="gpu",
        help="gpu: require a GPU (default; fails without one); "
             "cpu: force the CPU backend (tests, debug runs)",
    )


def select_platform(platform: str) -> None:
    """Apply a ``--platform`` value; SystemExit when ``gpu`` finds none."""
    if platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
        return
    backend = jax.default_backend()
    if backend != platform:
        raise SystemExit(
            f"--platform {platform}: JAX's backend is {backend!r} "
            f"(devices: {jax.devices()}); pass --platform cpu to run on "
            f"the CPU on purpose"
        )


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of each visible card, one CSV
    line per card (e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``).  A card set
    below its maximum power runs slower under load, so every measurement
    is reported beside this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()
