"""Build/runtime provenance.

The port's counterpart of ``clarabel_tpu/buildinfo.py`` (reference:
lib.rs:88-114, the vergen buildinfo feature): the version and the
toolchain a solve ran with -- PyTorch and its CUDA, the card, ``nvcc``,
whether the LDLᵀ kernels' library and the native symbolic engine are
built -- and the checkout's git revision.
"""

from __future__ import annotations

import platform
import shutil
import subprocess
from pathlib import Path


def _run(*cmd) -> str | None:
    """The command's standard output, or None where it fails."""
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=30,
                             cwd=Path(__file__).resolve().parents[1])
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def buildinfo() -> dict:
    import torch

    from . import __version__, native
    from .kkt import build

    info = {
        "version": __version__,
        "python": platform.python_version(),
        "system": platform.platform(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    if torch.cuda.is_available():
        info["device"] = torch.cuda.get_device_name(0)
        info["device_count"] = torch.cuda.device_count()
    try:
        nvcc = build._nvcc()
    except RuntimeError:
        nvcc = None
    if nvcc is not None:
        version = _run(nvcc, "--version")
        if version:  # "Cuda compilation tools, release 12.8, V12.8.93"
            lines = version.splitlines()
            info["nvcc"] = next((ln for ln in lines if "release" in ln), lines[-1])
    info["ldl_library_built"] = build.built("ldl.cu")
    info["native_symbolic"] = native.available()
    if shutil.which("git"):
        rev = _run("git", "rev-parse", "--short", "HEAD")
        if rev:
            info["git_rev"] = rev
    return info


def print_buildinfo() -> None:  # pragma: no cover - cosmetic
    for k, v in buildinfo().items():
        print(f"{k}: {v}")
