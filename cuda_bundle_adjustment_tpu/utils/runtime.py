"""Process set-up shared by the entry scripts and the tests: where JAX keeps
its persistent compile cache, and the device check of the GPU entry points."""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

# fixed cache directory inside the checkout (listed in .gitignore): the path
# is part of the cache key, so a directory that moves never hits
CACHE_DIRNAME = ".jax_cache"
REPO_ROOT = Path(__file__).resolve().parents[2]


def compile_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        REPO_ROOT / CACHE_DIRNAME
    )


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set JAX already reads it, and no
    other directory is set here."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return compile_cache_dir()


# XLA:GPU compiles each program's LLVM module on one thread unless told
# otherwise; the fused LM loop is a large program, so its cold compile is
# split over threads.  Part of the configuration: the entry points set these
# before the backend starts, and print them.
XLA_GPU_FLAGS = (
    "--xla_gpu_enable_llvm_module_compilation_parallelism=true",
    "--xla_gpu_force_compilation_parallelism=16",
)


def set_xla_gpu_flags() -> str:
    """Append :data:`XLA_GPU_FLAGS` to ``XLA_FLAGS`` (a flag already given
    there wins).  Takes effect only before the first backend use."""
    given = os.environ.get("XLA_FLAGS", "")
    names = {f.split("=")[0] for f in given.split()}
    extra = [f for f in XLA_GPU_FLAGS if f.split("=")[0] not in names]
    os.environ["XLA_FLAGS"] = " ".join([given] + extra).strip()
    return os.environ["XLA_FLAGS"]


class NoGpuError(RuntimeError):
    """JAX found no GPU where the entry point needs one."""


def require_gpu():
    """The JAX devices, if they are GPUs; :class:`NoGpuError` otherwise (no
    fallback to another backend)."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise NoGpuError(
            f"needs a GPU; JAX found {devices[0].platform!r} devices "
            f"({devices[0].device_kind})"
        )
    return devices


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi``'s ``name, power.limit`` line for every card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()
