"""Build and load one kernel extension from ``kernels/csrc``.

Every extension is built for ``sm_90a`` by ``torch.utils.cpp_extension.load``
at first use (never at import) into its own directory under
``kernels/_build/``, so two extensions can be built at the same time without
sharing ninja's build file or ``load``'s lock. Each binding ``.cpp`` includes
only pybind11, and each ``.cu`` has a plain C interface, so a build takes
seconds rather than the minutes PyTorch's headers cost.
"""

from __future__ import annotations

from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "_build"


def load_extension(name: str, sources: list[str]):
    """Compile (or load from ``_build/<name>``) the given ``csrc`` sources as
    the Python module ``fl4health_<name>``. Needs ``nvcc``."""
    from torch.utils.cpp_extension import load

    build_dir = BUILD / name
    build_dir.mkdir(parents=True, exist_ok=True)
    return load(
        name=f"fl4health_{name}",
        sources=[str(CSRC / s) for s in sources],
        build_directory=str(build_dir),
        extra_cflags=["-O2"],
        extra_cuda_cflags=["-O3", "-std=c++17",
                           "-gencode=arch=compute_90a,code=sm_90a"],
    )
