"""The fold every kernel Function's ``vmap`` rule makes: the vmapped axis
joins the kernel's own leading axis, so one launch serves every client."""

from __future__ import annotations

import torch


def fold_vmapped(x: torch.Tensor, bdim: int | None, size: int
                 ) -> tuple[torch.Tensor, bool]:
    """``(folded, copied)``: ``x`` with its vmapped axis ``bdim`` moved to
    the front (or, unbatched, expanded over ``size`` with stride 0) and
    merged into the next axis, ``[size, N, ...] -> [size * N, ...]``. A
    view whenever the two axes step evenly (an expanded input keeps stride
    0 if ``N`` is 1); else a copy, and ``copied`` says so."""
    x = x.movedim(bdim, 0) if bdim is not None else x.expand(size, *x.shape)
    shape = (size * x.shape[1], *x.shape[2:])
    try:
        return x.view(shape), False
    except (RuntimeError, ValueError):  # a fake tensor's refusal is a ValueError
        return x.reshape(shape), True
