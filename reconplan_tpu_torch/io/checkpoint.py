"""Roadmap checkpointing as .npz arrays.

Copy of ``reconplan_tpu.io.checkpoint`` (numpy only): versioned flat
arrays, portable, mmap-able, and loadable straight onto a device with
``torch.as_tensor``.
"""

from __future__ import annotations

import numpy as np

FORMAT_VERSION = 1


def save_roadmap_npz(path, **arrays):
    """Save named roadmap arrays (points, configs, CSR edges, flags...)."""
    np.savez_compressed(path, __version__=FORMAT_VERSION, **arrays)


def load_roadmap_npz(path) -> dict:
    with np.load(path, allow_pickle=False) as z:
        data = {k: z[k] for k in z.files if k != "__version__"}
        if "__version__" in z.files and int(z["__version__"]) > FORMAT_VERSION:
            raise ValueError(
                f"roadmap {path} written by newer format "
                f"{int(z['__version__'])} > {FORMAT_VERSION}"
            )
    return data
