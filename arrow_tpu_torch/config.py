"""Runtime configuration (counterpart of ``arrow_tpu/config.py``)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Config:
    #: element padding unit for 1-D column buffers.  32 rows = one bitmap
    #: word, so a value buffer always covers whole validity/mask words.  The
    #: CUDA kernels take any length; nothing here needs a larger unit.
    pad_unit: int = 32


config = Config()


def set_config(**kwargs) -> Config:
    for k, v in kwargs.items():
        if not hasattr(config, k):
            raise AttributeError(f"unknown config field {k!r}")
        setattr(config, k, v)
    return config
