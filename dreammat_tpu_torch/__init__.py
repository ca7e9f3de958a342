"""dreammat_tpu_torch — the PyTorch/CUDA port of ``dreammat_tpu`` for one
NVIDIA H100.

Same component registry and config names as the JAX package, so a config
resolves the same way in both. Plain tensor code is PyTorch; every Pallas
kernel of the JAX package on the ported path is a hand-written CUDA kernel
under ``csrc/``, built at first use (``ops/kernels.py``).

The package never imports ``jax`` nor anything of ``dreammat_tpu``.
"""

__version__ = "0.1.0"

__modules__: dict = {}


def register(name: str):
    """Class decorator: register a component under ``name``."""

    def decorator(cls):
        if name in __modules__ and __modules__[name] is not cls:
            raise ValueError(f"component '{name}' already registered")
        __modules__[name] = cls
        cls.registry_name = name
        return cls

    return decorator


def find(name: str):
    """Look up a registered component class by name (importing built-ins lazily)."""
    if name not in __modules__:
        from dreammat_tpu_torch import data, models, systems  # noqa: F401
    if name not in __modules__:
        raise KeyError(
            f"unknown component '{name}'; known: {sorted(__modules__.keys())}"
        )
    return __modules__[name]


import logging as _logging

logger = _logging.getLogger("dreammat_tpu_torch")
if not logger.handlers:
    _h = _logging.StreamHandler()
    _h.setFormatter(_logging.Formatter("[dreammat-torch] %(levelname)s %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(_logging.INFO)


def info(msg, *a):
    logger.info(msg, *a)


def warn(msg, *a):
    logger.warning(msg, *a)


def debug(msg, *a):
    logger.debug(msg, *a)
