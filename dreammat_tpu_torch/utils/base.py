"""Component base class (counterpart of ``dreammat_tpu/utils/base.py``).

A component is a configured object: an inner ``Config`` dataclass parsed
from a dict, then a ``configure(*args)`` hook. Learnable state lives in
``nn.Module``s or plain tensors owned by the component.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from dreammat_tpu_torch.utils.config import parse_structured


class BaseObject:
    @dataclass
    class Config:
        pass

    cfg: Any

    def __init__(self, cfg: Optional[dict] = None, *args, **kwargs) -> None:
        if isinstance(cfg, self.Config):
            self.cfg = cfg
        else:
            self.cfg = parse_structured(self.Config, cfg)
        self.configure(*args, **kwargs)

    def configure(self, *args, **kwargs) -> None:
        pass
