"""Config system: YAML + dotted CLI overrides + dataclass validation + resolvers.

Reproduces the semantics of the reference config layer
(threestudio_dreammat/threestudio/utils/config.py:11-123)
without OmegaConf: nested-dict configs loaded from YAML, merged with
``key.path=value`` dot-list overrides, ``${...}`` interpolation with custom
resolvers, and per-component structured parsing into dataclasses.
"""

from __future__ import annotations

import dataclasses
import os
import re
from dataclasses import dataclass, field, fields, is_dataclass
from datetime import datetime
from typing import Any, Dict, List, Optional

import yaml

# ---------------------------------------------------------------------------
# resolvers (reference config.py:11-27)
# ---------------------------------------------------------------------------

_RESOLVERS = {
    "rmspace": lambda s, sub: s.replace(" ", sub),
    "add": lambda a, b: float(a) + float(b),
    "sub": lambda a, b: float(a) - float(b),
    "mul": lambda a, b: float(a) * float(b),
    "div": lambda a, b: float(a) / float(b),
    "idiv": lambda a, b: int(a) // int(b),
    "basename": lambda p: os.path.basename(str(p)),
}

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


def _lookup(root: dict, dotted: str):
    cur: Any = root
    for part in dotted.split("."):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        elif isinstance(cur, (list, tuple)) and part.lstrip("-").isdigit():
            cur = cur[int(part)]
        else:
            raise KeyError(f"cannot resolve interpolation '${{{dotted}}}'")
    return cur


def _resolve_str(s: str, root: dict, depth: int = 0):
    """Resolve ${path} and ${resolver:arg0,arg1} expressions in a string."""
    if depth > 10:
        raise RecursionError(f"interpolation too deep: {s}")

    def repl(m: "re.Match"):
        expr = m.group(1)
        if ":" in expr:
            name, _, argstr = expr.partition(":")
            if name in _RESOLVERS:
                args = [
                    _resolve_str(a, root, depth + 1) if "${" in a else a
                    for a in argstr.split(",")
                ]
                return str(_RESOLVERS[name](*args))
        val = _lookup(root, expr)
        return str(val)

    prev = None
    while prev != s and "${" in s:
        prev = s
        s = _INTERP_RE.sub(repl, s)
    return s


def resolve_interpolations(cfg: dict, root: Optional[dict] = None):
    """Recursively resolve ${...} interpolation in all string values."""
    if root is None:
        root = cfg

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, str) and "${" in node:
            out = _resolve_str(node, root)
            try:  # re-typed scalars ("3" -> 3)
                return yaml.safe_load(out)
            except yaml.YAMLError:
                return out
        return node

    return walk(cfg)


# ---------------------------------------------------------------------------
# merging + dot-list overrides
# ---------------------------------------------------------------------------

def merge_dicts(base: dict, override: dict) -> dict:
    """Deep merge; a key ending in ``!`` REPLACES the base subtree instead
    of merging into it (``system.guidance!={...}`` — needed when an
    override switches a component type and the base keys would be invalid
    for the new component's Config)."""
    out = dict(base)
    for k, v in override.items():
        if k.endswith("!"):
            out.pop(k[:-1], None)
            out[k[:-1]] = v
        elif k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_dicts(out[k], v)
        else:
            out[k] = v
    return out


def parse_dotlist(dotlist: List[str]) -> dict:
    """Parse ['a.b=1', 'c=[2,3]'] into a nested dict. Values parsed as YAML."""
    out: dict = {}
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"override '{item}' is not of form key=value")
        key, _, raw = item.partition("=")
        try:
            val = yaml.safe_load(raw)
        except yaml.YAMLError:
            val = raw
        cur = out
        parts = key.strip().split(".")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = val
    return out


# ---------------------------------------------------------------------------
# structured dataclass parsing (reference config.py:121-123 parse_structured)
# ---------------------------------------------------------------------------

MISSING = "???"


def parse_structured(cls, cfg: Optional[dict] = None):
    """Instantiate dataclass ``cls`` from a nested dict.

    - unknown keys raise (catching config typos, like OmegaConf structured mode)
    - ``'???'`` values (or missing required fields) raise if still unset
    - nested dataclass fields recurse
    """
    import typing

    cfg = dict(cfg or {})
    if not is_dataclass(cls):
        raise TypeError(f"{cls} is not a dataclass")
    kwargs = {}
    known = {f.name: f for f in fields(cls)}
    try:
        hints = typing.get_type_hints(cls)
    except Exception:
        hints = {}
    for key, val in cfg.items():
        if key not in known:
            raise ValueError(
                f"unknown config key '{key}' for {cls.__name__}; "
                f"known keys: {sorted(known.keys())}"
            )
        ftype = hints.get(key, known[key].type)
        if is_dataclass(ftype) and isinstance(val, dict):
            val = parse_structured(ftype, val)
        kwargs[key] = val
    inst = cls(**kwargs)
    for f in fields(cls):
        v = getattr(inst, f.name)
        if isinstance(v, str) and v == MISSING:
            raise ValueError(f"required config field '{f.name}' of {cls.__name__} unset ('???')")
    return inst


def config_to_primitive(x):
    if is_dataclass(x) and not isinstance(x, type):
        return {f.name: config_to_primitive(getattr(x, f.name)) for f in fields(x)}
    if isinstance(x, dict):
        return {k: config_to_primitive(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [config_to_primitive(v) for v in x]
    return x


# ---------------------------------------------------------------------------
# experiment config (reference config.py:46-96 ExperimentConfig)
# ---------------------------------------------------------------------------

@dataclass
class CheckpointConfig:
    save_last: bool = False
    save_top_k: int = -1
    every_n_train_steps: int = 4000


@dataclass
class TrainerConfig:
    max_steps: int = 30000
    log_every_n_steps: int = 1
    num_sanity_val_steps: int = 1
    val_check_interval: int = 100
    enable_progress_bar: bool = True
    precision: Any = 32


@dataclass
class ExperimentConfig:
    name: str = "default"
    tag: str = ""
    description: str = ""
    seed: int = 0
    use_timestamp: bool = True
    timestamp: Optional[str] = None
    exp_root_dir: str = "outputs"
    resume: Optional[str] = None

    data_type: str = MISSING
    data: dict = field(default_factory=dict)
    system_type: str = MISSING
    system: dict = field(default_factory=dict)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)

    n_gpus: int = 1

    @property
    def trial_name(self) -> str:
        return self.tag + (self.timestamp or "")

    @property
    def exp_dir(self) -> str:
        return os.path.join(self.exp_root_dir, self.name)

    @property
    def trial_dir(self) -> str:
        return os.path.join(self.exp_dir, self.trial_name)


def load_config(path: str, cli_args: Optional[List[str]] = None, **kwargs) -> ExperimentConfig:
    """Load YAML config, merge CLI dot-list overrides, resolve interpolation,
    and parse the top-level structure (reference config.py:99-109)."""
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    if cli_args:
        raw = merge_dicts(raw, parse_dotlist(cli_args))
    raw = merge_dicts(raw, kwargs)
    raw = resolve_interpolations(raw)

    cfg = parse_structured(ExperimentConfig, raw)
    if cfg.use_timestamp and cfg.timestamp is None:
        cfg.timestamp = "@" + datetime.now().strftime("%Y%m%d-%H%M%S")
    elif cfg.timestamp is None:
        cfg.timestamp = ""
    return cfg
