"""ControlNet training CLI of the port.

    python -m dreammat_tpu_torch.train_controlnet --config configs/controlnet_train.yaml \
        [--max-steps N] [key=value ...]

Counterpart of ``train_controlnet.py``: the same flags, ``--config`` as json
or yaml with the reference ``config.json`` key names, and dotted overrides
(``sd_cache_dir=null``, ``train_batch_size=8``). Trains on one card;
``--n-model`` above 1 (tensor parallelism) and multi-card data parallelism
are not ported yet.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List, Optional

# reference config.json key -> ControlNetTrainer.Config field
KEY_MAP = {
    "sd_cache_dir": "sd_cache_dir",
    "controlnet_dir": "controlnet_dir",
    "resolution": "resolution",
    "train_batch_size": "train_batch_size",
    "num_train_epochs": "num_train_epochs",
    "learning_rate": "learning_rate",
    "checkpointing_steps": "checkpointing_steps",
    "use_cfg": "use_cfg",
    "seed": "seed",
    "lr_scheduler": "lr_scheduler",
    "lr_warmup_steps": "lr_warmup_steps",
    "model_size": "model_size",
}


def main(argv: Optional[List[str]] = None, device="cuda") -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description="Train the 22-channel light ControlNet")
    ap.add_argument("--config", required=True, help="json or yaml config")
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--n-model", type=int, default=1, help="tensor-parallel factor")
    args, extras = ap.parse_known_args(argv)
    if args.n_model != 1:
        raise NotImplementedError(
            "--n-model > 1: tensor- and data-parallel ControlNet training is not ported yet "
            "(ROADMAP queue 1, \"More than one card\")")

    import dreammat_tpu_torch
    import dreammat_tpu_torch.systems  # noqa: F401  (registry)
    from dreammat_tpu_torch.data.controlnet_dataset import ControlNetDataset
    from dreammat_tpu_torch.utils.config import merge_dicts, parse_dotlist

    if args.config.endswith(".json"):
        with open(args.config) as f:
            raw = json.load(f)
    else:
        import yaml

        with open(args.config) as f:
            raw = yaml.safe_load(f)
    if extras:
        raw = merge_dicts(raw, parse_dotlist(extras))

    trainer_cfg = {v: raw[k] for k, v in KEY_MAP.items() if k in raw}
    trainer = dreammat_tpu_torch.find("controlnet-trainer")(trainer_cfg, device=device)
    dataset = ControlNetDataset(
        raw.get("train_data_dir"), raw.get("prompt_file_path", raw.get("prompt_file")),
        resolution=trainer.cfg.resolution, use_cfg=trainer.cfg.use_cfg, seed=trainer.cfg.seed,
    )
    dreammat_tpu_torch.info("training on %s, %d examples, batch %d", trainer.device,
                            len(dataset), trainer.cfg.train_batch_size)
    out = trainer.fit(dataset, raw.get("controlnet_dir", "model/controlnet"),
                      max_steps=args.max_steps)
    out["trainer"] = trainer
    return out


if __name__ == "__main__":
    main()
