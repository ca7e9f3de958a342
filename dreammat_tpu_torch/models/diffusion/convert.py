"""Weight bridge: flax-layout parameter trees (as numpy) -> torch state dicts.

The port's own copy of the flax -> torch direction of
``dreammat_tpu/models/diffusion/convert.py`` (``flax_to_torch_state_dict``):
the same key mangling (flat flax module names such as ``down_blocks_0`` to
diffusers' dotted ``down_blocks.0``) and kernel transposes
(conv HWIO -> OIHW, dense IO -> OI). It works on nested dicts of numpy
arrays, so no JAX is needed to run it. Covers ``unet``, ``controlnet``,
``vae``, ``clip``, ``clip_vision`` (Zero123's image tower, HF's
``CLIPVisionModelWithProjection`` keys) and ``t5`` (DeepFloyd IF's text
tower, HF's ``T5EncoderModel`` keys): the port's modules carry those key
names, so an HF-layout checkpoint loads through ``load_diffusers_weights``
and a flax tree through ``flax_to_torch_state_dict``;
``controlnet_trainer_state_from_flax`` carries the JAX
ControlNet trainer's whole parameter tree across. Also holds the random
initialization the port uses when no checkpoint is present, the checkpoint
file lookup and reader for diffusers-layout weights, the loader of such a
checkpoint into a port module (``load_diffusers_weights``, the torch ->
flax direction's fallbacks: old VAE attention names, CLIP's bare
``position_embedding``, skipped ``position_ids`` buffers),
``geometry_params_from_numpy`` for the material field, the implicit
volume, the DMTet grid and the backgrounds (``volume_scene_from_numpy``
for a volume or mesh system's whole scene), ``lora_state_from_numpy`` and
``lora_layers_from_numpy`` for the VSD guidance's LoRA factors and camera
embedding, ``bert_state_dict_from_flax`` for the debiasing BERT (the inverse of the
JAX package's ``bert_params_from_torch``), ``vgg16_state_dict_from_flax``
for the perceptual tower and ``gan_state_dict_from_flax`` for Control4D's
four GAN networks. The IP2P UNet (8-channel ``conv_in``, 768-wide
``attn2``) goes through ``flax_to_torch_state_dict(..., "unet")``.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

import dreammat_tpu_torch


def _walk(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    else:
        yield path, tree


def _clip_rename(name: str) -> str:
    if name.startswith("token_embedding") or name.startswith("position_embedding"):
        return "text_model.embeddings." + name
    if name == "final_layer_norm":
        return "text_model.final_layer_norm"
    m = re.match(r"layers\.(\d+)\.(.*)", name)
    if m:
        idx, rest = m.group(1), m.group(2)
        if rest in ("q_proj", "k_proj", "v_proj", "out_proj"):
            rest = "self_attn." + rest
        elif rest in ("fc1", "fc2"):
            rest = "mlp." + rest
        return f"text_model.encoder.layers.{idx}.{rest}"
    return name


def _t5_key(path: Tuple[str, ...]) -> str:
    """The JAX T5Encoder tree -> HF ``T5EncoderModel`` keys (raw RMSNorm
    scales, the shared relative position bias in block 0)."""
    if path == ("token_embedding", "embedding"):
        return "shared.weight"
    if path == ("relative_attention_bias",):
        return "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"
    if path == ("final_layer_norm",):
        return "encoder.final_layer_norm.weight"
    m = re.match(r"block_(\d+)", path[0])
    if m:
        n, rest = m.group(1), path[1:]
        if rest == ("attn_layer_norm",):
            return f"encoder.block.{n}.layer.0.layer_norm.weight"
        if rest == ("ff_layer_norm",):
            return f"encoder.block.{n}.layer.1.layer_norm.weight"
        if rest[0] == "attention":
            return f"encoder.block.{n}.layer.0.SelfAttention.{rest[1]}.weight"
        if rest[0] in ("wi_0", "wi_1", "wo"):
            return f"encoder.block.{n}.layer.1.DenseReluDense.{rest[0]}.weight"
    raise KeyError(f"unmapped t5 path {path}")


def _clip_vision_key(path: Tuple[str, ...]) -> str:
    """The JAX CLIPVisionModel tree -> HF ``CLIPVisionModelWithProjection``
    keys, HF's literal ``pre_layrnorm`` included."""
    if path == ("patch_embedding", "kernel"):
        return "vision_model.embeddings.patch_embedding.weight"
    if path == ("class_embedding",):
        return "vision_model.embeddings.class_embedding"
    if path == ("position_embedding",):
        return "vision_model.embeddings.position_embedding.weight"
    if path[0] in ("pre_layernorm", "post_layernorm"):
        name = "pre_layrnorm" if path[0] == "pre_layernorm" else "post_layernorm"
        return f"vision_model.{name}.{'weight' if path[1] == 'scale' else 'bias'}"
    if path == ("visual_projection", "kernel"):
        return "visual_projection.weight"
    m = re.match(r"layers_(\d+)", path[0])
    if m:
        n, rest = m.group(1), path[1:]
        leaf = "weight" if rest[-1] in ("kernel", "scale") else "bias"
        mod = rest[0]
        if mod in ("q_proj", "k_proj", "v_proj", "out_proj"):
            mod = "self_attn." + mod
        elif mod in ("fc1", "fc2"):
            mod = "mlp." + mod
        return f"vision_model.encoder.layers.{n}.{mod}.{leaf}"
    raise KeyError(f"unmapped clip_vision path {path}")


def flax_path_to_torch_key(path: Tuple[str, ...], model_type: str) -> str:
    if model_type == "t5":
        return _t5_key(path)
    if model_type == "clip_vision":
        return _clip_vision_key(path)
    *mods, leaf = path
    if model_type == "clip" and leaf == "position_embedding" and not mods:
        return "text_model.embeddings.position_embedding.weight"
    name = ".".join(mods)
    name = name.replace("linear_1", "linear<1>").replace("linear_2", "linear<2>")
    name = re.sub(r"_(\d+)", r".\1", name)
    name = name.replace("linear<1>", "linear_1").replace("linear<2>", "linear_2")
    name = re.sub(r"(\.\d+)_", r"\1.", name)
    name = name.replace("mid_block_", "mid_block.")
    if model_type == "clip":
        name = _clip_rename(name)
    suffix = "weight" if leaf in ("kernel", "scale", "embedding") else leaf
    return suffix if name == "" else f"{name}.{suffix}"


def _to_torch_array(leaf_name: str, value: np.ndarray) -> np.ndarray:
    if leaf_name == "kernel":
        if value.ndim == 4:  # conv: HWIO -> OIHW
            return np.transpose(value, (3, 2, 0, 1))
        if value.ndim == 2:  # dense: IO -> OI
            return np.transpose(value)
    return value


def flax_to_torch_state_dict(flax_params: Mapping, model_type: str = "unet") -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (flax layout) -> torch state dict with
    diffusers / transformers key names."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _walk(flax_params):
        if path and path[0] == "params":
            path = path[1:]
        key = flax_path_to_torch_key(path, model_type)
        arr = np.array(_to_torch_array(path[-1], np.asarray(leaf, dtype=np.float32)))
        out[key] = torch.from_numpy(arr)
    return out


def controlnet_trainer_state_from_flax(params: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX ControlNet trainer's ``init_params`` tree as numpy,
    ``{"frozen": {"unet", "vae", "clip"}, "controlnet"}``, -> the state dicts
    ``{"unet", "vae", "clip", "controlnet"}`` of the port trainer's modules
    (``ControlNetTrainer.load_state_dicts``)."""
    frozen = params["frozen"]
    out = {kind: flax_to_torch_state_dict(frozen[kind], kind) for kind in ("unet", "vae", "clip")}
    out["controlnet"] = flax_to_torch_state_dict(params["controlnet"], "controlnet")
    return out


def find_checkpoint_file(model_dir: str,
                         names=("diffusion_pytorch_model", "model", "pytorch_model")) -> Optional[str]:
    """The first ``<name>.{safetensors,bin,pt}`` in ``model_dir``, or None."""
    for n in names:
        for ext in (".safetensors", ".bin", ".pt"):
            p = os.path.join(model_dir, n + ext)
            if os.path.exists(p):
                return p
    return None


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A diffusers / transformers checkpoint file as a state dict on the host:
    safetensors through the port's own reader, .bin/.pt through
    ``torch.load(weights_only=True)``."""
    if path.endswith(".safetensors"):
        from dreammat_tpu_torch.utils.safetensors_io import load_file

        return load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


# older diffusers exports name the VAE attention projections differently
# (current name part, old name part)
_VAE_ALIASES = (("to_q", "query"), ("to_k", "key"), ("to_v", "value"),
                ("to_out.0", "proj_attn"))
# buffers that exports may hold and that are not parameters of the model
_KNOWN_BUFFERS = ("position_ids",)


def _lookup(sd: Mapping[str, torch.Tensor], key: str) -> Optional[str]:
    """The checkpoint key that holds the model's ``key``: the key itself, its
    old VAE attention name, or CLIP's position embedding without ``.weight``."""
    if key in sd:
        return key
    for new, old in _VAE_ALIASES:
        if new in key and key.replace(new, old) in sd:
            return key.replace(new, old)
    if key.endswith("position_embedding.weight") and key[: -len(".weight")] in sd:
        return key[: -len(".weight")]
    return None


@torch.no_grad()
def load_diffusers_weights(module: nn.Module, state_dict: Mapping[str, torch.Tensor],
                           model_type: str, strict: bool = False,
                           source: str = "state dict") -> Dict[str, list]:
    """Copy a diffusers / transformers state dict into ``module`` in place,
    cast to each parameter's dtype and device. Returns the model keys
    ``loaded`` and ``missing`` and the checkpoint keys left ``unused`` (known
    buffers aside), and logs their counts. A shape mismatch raises; old VAE
    attention weights stored as 1x1 convolutions [C, C, 1, 1] load into the
    port's [C, C]. With ``strict`` a missing or unused key raises; without
    it, a checkpoint that loads no key at all still raises."""
    own = module.state_dict()
    loaded, missing, used = [], [], set()
    for key, dst in own.items():
        src = _lookup(state_dict, key)
        if src is None:
            missing.append(key)
            continue
        val = state_dict[src]
        if val.dim() == 4 and dst.dim() == 2 and tuple(val.shape[2:]) == (1, 1):
            val = val.reshape(val.shape[:2])
        if tuple(val.shape) != tuple(dst.shape):
            raise ValueError(f"{model_type} {key}: checkpoint shape {tuple(val.shape)}, "
                             f"model shape {tuple(dst.shape)}")
        dst.copy_(val.to(device=dst.device, dtype=dst.dtype))
        loaded.append(key)
        used.add(src)
    unused = sorted(k for k in state_dict
                    if k not in used and not any(b in k for b in _KNOWN_BUFFERS))
    dreammat_tpu_torch.info("%s weights from %s: %d of %d keys loaded, %d missing, %d unused",
                            model_type, source, len(loaded), len(own), len(missing), len(unused))
    if not loaded:
        raise ValueError(f"{source}: no key matches the {model_type} model "
                         f"(checkpoint keys such as {sorted(state_dict)[:4]})")
    if strict and (missing or unused):
        raise KeyError(f"{model_type}: {len(missing)} missing keys, e.g. {missing[:8]}; "
                       f"{len(unused)} unused, e.g. {unused[:8]}")
    return {"loaded": loaded, "missing": missing, "unused": unused}


def load_model_dir(module: nn.Module, model_dir: Optional[str],
                   model_type: str) -> Optional[Dict[str, list]]:
    """Load the checkpoint file of ``model_dir`` (``find_checkpoint_file``)
    into ``module`` through ``load_diffusers_weights``; None, and ``module``
    unchanged, when the directory or its file does not exist."""
    if not model_dir or not os.path.isdir(str(model_dir)):
        return None
    ckpt = find_checkpoint_file(str(model_dir))
    if ckpt is None:
        return None
    return load_diffusers_weights(module, load_state_dict_file(ckpt), model_type, source=ckpt)


_FIELD_MLPS = ("mlp", "density_mlp", "feature_mlp", "normal_mlp", "sdf_mlp")
_FIELD_TENSORS = ("sdf", "deformation", "table", "color", "grid", "density_scale", "normal_grid",
                  "texture")


def geometry_params_from_numpy(params: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX field tree (numpy) -> the state dict of the port's module: the
    material field ``{"table": [L,T,F], "mlp": {"w": [[in,out]...], "b":
    [[out]...]}}`` (``MaterialField``), the implicit volume ``{"table",
    "density_mlp", "feature_mlp", "normal_mlp"}`` (``VolumeField``, MLPs as
    present), the volume grid ``{"grid", "density_scale", "normal_grid"}``
    (``VolumeGridField``), the implicit SDF ``{"table", "sdf_mlp",
    "feature_mlp"}`` (``SDFField``), the DMTet grid ``{"sdf", "deformation",
    "table", "feature_mlp"}`` (``DMTetField``, as present), the neural
    environment map ``{"mlp"}`` (``BackgroundField``), the textured
    background ``{"texture"}`` (``TextureField``), the learned solid colour
    ``{"color"}`` (``SolidColorField``) or the neural-radiance material's
    MLP as ``{"mlp"}`` (``RadianceField``)."""
    sd = {}
    for name in _FIELD_TENSORS:
        if name in params:
            sd[name] = torch.from_numpy(np.array(params[name], dtype=np.float32))
    for name in _FIELD_MLPS:
        if name not in params:
            continue
        for i, (w, b) in enumerate(zip(params[name]["w"], params[name]["b"])):
            sd[f"{name}.{i}.weight"] = torch.from_numpy(np.array(np.asarray(w, np.float32).T,
                                                                 order="C"))
            sd[f"{name}.{i}.bias"] = torch.from_numpy(np.array(b, dtype=np.float32))
    return sd


def volume_scene_from_numpy(geo: Mapping, bg: Mapping, occ=None,
                            var: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """The JAX volume systems' ``state["geo"]``, ``state["bg"]``,
    ``state["render"]["occ"]`` (numpy; none under the mesh rasterizer) and,
    for TextMesh, NeuS's ``state["var"]`` ``{"_inv_std"}`` -> a
    ``VolumeScene`` (``SDFScene``) state dict."""
    sd = {"geo." + k: v for k, v in geometry_params_from_numpy(geo).items()}
    sd.update({"bg." + k: v for k, v in geometry_params_from_numpy(bg).items()})
    if occ is not None:
        sd["occ"] = torch.from_numpy(np.array(occ, dtype=np.float32))
    if var is not None:
        sd["var._inv_std"] = torch.from_numpy(np.array(var["_inv_std"], dtype=np.float32))
    return sd


def lora_site_name(jax_key: str) -> str:
    """A JAX LoRA site key (``params/down_blocks_0/.../attn1/to_out_0``) ->
    the port's site, the module name of its Linear (``down_blocks.0...
    attn1.to_out.0``)."""
    path = tuple(p for p in jax_key.split("/") if p != "params") + ("kernel",)
    return flax_path_to_torch_key(path, "unet")[:-len(".weight")]


def lora_layers_from_numpy(layers: Mapping, sites) -> Dict[str, torch.Tensor]:
    """The JAX LoRA factors ``{key: {"down" [in,r], "up" [r,out]}}`` (numpy)
    -> a state dict of the port's ``LoRALayers``, whose layers follow
    ``sites`` (``LoRALayers.sites``)."""
    by_site = {lora_site_name(k): v for k, v in layers.items()}
    if sorted(by_site) != sorted(sites):
        raise KeyError(f"LoRA sites differ: {sorted(set(by_site) ^ set(sites))[:4]}")
    t = lambda x: torch.from_numpy(np.array(x, dtype=np.float32))
    sd = {}
    for i, site in enumerate(sites):
        sd[f"layers.{i}.down"] = t(by_site[site]["down"])
        sd[f"layers.{i}.up"] = t(by_site[site]["up"])
    return sd


def lora_state_from_numpy(lora: Mapping, sites) -> Dict[str, torch.Tensor]:
    """The JAX VSD guidance's LoRA tree ``{"layers": {...},
    "camera_embedding": {"linear_1", "linear_2"}}`` (numpy) -> a state dict
    of the port's ``LoRAState``."""
    sd = {"layers." + k: v for k, v in lora_layers_from_numpy(lora["layers"], sites).items()}
    for k, v in flax_to_torch_state_dict(lora["camera_embedding"], "unet").items():
        sd["camera_embedding." + k] = v
    return sd


def bert_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's BERT masked-LM params (numpy, flax layout, with or
    without the top ``params`` level) -> the Hugging Face
    ``BertForMaskedLM`` state dict of the port's ``bert.BertForMaskedLM``:
    dense kernels [in,out] transposed to [out,in], ``scale`` to ``weight``."""
    p = params["params"] if "params" in params else params
    t = lambda x: torch.from_numpy(np.array(x, dtype=np.float32))

    def dense(prefix, leaf):
        return {prefix + ".weight": t(np.asarray(leaf["kernel"]).T),
                prefix + ".bias": t(leaf["bias"])}

    def norm(prefix, leaf):
        return {prefix + ".weight": t(leaf["scale"]), prefix + ".bias": t(leaf["bias"])}

    e = "bert.embeddings."
    sd = {e + "word_embeddings.weight": t(p["word_embeddings"]["embedding"]),
          e + "position_embeddings.weight": t(p["position_embeddings"]),
          e + "token_type_embeddings.weight": t(p["token_type_embeddings"]),
          **norm(e + "LayerNorm", p["embeddings_ln"]),
          **dense("cls.predictions.transform.dense", p["mlm_dense"]),
          **norm("cls.predictions.transform.LayerNorm", p["mlm_ln"]),
          "cls.predictions.decoder.weight": t(np.asarray(p["mlm_decoder"]["kernel"]).T),
          "cls.predictions.bias": t(p["mlm_decoder"]["bias"])}
    i = 0
    while f"layer_{i}" in p:
        lp, b = p[f"layer_{i}"], f"bert.encoder.layer.{i}."
        for name, key in (("query", "attention.self.query"), ("key", "attention.self.key"),
                          ("value", "attention.self.value"),
                          ("attn_out", "attention.output.dense"),
                          ("inter", "intermediate.dense"), ("out", "output.dense")):
            sd.update(dense(b + key, lp[name]))
        sd.update(norm(b + "attention.output.LayerNorm", lp["attn_ln"]))
        sd.update(norm(b + "output.LayerNorm", lp["out_ln"]))
        i += 1
    return sd


# torchvision's vgg16().features index of each of the 13 convs
_VGG16_FEATURES_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def vgg16_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX perceptual tower ``{"w": [HWIO] * 13, "b": [[C]] * 13}``
    (numpy) -> the state dict of the port's ``VGG16Features``
    (torchvision's ``features.N`` keys)."""
    t = lambda x: torch.from_numpy(np.array(x, dtype=np.float32))
    sd = {}
    for i, idx in enumerate(_VGG16_FEATURES_IDX):
        sd[f"features.{idx}.weight"] = t(np.transpose(np.asarray(params["w"][i]), (3, 2, 0, 1)))
        sd[f"features.{idx}.bias"] = t(params["b"][i])
    return sd


def _gan_module_name(kind: str, name: str, n_levels: int) -> str:
    """A flax auto-name (``Conv_2``, ``ResBlock_1``, ...) of one of the JAX
    GAN networks -> the port module's attribute path (``utils/gan.py``)."""
    typ, i = name.rsplit("_", 1)
    i = int(i)
    if typ == "ResBlock":
        return "mid" if kind == "local_encoder" and i == n_levels else f"blocks.{i}"
    if kind in ("generator", "local_encoder") and typ == "Conv":
        inner = "ups" if kind == "generator" else "downs"
        return "conv_in" if i == 0 else "conv_out" if i == n_levels else f"{inner}.{i - 1}"
    if kind == "generator":
        return {"Dense_0": "film_scale", "Dense_1": "film_shift", "GroupNorm_0": "norm_out"}[name]
    if kind == "global_encoder":
        return f"convs.{i}" if typ == "Conv" else "fc"
    if kind == "discriminator":
        if typ == "GroupNorm":
            return f"norms.{i}"
        return "conv_in" if i == 0 else "conv_out" if i == n_levels + 1 else f"convs.{i - 1}"
    raise KeyError(f"unmapped {kind} module {name}")


_RESBLOCK_PARTS = {"GroupNorm_0": "norm1", "Conv_0": "conv1", "GroupNorm_1": "norm2",
                   "Conv_1": "conv2", "Conv_2": "skip"}


def gan_state_dict_from_flax(params: Mapping, kind: str, n_levels: int) -> Dict[str, torch.Tensor]:
    """One of the JAX Control4D networks' flax trees (numpy, with or without
    the top ``params`` level) -> the state dict of the port's module:
    ``kind`` is ``generator``, ``local_encoder``, ``global_encoder`` or
    ``discriminator``; ``n_levels`` is ``len(ch_mult)`` (the
    discriminator's ``n_layers``)."""
    p = params["params"] if "params" in params else params
    sd = {}
    for path, leaf in _walk(p):
        mods = [_gan_module_name(kind, path[0], n_levels)]
        if path[0].startswith("ResBlock"):
            mods.append(_RESBLOCK_PARTS[path[1]])
        key = ".".join(mods) + "." + ("bias" if path[-1] == "bias" else "weight")
        sd[key] = torch.from_numpy(np.array(_to_torch_array(path[-1], np.asarray(
            leaf, dtype=np.float32))))
    return sd


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator, std: float = 0.02) -> nn.Module:
    """Fill a module's parameters like the JAX package's ``fast_random_init``:
    norm weights 1, biases 0, every other tensor normal(0, std)."""
    for mod in module.modules():
        for name, p in mod.named_parameters(recurse=False):
            if isinstance(mod, (nn.GroupNorm, nn.LayerNorm)) and name == "weight":
                p.fill_(1.0)
            elif name == "bias":
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=generator, device=p.device,
                                    dtype=torch.float32).to(p.dtype) * std)
    return module


def build_on(cls_fn, device: torch.device, dtype: torch.dtype) -> nn.Module:
    """Construct a module on the meta device and materialize it, uninitialized,
    on ``device`` in ``dtype`` (no host-side init of SD-sized weights)."""
    with torch.device("meta"):
        module = cls_fn()
    return module.to(dtype=dtype).to_empty(device=device)
