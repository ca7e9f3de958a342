"""Environment lighting: HDR files, procedural skies, equirect lookup, the FG LUT.

Counterpart of the parts of ``dreammat_tpu/ops/envmap.py`` the tables regime
uses: the Radiance RGBE reader and writer (``read_hdr``, ``write_hdr``,
numpy) and ``load_envmap_file`` (``.hdr``, or ``.exr`` through OpenCV when
it is installed: without it an ``.exr`` raises),
``make_procedural_envmap`` (numpy, used when no HDR file exists),
``resize_envmap``, equirect sampling with z as the polar axis (nearest, as
the Monte-Carlo estimators read the environment, and bilinear), the
computed Karis split-sum LUT (``compute_fg_lut`` / ``sample_fg_lut``), and
the split-sum environment stack of the ``use_raytracing: false`` path
(``build_splitsum``: a cosine-convolved irradiance map and GGX-prefiltered
radiance at ``SPECULAR_LEVELS``, from fixed fibonacci sets, once per map;
``sample_splitsum_diffuse`` / ``sample_splitsum_specular`` read it, the
latter mixing the two mips around each point's roughness).
"""

from __future__ import annotations

import math
import os
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dreammat_tpu_torch.utils import ops as uops
from dreammat_tpu_torch.utils.hw import resolve_device


def read_hdr(path: str) -> np.ndarray:
    """Radiance RGBE (.hdr) file -> float32 [H,W,3]: flat or new-style
    run-length scanlines, ``-Y H +X W`` orientation."""
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a radiance HDR file")
    pos = data.find(b"\n\n")
    if pos < 0:
        raise ValueError(f"{path}: bad hdr header")
    pos += 2
    eol = data.find(b"\n", pos)
    res = data[pos:eol].decode("ascii").split()
    if res[0] != "-Y" or res[2] != "+X":
        raise ValueError(f"{path}: unsupported orientation {res}")
    H, W = int(res[1]), int(res[3])
    img = np.zeros((H, W, 4), dtype=np.uint8)
    buf = np.frombuffer(data, dtype=np.uint8, offset=eol + 1)
    bp = 0
    for y in range(H):
        if buf[bp] == 2 and buf[bp + 1] == 2 and (int(buf[bp + 2]) << 8 | int(buf[bp + 3])) == W:
            bp += 4  # new-style RLE, channel by channel
            for c in range(4):
                x = 0
                while x < W:
                    n = int(buf[bp])
                    bp += 1
                    if n > 128:  # a run
                        img[y, x:x + n - 128, c] = buf[bp]
                        bp += 1
                        x += n - 128
                    else:  # literals
                        img[y, x:x + n, c] = buf[bp:bp + n]
                        bp += n
                        x += n
        else:  # a flat scanline
            img[y] = buf[bp:bp + W * 4].reshape(W, 4)
            bp += W * 4
    rgbe = img.astype(np.float32)
    e = rgbe[..., 3]
    scale = np.where(e > 0, np.ldexp(1.0, e.astype(np.int32) - 136), 0.0)
    return (rgbe[..., :3] + 0.5) * scale[..., None] * np.where(e > 0, 1.0, 0.0)[..., None]


def write_hdr(path: str, img: np.ndarray) -> None:
    """float32 [H,W,3] -> uncompressed Radiance RGBE file."""
    H, W, _ = img.shape
    rgb = np.maximum(img, 0.0)
    maxc = rgb.max(axis=-1)
    e = np.zeros((H, W), dtype=np.int32)
    nz = maxc > 1e-32
    e[nz] = np.ceil(np.log2(maxc[nz])).astype(np.int32) + 1
    scale = np.ldexp(1.0, -e) * 256.0
    mant = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    rgbe = np.concatenate([mant, (e + 128)[..., None].astype(np.uint8)], axis=-1)
    rgbe[~nz] = 0
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {H} +X {W}\n".encode("ascii"))
        f.write(rgbe.tobytes())


def load_envmap_file(path: str) -> np.ndarray:
    """An environment map file as float32 [H,W,3] linear RGB."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".hdr":
        return read_hdr(path)
    if ext == ".exr":
        os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
        try:
            import cv2
        except ImportError as e:
            raise RuntimeError(
                f"{path}: reading .exr environment maps needs OpenCV (cv2), which is not "
                "installed; convert the map to .hdr (ops.envmap.write_hdr) or install it") from e
        img = cv2.imread(path, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
        if img is None:
            raise ValueError(f"cv2 failed to read {path}")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32)
    raise ValueError(f"unsupported envmap format {ext}")


def make_procedural_envmap(height: int = 256, width: int = 512, sun_dir=(0.5, 0.5, 0.7),
                           sun_intensity: float = 20.0, sky_color=(0.35, 0.45, 0.65),
                           ground_color=(0.25, 0.2, 0.15), seed: int = 0) -> np.ndarray:
    """Analytic sky + sun equirect map [H,W,3] float32."""
    v, u = np.meshgrid(
        (np.arange(height) + 0.5) / height, (np.arange(width) + 0.5) / width, indexing="ij"
    )
    theta = v * np.pi
    phi = (0.5 - u) * 2 * np.pi
    d = np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)], -1)
    sd = np.asarray(sun_dir, dtype=np.float64)
    sd = sd / np.linalg.norm(sd)
    cos_sun = (d * sd).sum(-1)
    sky_t = np.clip(d[..., 2] * 0.5 + 0.5, 0, 1)[..., None]
    base = sky_t * np.asarray(sky_color) + (1 - sky_t) * np.asarray(ground_color)
    sun = np.exp((cos_sun - 1.0) * 400.0)[..., None] * sun_intensity
    return (base + sun).astype(np.float32)


def resize_envmap(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[H,W,3] -> [height,width,3], half-pixel bilinear with antialiasing
    when shrinking (what ``jax.image.resize(method="linear")`` does)."""
    if tuple(img.shape[:2]) == (height, width):
        return img
    x = img.permute(2, 0, 1)[None]
    out = F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False,
                        antialias=True)
    return out[0].permute(1, 2, 0)


def equirect_uv(directions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    d = uops.safe_normalize(directions)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    theta = torch.arccos(torch.clamp(z, -1.0, 1.0))
    phi = torch.remainder(torch.atan2(y, x), 2.0 * math.pi)
    return -phi / (2.0 * math.pi) + 0.5, theta / math.pi


def sample_equirect_nearest(env: torch.Tensor, directions: torch.Tensor) -> torch.Tensor:
    """Nearest equirect lookup (the reference's). env [H,W,3]."""
    H, W = env.shape[0], env.shape[1]
    u, v = equirect_uv(directions)
    xi = torch.remainder((u * W).to(torch.int64), W)
    yi = torch.remainder((v * H).to(torch.int64), H)
    return env[yi, xi]


def sample_equirect_bilinear(env: torch.Tensor, directions: torch.Tensor) -> torch.Tensor:
    """Bilinear equirect lookup with azimuth wrap. env [H,W,3]."""
    H, W = env.shape[0], env.shape[1]
    u, v = equirect_uv(directions)
    x = u * W - 0.5
    y = torch.clamp(v * H - 0.5, 0.0, H - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    x0i = torch.remainder(x0.long(), W)
    x1i = torch.remainder(x0.long() + 1, W)
    y0i = torch.clamp(y0.long(), 0, H - 1)
    y1i = torch.clamp(y0i + 1, 0, H - 1)
    return (env[y0i, x0i] * (1 - wx) * (1 - wy) + env[y0i, x1i] * wx * (1 - wy)
            + env[y1i, x0i] * (1 - wx) * wy + env[y1i, x1i] * wx * wy)


def _equirect_directions(H: int, W: int, device=None) -> torch.Tensor:
    """The unit direction at each texel centre of an [H,W] equirect map."""
    v = (torch.arange(H, dtype=torch.float32, device=device) + 0.5) / H
    u = (torch.arange(W, dtype=torch.float32, device=device) + 0.5) / W
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    theta = vv * math.pi
    phi = (0.5 - uu) * 2.0 * math.pi
    return torch.stack([torch.sin(theta) * torch.cos(phi), torch.sin(theta) * torch.sin(phi),
                        torch.cos(theta)], dim=-1)


def _frame(z: torch.Tensor):
    x = uops.get_orthogonal_directions(z)
    return x, torch.linalg.cross(z, x, dim=-1)


def prefilter_diffuse(env: torch.Tensor, out_h: int = 32, out_w: int = 64,
                      n_samples: int = 512) -> torch.Tensor:
    """Cosine-convolved irradiance E(n)/pi in equirect layout [h,w,3], from a
    fixed fibonacci set on the upper hemisphere."""
    az, el = (torch.as_tensor(a, device=env.device)
              for a in uops.sample_sphere_fibonacci(n_samples))
    local = torch.stack([torch.cos(az) * torch.cos(el), torch.sin(az) * torch.cos(el),
                         torch.sin(el)], dim=-1)                         # [S,3]
    normals = _equirect_directions(out_h, out_w, env.device).reshape(-1, 3)
    t, b = _frame(normals)
    dirs = (local[None, :, 0:1] * t[:, None] + local[None, :, 1:2] * b[:, None]
            + local[None, :, 2:3] * normals[:, None])                    # [P,S,3]
    L = sample_equirect_bilinear(env, dirs)
    cosw = torch.clamp(local[None, :, 2:3], 0.0, 1.0)
    return (2.0 * torch.mean(L * cosw, dim=1)).reshape(out_h, out_w, 3)


def prefilter_specular_level(env: torch.Tensor, roughness_sq: float, out_h: int, out_w: int,
                             n_samples: int = 256, row_chunk: int = 4096) -> torch.Tensor:
    """GGX-prefiltered radiance for one squared roughness (N = V = R), equirect
    [h,w,3]; the smoothest level is the map itself, resized. Texels are
    taken ``row_chunk`` at a time to bound the [texels, samples, 3] work."""
    if roughness_sq < 1e-5:
        return resize_envmap(env, out_h, out_w)
    az, el = (torch.as_tensor(a, device=env.device)
              for a in uops.sample_sphere_fibonacci(n_samples))
    u1, u2 = az / (2.0 * math.pi), 1.0 - 2.0 * el / math.pi
    a = roughness_sq
    cos_t = torch.sqrt(torch.clamp((1.0 - u2) / (1.0 + (a * a - 1.0) * u2 + 1e-9), 0.0, 1.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t ** 2, 0.0, 1.0))
    phi = 2.0 * math.pi * u1
    local_h = torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t, cos_t], dim=-1)
    refl_all = _equirect_directions(out_h, out_w, env.device).reshape(-1, 3)
    out = []
    for refl in refl_all.split(row_chunk):
        t, b = _frame(refl)
        h = (local_h[None, :, 0:1] * t[:, None] + local_h[None, :, 1:2] * b[:, None]
             + local_h[None, :, 2:3] * refl[:, None])
        l = 2.0 * torch.sum(refl[:, None] * h, -1, keepdim=True) * h - refl[:, None]
        w = torch.clamp(torch.sum(refl[:, None] * l, -1, keepdim=True), 0.0, 1.0)
        L = sample_equirect_bilinear(env, l)
        out.append(torch.sum(L * w, dim=1) / (torch.sum(w, dim=1) + 1e-6))
    return torch.cat(out).reshape(out_h, out_w, 3)


SPECULAR_LEVELS = (0.0, 0.04, 0.12, 0.25, 0.45, 0.7, 1.0)  # roughness^2 per mip


def build_splitsum(env: torch.Tensor, base_h: int = 128, base_w: int = 256) -> dict:
    """The split-sum stack of one map: ``diffuse`` [32,64,3], ``specular``
    [M, base_h, base_w, 3] at ``SPECULAR_LEVELS``, and the ``levels``."""
    spec = [prefilter_specular_level(env, r, base_h, base_w) for r in SPECULAR_LEVELS]
    return {"diffuse": prefilter_diffuse(env), "specular": torch.stack(spec),
            "levels": torch.tensor(SPECULAR_LEVELS, dtype=torch.float32, device=env.device)}


def sample_splitsum_diffuse(ss: dict, normals: torch.Tensor) -> torch.Tensor:
    return sample_equirect_bilinear(ss["diffuse"], normals)


def sample_splitsum_specular(ss: dict, refl: torch.Tensor,
                             roughness_sq: torch.Tensor) -> torch.Tensor:
    """The two mips around each point's roughness^2 ([...,1], clamped to the
    levels), each read bilinearly, mixed linearly."""
    levels = ss["levels"]
    M = levels.shape[0]
    r = torch.clamp(roughness_sq[..., 0], levels[0], levels[-1])   # on the device: no sync
    idx = torch.clamp(torch.searchsorted(levels, r.contiguous(), right=True) - 1, 0, M - 2)
    lo, hi = levels[idx], levels[idx + 1]
    w = ((r - lo) / (hi - lo + 1e-9))[..., None]
    all_lo = sample_equirect_bilinear_batchmap(ss["specular"], idx, refl)
    all_hi = sample_equirect_bilinear_batchmap(ss["specular"], idx + 1, refl)
    return all_lo * (1 - w) + all_hi * w


def sample_equirect_bilinear_batchmap(stack: torch.Tensor, level_idx: torch.Tensor,
                                      directions: torch.Tensor) -> torch.Tensor:
    """Bilinear lookup where each point reads its own mip: stack [M,H,W,3],
    level_idx [...], directions [...,3]."""
    M, H, W = stack.shape[0], stack.shape[1], stack.shape[2]
    u, v = equirect_uv(directions)
    x = u * W - 0.5
    y = torch.clamp(v * H - 0.5, 0.0, H - 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    x0i = torch.remainder(x0.long(), W)
    x1i = torch.remainder(x0.long() + 1, W)
    y0i = torch.clamp(y0.long(), 0, H - 1)
    y1i = torch.clamp(y0i + 1, 0, H - 1)
    li = torch.clamp(level_idx, 0, M - 1)
    return (stack[li, y0i, x0i] * (1 - wx) * (1 - wy) + stack[li, y0i, x1i] * wx * (1 - wy)
            + stack[li, y1i, x0i] * (1 - wx) * wy + stack[li, y1i, x1i] * wx * wy)


def _hammersley(n: int):
    i = np.arange(n)
    u1 = (i + 0.5) / n
    bits = i.astype(np.uint32)
    bits = (bits << 16) | (bits >> 16)
    bits = ((bits & 0x55555555) << 1) | ((bits & 0xAAAAAAAA) >> 1)
    bits = ((bits & 0x33333333) << 2) | ((bits & 0xCCCCCCCC) >> 2)
    bits = ((bits & 0x0F0F0F0F) << 4) | ((bits & 0xF0F0F0F0) >> 4)
    bits = ((bits & 0x00FF00FF) << 8) | ((bits & 0xFF00FF00) >> 8)
    u2 = bits.astype(np.float64) * 2.3283064365386963e-10
    return u1.astype(np.float32), u2.astype(np.float32)


_FG_LUTS: dict = {}


def compute_fg_lut(res: int = 256, n_samples: int = 512, device="cuda",
                   row_chunk: int = 32) -> torch.Tensor:
    """Karis split-sum (scale, bias) for F0 as a [res, res, 2] LUT indexed
    [NoV, linear roughness]; Hammersley-sampled GGX, Schlick-GGX geometry
    with k = alpha/2. Computed once a process per (res, samples, device);
    each call returns a copy."""
    device = resolve_device(device)
    key = (res, n_samples, str(device))
    if key not in _FG_LUTS:
        _FG_LUTS[key] = _fg_lut(res, n_samples, device, row_chunk)
    return _FG_LUTS[key].clone()


def _fg_lut(res: int, n_samples: int, device, row_chunk: int) -> torch.Tensor:
    u1, u2 = (torch.as_tensor(a, device=device) for a in _hammersley(n_samples))
    phi = 2.0 * math.pi * u1                                     # [S]
    rough = (torch.arange(res, dtype=torch.float32, device=device) + 0.5) / res
    a = (rough * rough)[:, None]                                 # [R,1]
    cos_t = torch.sqrt((1.0 - u2) / (1.0 + (a * a - 1.0) * u2 + 1e-9))  # [R,S]
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t ** 2, 0.0, 1.0))
    hx, hy, hz = torch.cos(phi) * sin_t, torch.sin(phi) * sin_t, cos_t
    k = a / 2.0
    rows = []
    for s in range(0, res, row_chunk):
        nov = ((torch.arange(s, min(s + row_chunk, res), dtype=torch.float32, device=device)
                + 0.5) / res)[:, None, None]                     # [n,1,1]
        vx = torch.sqrt(1.0 - nov * nov)
        voh_raw = vx * hx + nov * hz                             # V.H, [n,R,S]
        lz = 2.0 * voh_raw * hz - nov
        NoL = torch.clamp(lz, 0.0, 1.0)
        NoH = torch.clamp(hz, 0.0, 1.0)
        VoH = torch.clamp(voh_raw, 0.0, 1.0)
        g1 = NoL / (NoL * (1 - k) + k + 1e-7)
        g2 = nov / (nov * (1 - k) + k + 1e-7)
        G_vis = g1 * g2 * VoH / (NoH * nov + 1e-7)
        Fc = (1.0 - VoH) ** 5
        valid = NoL > 0
        A = torch.where(valid, (1 - Fc) * G_vis, torch.zeros_like(G_vis)).mean(-1)
        B = torch.where(valid, Fc * G_vis, torch.zeros_like(G_vis)).mean(-1)
        rows.append(torch.stack([A, B], dim=-1))
    return torch.cat(rows)


def sample_fg_lut(lut: torch.Tensor, n_dot_v: torch.Tensor, roughness: torch.Tensor) -> torch.Tensor:
    """Bilinear LUT fetch; inputs [...,1] clamped to [0,1]; out [...,2]."""
    res = lut.shape[0]
    u = torch.clamp(n_dot_v[..., 0], 0.0, 1.0) * (res - 1)
    v = torch.clamp(roughness[..., 0], 0.0, 1.0) * (res - 1)
    u0 = torch.floor(u).long()
    v0 = torch.floor(v).long()
    u1 = torch.clamp(u0 + 1, 0, res - 1)
    v1 = torch.clamp(v0 + 1, 0, res - 1)
    wu = (u - u0)[..., None]
    wv = (v - v0)[..., None]
    return (lut[u0, v0] * (1 - wu) * (1 - wv) + lut[u1, v0] * wu * (1 - wv)
            + lut[u0, v1] * (1 - wu) * wv + lut[u1, v1] * wu * wv)
