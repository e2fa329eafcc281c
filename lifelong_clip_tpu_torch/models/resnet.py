"""The ModifiedResNet vision tower (CLIP's RN50 family) as functions of a
parameter tree.

Counterpart of ``lifelong_clip_tpu/models/resnet.py`` (reference
``models/clip/model.py:113-191``): a 3-convolution stem and a 2 x 2 average
pool, four stages of bottlenecks whose strides are anti-aliased (an average
pool before any stride-2 convolution, in the main path and the shortcut),
and an attention pool whose only query is the mean token (the reference
computes full self-attention and keeps row 0; one query gives the same
output). The tree keeps JAX's layout: HWIO kernels (``stem`` a list of 3,
``layers`` a list of 4 stages, each a list of blocks, ``downsample`` None
where a block has none), BatchNorm as (scale, bias, mean, var), linear
weights (in, out). The forward runs NCHW on ``conv2d`` (cuDNN on the card,
with TF32 off: JAX convolves at ``Precision.HIGHEST``; JAX runs these
convolutions outside any Pallas kernel too), BatchNorm folded to its
inference-mode affine in fp32, exact-window average pools as a mean in
fp32, and the attention pool in fp32. The kernels are cast to the input's
dtype a call; the tree's leaves stay fp32 (``clip.cast_towers`` leaves it
as it is). The tower takes no PEFT tree (the reference puts PEFT only into
transformer blocks).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ..config import CLIPConfig
from ..device import resolve_device


def _no_tf32():
    """cuDNN's flags as they are, with TF32 off."""
    cudnn = torch.backends.cudnn
    if not cudnn.allow_tf32:
        return contextlib.nullcontext()
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def _conv(x, w, stride: int = 1, padding: int = 0):
    """NCHW x by an HWIO kernel."""
    return F.conv2d(x, w.to(x.dtype).permute(3, 2, 0, 1), stride=stride,
                    padding=padding)


def _bn(x, p, eps: float = 1e-5):
    """Inference-mode BatchNorm as an affine transform in fp32."""
    inv = torch.rsqrt(p["var"].float() + eps) * p["scale"]
    y = (x.float() - p["mean"][:, None, None]) * inv[:, None, None] \
        + p["bias"][:, None, None]
    return y.to(x.dtype)


def _avgpool(x, k: int):
    """Exact-window average pool, kernel = stride = ``k``, summed in
    fp32."""
    if k == 1:
        return x
    b, c, h, w = x.shape
    y = x.float().reshape(b, c, h // k, k, w // k, k).mean((3, 5))
    return y.to(x.dtype)


def _bottleneck(x, p, stride: int):
    """Reference ``Bottleneck.forward`` (model.py:50-63)."""
    out = torch.relu(_bn(_conv(x, p["conv1"]), p["bn1"]))
    out = torch.relu(_bn(_conv(out, p["conv2"], padding=1), p["bn2"]))
    out = _avgpool(out, stride)
    out = _bn(_conv(out, p["conv3"]), p["bn3"])
    d = p.get("downsample")
    identity = x if d is None else _bn(_conv(_avgpool(x, stride), d["conv"]),
                                       d["bn"])
    return torch.relu(out + identity)


def _attnpool(x, p, n_heads: int):
    """``AttentionPool2d`` (model.py:66-111) with the mean token as the only
    query; fp32 from the projections on. Returns (B, embed_dim) fp32."""
    b, c, h, w = x.shape
    tokens = x.flatten(2).transpose(1, 2)                    # (B, HW, C)
    mean = tokens.float().mean(1, keepdim=True).to(tokens.dtype)
    tokens = torch.cat([mean, tokens], 1)                    # (B, HW+1, C)
    tokens = (tokens + p["pos_embed"].to(tokens.dtype)).float()
    dh = c // n_heads
    q = tokens[:, 0] @ p["q"]["w"] + p["q"]["b"]
    k = tokens @ p["k"]["w"] + p["k"]["b"]
    v = tokens @ p["v"]["w"] + p["v"]["b"]
    q = q.reshape(b, n_heads, 1, dh)
    k = k.reshape(b, -1, n_heads, dh).transpose(1, 2)
    v = v.reshape(b, -1, n_heads, dh).transpose(1, 2)
    attn = torch.softmax(q @ k.transpose(-1, -2) / dh ** 0.5, -1)
    pooled = (attn @ v).reshape(b, c)
    return pooled @ p["c"]["w"] + p["c"]["b"]


def rn_encode_image(params, images, cfg: CLIPConfig,
                    compute_dtype=torch.float32):
    """ModifiedResNet forward: (B, H, W, 3) -> (B, embed_dim) in
    ``compute_dtype``."""
    v = params["vision"]
    x = images.to(compute_dtype).permute(0, 3, 1, 2)
    with _no_tf32():
        for s, st in enumerate(v["stem"]):
            x = torch.relu(_bn(_conv(x, st["w"], stride=2 if s == 0 else 1,
                                     padding=1), st["bn"]))
        x = _avgpool(x, 2)
        for stage_i, stage in enumerate(v["layers"]):
            for block_i, blk in enumerate(stage):
                stride = 2 if stage_i > 0 and block_i == 0 else 1
                x = _bottleneck(x, blk, stride)
    return _attnpool(x, v["attnpool"], cfg.vision_heads).to(compute_dtype)


def init_rn_params(gen: torch.Generator, cfg: CLIPConfig, device=None):
    """A seeded RN vision tree of the reference's init scheme (attention
    pool projections std C^-0.5, bn3 scale zero, model.py:857-869), on
    ``device`` (``None``: the GPU). The draws differ from JAX's."""
    width = cfg.vision_width

    def conv_w(kh, kw, cin, cout):
        return torch.randn(kh, kw, cin, cout, generator=gen) / \
            (kh * kw * cin) ** 0.5

    def bn_p(c, zero_scale=False):
        return {"scale": torch.zeros(c) if zero_scale else torch.ones(c),
                "bias": torch.zeros(c), "mean": torch.zeros(c),
                "var": torch.ones(c)}

    stem = [{"w": conv_w(3, 3, 3, width // 2), "bn": bn_p(width // 2)},
            {"w": conv_w(3, 3, width // 2, width // 2),
             "bn": bn_p(width // 2)},
            {"w": conv_w(3, 3, width // 2, width), "bn": bn_p(width)}]
    stages = []
    inplanes = width
    for stage_i, depth in enumerate(cfg.vision_layers):
        planes = width * 2 ** stage_i
        stage = []
        for block_i in range(depth):
            stride = 2 if stage_i > 0 and block_i == 0 else 1
            blk = {"conv1": conv_w(1, 1, inplanes, planes),
                   "bn1": bn_p(planes),
                   "conv2": conv_w(3, 3, planes, planes), "bn2": bn_p(planes),
                   "conv3": conv_w(1, 1, planes, planes * 4),
                   "bn3": bn_p(planes * 4, zero_scale=True),
                   "downsample": None}
            if stride > 1 or inplanes != planes * 4:
                blk["downsample"] = {
                    "conv": conv_w(1, 1, inplanes, planes * 4),
                    "bn": bn_p(planes * 4)}
            stage.append(blk)
            inplanes = planes * 4
        stages.append(stage)

    c = width * 32
    std = c ** -0.5

    def lin(din, dout):
        return {"w": torch.randn(din, dout, generator=gen) * std,
                "b": torch.zeros(dout)}

    spacial = cfg.image_size // 32
    attnpool = {"pos_embed": torch.randn(spacial ** 2 + 1, c,
                                         generator=gen) * std,
                "q": lin(c, c), "k": lin(c, c), "v": lin(c, c),
                "c": lin(c, cfg.embed_dim)}
    tree = {"stem": stem, "layers": stages, "attnpool": attnpool}
    return tree_to(tree, resolve_device(device))


def tree_to(tree, device):
    """An RN tree (dicts, lists, None) with its tensors on ``device``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.contiguous().to(device)


def rn_state_dict_to_vision(sd):
    """The reference RN ``visual.*`` state dict (str -> fp32 tensor) as the
    vision tree: OIHW kernels to HWIO, linear weights to (in, out), the
    BatchNorm running statistics kept for the inference-mode affine (JAX
    ``resnet.py:195-240``)."""

    def conv(key):
        return sd[key].permute(2, 3, 1, 0)

    def bn(prefix):
        return {"scale": sd[f"{prefix}.weight"],
                "bias": sd[f"{prefix}.bias"],
                "mean": sd[f"{prefix}.running_mean"],
                "var": sd[f"{prefix}.running_var"]}

    stem = [{"w": conv(f"visual.conv{i}.weight"), "bn": bn(f"visual.bn{i}")}
            for i in (1, 2, 3)]
    stages = []
    for s in (1, 2, 3, 4):
        depth = len({k.split(".")[2] for k in sd
                     if k.startswith(f"visual.layer{s}.")})
        stage = []
        for b in range(depth):
            p = f"visual.layer{s}.{b}"
            blk = {"conv1": conv(f"{p}.conv1.weight"), "bn1": bn(f"{p}.bn1"),
                   "conv2": conv(f"{p}.conv2.weight"), "bn2": bn(f"{p}.bn2"),
                   "conv3": conv(f"{p}.conv3.weight"), "bn3": bn(f"{p}.bn3"),
                   "downsample": None}
            if f"{p}.downsample.0.weight" in sd:
                blk["downsample"] = {"conv": conv(f"{p}.downsample.0.weight"),
                                     "bn": bn(f"{p}.downsample.1")}
            stage.append(blk)
        stages.append(stage)

    def lin(prefix):
        return {"w": sd[f"{prefix}.weight"].T, "b": sd[f"{prefix}.bias"]}

    attnpool = {"pos_embed": sd["visual.attnpool.positional_embedding"],
                "q": lin("visual.attnpool.q_proj"),
                "k": lin("visual.attnpool.k_proj"),
                "v": lin("visual.attnpool.v_proj"),
                "c": lin("visual.attnpool.c_proj")}
    return {"stem": stem, "layers": stages, "attnpool": attnpool}
